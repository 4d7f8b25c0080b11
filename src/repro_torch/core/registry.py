"""The deconv executor registry: the one place an implementation is chosen.

The port of ``repro.core.registry``.  Every transposed-convolution
implementation registers here once, with capability metadata; the
generative models and the trainer resolve implementations through
:func:`get_impl` / :func:`resolve`, so a registered name shows up in
every entry point's choices, in every error message and in
:func:`selfcheck`.

Capability schema (the reference's, field for field):

``trainable``       gradients flow through the op under autograd.
``engine``          the impl runs through :class:`repro_torch.engine.SDEngine`
                    (presplit-once bound plans) rather than a plain
                    ``fn(x, w, stride, padding)`` call.
``needs_presplit``  the deployment contract needs the offline filter
                    split (engine impls; also ``fused``, which splits
                    inline only as a convenience).
``exact``           equal to ``native`` in f32 (the wrong baselines
                    ``shi`` / ``chang`` reproduce papers [30] [31] and are
                    not).
``tolerance``       pinned relative error bound against ``native`` for a
                    non-exact but correct impl (Winograd); 0.0 claims
                    none.
``dtypes``          dtypes the impl runs end to end.
``backends``        what the impl's fast path targets; ``"any"`` means
                    plain torch ops on any device.
``ranks``           spatial ranks the impl executes (1 audio, 2 images,
                    3 volumes).
``rank_backends``   per-rank refinement of ``backends``.
``api``             ``"fn"``: a hand-written plain executor;
                    ``"functional"``: the plan-based :mod:`repro_torch.sd`
                    core through :func:`~repro_torch.sd.functional_deconv`.

Only ``backends`` and ``rank_backends`` name other targets than the
reference's, the port's own: ``"tpu"`` (the reference's Pallas kernels)
is ``"cuda"`` (the port's CUDA kernels, K1 / K4 and K2 + K3), and rank
3's ``"xla-interleave"`` is ``"torch-interleave"``, since the port's 3-D
lowering runs one K2 launch per depth tap and sums the taps and
interleaves them in torch ops (:func:`~repro_torch.kernels.ops.
sd_deconv_presplit_fused_3d`).  :data:`BACKEND_NAMES` holds that map.

All impls share one call signature::

    fn(x, w, stride, padding=0) -> y        # NHWC / (*K, Cin, Cout)

Loaders import lazily, so importing the registry builds no kernel.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# the reference's backend names -> the port's
BACKEND_NAMES = {"tpu": "cuda", "xla-interleave": "torch-interleave"}


@dataclass(frozen=True)
class ImplInfo:
    """One registered deconv implementation and its capabilities."""
    name: str
    description: str
    loader: Callable[[], Callable]
    trainable: bool = True
    engine: bool = False
    needs_presplit: bool = False
    exact: bool = True
    tolerance: float = 0.0          # pinned rel-err vs native (non-exact)
    dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    backends: Tuple[str, ...] = ("any",)
    api: str = "fn"                 # "fn" | "functional" (repro_torch.sd)
    ranks: Tuple[int, ...] = (2,)   # supported spatial ranks
    # ((rank, (backend, ...)), ...) overrides; see backends_by_rank()
    rank_backends: Tuple[Tuple[int, Tuple[str, ...]], ...] = ()

    @property
    def fn(self) -> Callable:
        """The executable ``fn(x, w, stride, padding)`` (lazy-loaded)."""
        return self.loader()

    def backends_by_rank(self) -> Dict[int, Tuple[str, ...]]:
        """{rank: fast-path backends}."""
        table = {r: tuple(self.backends) for r in self.ranks}
        for rank, bks in self.rank_backends:
            table[int(rank)] = tuple(bks)
        return table

    def capabilities(self) -> Dict[str, object]:
        """Metadata dict (JSON-friendly; used by errors, docs and
        :func:`selfcheck`)."""
        return {
            "trainable": self.trainable,
            "engine": self.engine,
            "needs_presplit": self.needs_presplit,
            "exact": self.exact,
            "tolerance": self.tolerance,
            "dtypes": list(self.dtypes),
            "backends": list(self.backends),
            "api": self.api,
            "ranks": list(self.ranks),
            "backends_by_rank": {r: list(b) for r, b in
                                 sorted(self.backends_by_rank().items())},
        }


_REGISTRY: Dict[str, ImplInfo] = {}
_DTYPE_ABBREV = {"float32": "f32", "bfloat16": "bf16", "int8": "i8"}


def register(name: str, description: str, loader: Callable[[], Callable],
             **caps) -> ImplInfo:
    """Register (or re-register, e.g. in tests) an implementation."""
    info = ImplInfo(name=name, description=description, loader=loader,
                    **caps)
    _REGISTRY[name] = info
    return info


def names() -> List[str]:
    return sorted(_REGISTRY)


def _describe_all() -> str:
    lines = []
    for n in names():
        i = _REGISTRY[n]
        tags = ([f"api={i.api}",
                 "ranks=" + "".join(str(r) for r in i.ranks),
                 "dtypes=" + "/".join(_DTYPE_ABBREV.get(d, d)
                                      for d in i.dtypes)]
                + [t for t, on in (
                    ("trainable", i.trainable), ("engine", i.engine),
                    ("presplit", i.needs_presplit), ("exact", i.exact))
                   if on])
        lines.append(f"  {n:<10} [{', '.join(tags)}] {i.description}")
    return "\n".join(lines)


def get_impl(name: str) -> ImplInfo:
    """Lookup with a self-documenting error on an unknown name: the
    nearest registered name and the capability catalog."""
    try:
        return _REGISTRY[name]
    except KeyError:
        near = difflib.get_close_matches(name, names(), n=1, cutoff=0.5)
        hint = f" — did you mean {near[0]!r}?" if near else ""
        raise ValueError(
            f"unknown deconv_impl {name!r}{hint}; "
            f"registered implementations:\n{_describe_all()}") from None


def resolve(name: str) -> Callable:
    """The executable for ``name`` (the engine impl resolves to its
    inline-split functional form; serving uses ``SDEngine``)."""
    return get_impl(name).fn


def trainable_names() -> List[str]:
    return [n for n in names() if _REGISTRY[n].trainable]


def exact_names() -> List[str]:
    return [n for n in names() if _REGISTRY[n].exact]


def capabilities() -> Dict[str, Dict[str, object]]:
    """{name: capability dict} for every registered impl."""
    return {n: _REGISTRY[n].capabilities() for n in names()}


# ---------------------------------------------------------------------------
# Registrations.  Loaders import lazily: nothing here builds a kernel.
# ---------------------------------------------------------------------------

def _load_native():
    from repro_torch.core.deconv import native_deconv
    return native_deconv


def _load_nzp():
    from repro_torch.core.deconv import nzp_deconv
    return nzp_deconv


def _load_sd():
    from repro_torch.core.deconv import sd_deconv
    return sd_deconv


def _load_sd_paper():
    from repro_torch.core.deconv import sd_deconv_paper
    return sd_deconv_paper


def _load_fused():
    from repro_torch.kernels.ops import sd_deconv_kernel
    return sd_deconv_kernel


def _load_functional():
    from repro_torch.sd import functional_deconv
    return functional_deconv


def _load_winograd():
    import functools
    from repro_torch.sd import functional_deconv
    return functools.partial(functional_deconv, backend="winograd")


def _load_shi():
    from repro_torch.core.wrong_baselines import shi_deconv
    return shi_deconv


def _load_chang():
    from repro_torch.core.wrong_baselines import chang_deconv
    return chang_deconv


register("native", "F.conv_transpose{1,2,3}d (framework-native deconv "
         "reference)", _load_native, ranks=(1, 2, 3))

register("nzp", "Naive Zero Padding baseline: materialised dilation + "
         "stride-1 conv (~s^d wasted MACs, paper Table 2)", _load_nzp,
         ranks=(1, 2, 3))

register("sd", "Split Deconvolution, grouped formulation: ONE stride-1 "
         "conv over all prod(s) sub-filters + pixel-shuffle (torch ops)",
         _load_sd, needs_presplit=False, ranks=(1, 2, 3))

register("sd_paper", "Paper-faithful SD (Algorithm 2): s^2 sequential "
         "small convs + stride-s interleave write", _load_sd_paper)

register("sd_fn", "plan-based SD (repro_torch.sd.conv_transpose): "
         "autograd backward as stride-1 convolutions over the split "
         "layout (K1 forward, K2 + K3 backward on a card)",
         _load_functional, trainable=True, api="functional",
         ranks=(1, 2, 3))

register("sd_kernel", "SD inference engine: presplit-once, BN-folded "
         "filters through the fused CUDA kernel K1 (card) or the grouped "
         "torch path (CPU); params that require grad route through the "
         "differentiable repro_torch.sd core.  1-D lowers as an H=1 2-D "
         "launch of the same kernel; 3-D folds depth into batch for one "
         "K2 launch per depth tap, then a torch cross-slice interleave",
         _load_functional, trainable=True, engine=True, needs_presplit=True,
         dtypes=("float32", "bfloat16", "int8"),
         backends=("cuda", "any"), api="functional", ranks=(1, 2, 3),
         rank_backends=((3, ("cuda", "any", "torch-interleave")),))

register("fused", "fused CUDA SD kernel K1 with inline filter split "
         "(kernel benchmarking; deployments use sd_kernel + SDEngine)",
         _load_fused, trainable=False, needs_presplit=True,
         backends=("cuda",))

register("winograd", "Winograd F(2,r) fast algorithm (K4) on the "
         "stride-1 split subfilters: filter transform at bind, inverse "
         "transform folded into the interleave epilogue — 2.25x fewer "
         "MACs per tile at 3 taps.  Ranks 1-2, taps <= 5, float only; "
         "same-conv numerics within a pinned tolerance (transformed-"
         "domain f32 rounding)", _load_winograd,
         trainable=True, needs_presplit=True, exact=False,
         tolerance=1e-4, dtypes=("float32", "bfloat16"),
         backends=("cuda",), api="functional", ranks=(1, 2))

register("shi", "wrong baseline [30]: bottom/right zero expansion "
         "(quality degrades, paper Table 4)", _load_shi, exact=False)

register("chang", "wrong baseline [31]: no per-phase filter rotation "
         "(quality degrades, paper Table 4)", _load_chang, exact=False)


# ---------------------------------------------------------------------------
# Consistency check
# ---------------------------------------------------------------------------

def selfcheck(device=None, verbose: bool = False,
              report: Optional[Callable[[str, str], None]] = None) -> None:
    """Registry-capabilities consistency check on ``device`` (``None``:
    the card, raising without one), after the reference's
    ``registry.selfcheck``:

    * every loader resolves to a callable; every impl serves rank 2;
      ``rank_backends`` refines only declared ranks;
    * engine impls presplit, and are trainable only through the
      functional :mod:`repro_torch.sd` core;
    * every ``exact`` impl matches ``native`` within 1e-4 (relative and
      absolute) at **every rank its ``ranks`` claims**, on a small
      stride-2 pad-1 deconv;
    * an impl with a pinned ``tolerance`` (Winograd) matches ``native``
      within ``tolerance * max|ref|`` at every declared rank;
    * every ``trainable`` impl gives a finite ``dw`` at every declared
      rank;
    * every declared dtype runs (rank 2): ``bfloat16`` on bf16 operands
      within ``0.1 * max|ref|`` of the f32 reference (an impl that is
      not exact against its own f32 output); ``int8`` binds an int8
      :func:`repro_torch.sd.plan` for ``device`` and runs it through
      ``execute`` within ``0.05 * max|ref|``.

    ``report(name, check)``, if given, is called after each check ran
    (``check``: ``"rank 1"``, ``"rank 2 grad"``, ``"bfloat16"``,
    ``"int8"``, ...), so a caller can attribute kernel launches to the
    impl and the check that made them."""
    import numpy as np
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    note = report or (lambda name, check: None)
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape), dtype=torch.float32,
                               device=dev)

    data = {  # per rank: (x, w) for a small stride-2 pad-1 deconv
        1: (t(1, 6, 3), t(4, 3, 2)),
        2: (t(1, 5, 6, 3), t(4, 4, 3, 2)),
        3: (t(1, 3, 4, 4, 2), t(4, 4, 4, 2, 2)),
    }
    native = get_impl("native").fn
    with torch.no_grad():
        refs = {r: native(xr, wr, 2, 1) for r, (xr, wr) in data.items()}

    def close(out, ref, what, rtol=1e-4, atol=1e-4):
        np.testing.assert_allclose(
            out.detach().float().cpu().numpy(), ref.float().cpu().numpy(),
            rtol=rtol, atol=atol, err_msg=what)

    for name in names():
        info = get_impl(name)
        fn = info.fn
        assert callable(fn), f"{name}: loader did not return a callable"
        assert info.api in ("fn", "functional"), f"{name}: bad api"
        assert 2 in info.ranks, f"{name}: every impl serves rank 2"
        table = info.backends_by_rank()
        assert set(table) == set(info.ranks), \
            f"{name}: rank_backends refines undeclared ranks " \
            f"({sorted(table)} vs {info.ranks})"
        if info.engine:
            assert info.needs_presplit, f"{name}: engine impls presplit"
            assert not info.trainable or info.api == "functional", \
                f"{name}: an engine impl is trainable only through the " \
                "functional repro_torch.sd path"
        for rank in info.ranks:
            xr, wr = data[rank]
            with torch.no_grad():
                out = fn(xr, wr, 2, 1)
            assert out.shape == refs[rank].shape, \
                (name, rank, out.shape, refs[rank].shape)
            if info.exact:
                close(out, refs[rank], f"{name} vs native (rank {rank})")
            elif info.tolerance:
                bound = info.tolerance * refs[rank].abs().max().item()
                close(out, refs[rank], f"{name} vs native at pinned "
                      f"tolerance {info.tolerance} (rank {rank})",
                      rtol=0, atol=bound)
            note(name, f"rank {rank}")
            if info.trainable:
                wt = wr.clone().requires_grad_()
                (g,) = torch.autograd.grad((fn(xr, wt, 2, 1) ** 2).sum(),
                                           (wt,))
                assert bool(torch.isfinite(g).all()), \
                    f"{name}: bad grad (rank {rank})"
                note(name, f"rank {rank} grad")
        # Every declared dtype (rank 2; dtype support is orthogonal to
        # rank).  "float32" is the main check above.  A non-exact impl
        # (the wrong baselines) compares against its OWN f32 output.
        x2, w2 = data[2]
        with torch.no_grad():
            ref2 = refs[2] if info.exact else fn(x2, w2, 2, 1)
            tol2 = ref2.abs().max().item()
            for dt in info.dtypes:
                if dt == "float32":
                    continue
                if dt == "bfloat16":
                    out = fn(x2.bfloat16(), w2.bfloat16(), 2, 1)
                    assert out.shape == refs[2].shape, (name, dt, out.shape)
                    close(out, ref2, f"{name}: bfloat16 claim fails at "
                          "runtime", rtol=0, atol=0.1 * tol2)
                elif dt == "int8":
                    assert info.api == "functional", \
                        f"{name}: int8 runs through the repro_torch.sd " \
                        "plan path — only functional-api impls can claim it"
                    from repro_torch import sd
                    p8 = sd.plan(w2.shape, 2, 1, dtype="int8",
                                 device=dev).bind(w2)
                    out = sd.execute(p8, x2)
                    assert out.shape == refs[2].shape, (name, dt, out.shape)
                    close(out, ref2, f"{name}: int8 claim fails at runtime",
                          rtol=0, atol=0.05 * tol2)
                else:
                    raise AssertionError(
                        f"{name}: unknown dtype capability {dt!r}")
                note(name, dt)
        if verbose:
            print(f"  {name:<10} OK  {info.capabilities()}")
    if verbose:
        print(f"registry selfcheck on {dev}: {len(names())} impls "
              f"consistent")


if __name__ == "__main__":
    import sys
    selfcheck(device=sys.argv[1] if len(sys.argv) > 1 else None,
              verbose=True)
