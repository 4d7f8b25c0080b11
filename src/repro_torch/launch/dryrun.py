"""Dry-run: trace one rank's step of every (arch x shape x mesh) cell on
the production meshes, with no device.

The port of the reference's ``launch/dryrun.py``.  The reference lowers
and compiles each cell's jitted step for 256 or 512 placeholder devices
and reads XLA's memory and cost analyses and the partitioned HLO's
collectives.  The port runs rank 0's step itself, eagerly, on the meta
device (shapes and dtypes, no memory, no kernel): its param, optimizer
and cache blocks are the ``local_shape`` of ``abstract_params`` /
``abstract_opt_state`` / the cell's cache under the specs of
:mod:`repro_torch.distributed.sharding`, its mesh is
:func:`~repro_torch.launch.mesh.make_production_mesh` (16 x 16, or 2 x 16
x 16 with a ``'pod'`` axis) made ``abstract`` (each collective returns a
tensor of the result's shape and tallies itself, with no
communication), so the model takes the path it takes on live ranks.  A
serving prefill past 2,048 tokens reaches K5's operator, whose fake
returns the output's shape (``kernels/flash_attn.py``).  The meta device
stands in for fake CUDA tensors: in a CPU-only build of torch, autograd
and Python indexing on a fake CUDA tensor need a CUDA device guard and
abort the process, and the LM's one device branch is K5's wrapper, which
sends a meta tensor to the same operator a CUDA one reaches.

:class:`StepTrace` (a dispatch mode, used alike on live ranks) records
per cell: the tensor-core FLOPs (``torch.utils.flop_counter``'s formulas,
K5's included), the bytes accessed (module doc of
:mod:`repro_torch.launch.hlo_analysis`), the K5 calls, and the peak of
live storage the step allocates (every storage an op creates, from its
creation until torch frees it).  The record keeps the reference's keys:
``memory`` holds the rank's argument bytes (params, optimizer state,
cache, the batch the step takes: the whole batch, of which each rank
keeps its rows), the step's outputs, what it updates in place
(``alias``: the cache; in training the params and the optimizer
state), ``temp`` (the peak of live allocations less the step's new
outputs) and ``peak_hbm_bytes = argument + output + temp - alias``.

The eager loop counts every layer, so the full-depth trace's costs are
the whole model's; ``run_cell``'s ``corrected`` path still traces the
depth-1 and depth-2 models at microbatch 1 and extrapolates ``a + R·b``
as the reference's does, and ``fast`` skips the full-depth trace (no
``compile_s``, no ``memory``), as the reference's.  An op on meta
tensors costs tens to hundreds of microseconds of host time, and the
Mamba and sLSTM loops dispatch ops per time step: the full-depth Jamba
and xLSTM cells take long.

  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out runs/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, LONG_CONTEXT_OK, SHAPES, get
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import flash_attn  # noqa: F401 (K5's operator)
from repro_torch.launch.hlo_analysis import (CollectiveStats, axis_link,
                                             collective_stats,
                                             link_bandwidths, roofline_terms)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (abstract_opt_state, abstract_params,
                                      effective_seq, input_specs,
                                      make_decode_step, make_prefill_step,
                                      make_train_step)

K5_OP = torch.ops.repro_torch.flash_attention.default
_EMPTY = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace(TorchDispatchMode):
    """Counts what a step dispatches, on live or meta tensors alike:
    ``flops`` (tensor-core work by ``flop_registry``'s formulas, K5's
    too), ``bytes`` (every op that is not a view: its tensor operands
    plus each output that is not an operand; an allocation without a
    fill moves nothing), ``k5`` (K5 calls, ``k5_shapes`` their q and k
    shapes), ``ops`` (dispatched ops), and ``peak`` (the most storage
    the ops allocated that was alive at once; ``live`` at the end).
    Storage that existed before the trace (the step's arguments) is not
    counted."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.k5 = self.ops = 0
        self.live = self.peak = 0
        self.k5_shapes = []
        self._owned: Dict[int, int] = {}
        self._before: set = set()

    def exclude(self, *trees) -> None:
        """Mark the storages of the tensors in ``trees`` (the step's
        arguments) as not the step's own."""
        for leaf in tree_flatten(trees)[0]:
            if isinstance(leaf, torch.Tensor):
                self._before.add(leaf.untyped_storage()._cdata)

    def _free(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def _own(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._owned or key in self._before:
            return
        n = st.nbytes()
        self._owned[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func is K5_OP:
            self.k5 += 1
            self.k5_shapes.append((tuple(args[0].shape),
                                   tuple(args[1].shape)))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view and func not in _EMPTY:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            ids = {id(t) for t in ins}
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs if id(t) not in ids)
        for t in outs:
            self._own(t)
        return out


def _tree_bytes(*trees) -> int:
    seen, n = set(), 0
    for leaf in tree_flatten(trees)[0]:
        if isinstance(leaf, torch.Tensor):
            key = leaf.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                n += leaf.untyped_storage().nbytes()
    return n


def _tensors(tree):
    """Nested dicts, lists, tuples and the optimizer's state as pytree
    leaves (``OptState`` is a dataclass)."""
    if dc.is_dataclass(tree) and not isinstance(tree, type):
        return [_tensors(getattr(tree, f.name)) for f in dc.fields(tree)]
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return tree


def cell_is_skipped(arch: str, shape: str) -> Optional[str]:
    get(arch)
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return ("pure full-attention arch: long_500k needs sub-quadratic "
                "mixing (see DESIGN.md §Arch-applicability)")
    return None


def rank_inputs(cfg, cell, mesh: SH.Mesh, mc: SH.MeshContext, lm=None,
                aparams=None):
    """The arguments of rank ``mesh.rank``'s step of ``cell`` on the
    meta device: ``(lm, args)`` with ``args`` (params, opt state, batch)
    to train, else (params, batch, cache); the cache of a decode step at
    its last position."""
    if lm is None:
        lm, aparams = abstract_params(cfg)
    params = SH.place(aparams, SH.param_specs(aparams, mc), mesh)
    return lm, _step_args(lm, cfg, cell, mc, params, input_specs(cfg, cell))


def live_inputs(cfg, cell, mesh: SH.Mesh, mc: SH.MeshContext, device,
                seed: int = 0):
    """:func:`rank_inputs`' arguments as tensors on ``device``: random
    params drawn from ``seed`` (each leaf cut to the rank's block as it
    is drawn), the optimizer's zero state, random tokens and N(0, 1)
    embeddings of the cell's batch, the zero cache."""
    from repro_torch.models.lm import build_lm
    lm = build_lm(cfg, device=device)
    gen = torch.Generator(device=lm.device).manual_seed(seed)

    def keep(path, t):
        return SH.local_block(t, SH.param_spec(path, t.ndim, mc,
                                               fsdp=mc.fsdp), mesh).clone()
    params = lm.init(gen, keep=keep)
    batch = {}
    for k, m in input_specs(cfg, cell).items():
        if m.dtype == torch.int32:
            batch[k] = torch.randint(0, cfg.vocab_size, m.shape,
                                     generator=gen, device=lm.device,
                                     dtype=torch.int32)
        else:
            batch[k] = torch.randn(m.shape, generator=gen, device=lm.device,
                                   dtype=m.dtype)
    return lm, _step_args(lm, cfg, cell, mc, params, batch)


def _step_args(lm, cfg, cell, mc, params, batch):
    if cell.step == "train":
        if not mc.fsdp:
            raise NotImplementedError(
                f"{cfg.name}: the port's AdamW updates the optimizer state "
                "in the params' blocks; ZeRO-1 without FSDP params is not "
                "ported")
        return (params, abstract_opt_state(params, cfg.opt_state_dtype),
                batch)
    seq = effective_seq(cfg, cell)
    with SH.mesh_context(mc):
        cache = lm.init_cache(cell.global_batch, seq)
    if cell.step == "decode":
        cache["pos"] = seq - 1
    return (params, batch, cache)


def cell_context(cfg, cell, mesh: SH.Mesh) -> SH.MeshContext:
    """The mesh context of ``cell``'s step (``fsdp_train`` or
    ``fsdp_serve``)."""
    fsdp = cfg.fsdp_train if cell.step == "train" else cfg.fsdp_serve
    return SH.MeshContext(mesh, strategy=cfg.mesh_strategy, fsdp=fsdp)


def run_step(lm, cfg, cell, mc: SH.MeshContext, args):
    """Run ``cell``'s step once on ``args`` under a :class:`StepTrace`;
    returns ``(outputs, trace, memory)``, the memory record's keys
    (module doc).  Live ranks and the dry-run call it alike."""
    with SH.mesh_context(mc):
        if cell.step == "train":
            step = make_train_step(lm, microbatch=cfg.microbatch)
        elif cell.step == "prefill":
            step = make_prefill_step(lm)
        else:
            step = make_decode_step(lm)
    tr = StepTrace()
    tr.exclude(_tensors(args))
    arg_bytes = _tree_bytes(_tensors(args))
    with tr:
        out = step(*args)
    alias = (args[:2] if cell.step == "train" else args[2:])
    out_bytes = _tree_bytes(_tensors(out))
    alias_bytes = _tree_bytes(_tensors(alias))
    new_out = out_bytes - alias_bytes
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": max(tr.peak - new_out, 0),
              "alias_bytes": alias_bytes}
    memory["peak_hbm_bytes"] = (arg_bytes + out_bytes + memory["temp_bytes"]
                                - alias_bytes)
    return out, tr, memory


def trace_step(cfg, cell, mesh: SH.Mesh, lm=None, aparams=None
               ) -> Dict[str, Any]:
    """Rank ``mesh.rank``'s step of ``cell`` on ``mesh`` (made abstract
    here), traced on the meta device: its :class:`StepTrace`, the mesh
    whose ``counts`` / ``traffic`` hold this step's collectives, the
    memory record and the seconds it took."""
    mesh = dc.replace(mesh, abstract=True, counts={}, traffic={})
    mc = cell_context(cfg, cell, mesh)
    t0 = time.time()
    lm, args = rank_inputs(cfg, cell, mesh, mc, lm, aparams)
    _, tr, memory = run_step(lm, cfg, cell, mc, args)
    return {"trace": tr, "mesh": mesh, "memory": memory,
            "seconds": time.time() - t0}


def _coll(mesh: SH.Mesh) -> CollectiveStats:
    return collective_stats(mesh.traffic, mesh.counts)


def run_cell(arch: str, shape: str, multi_pod: bool,
             save_hlo: Optional[str] = None,
             overrides: Optional[Dict[str, Any]] = None,
             corrected: bool = True,
             fast: bool = False) -> Dict[str, Any]:
    """Trace one cell; returns its record (the reference's keys).

    ``corrected=True`` also traces the depth-1 and depth-2 models at
    microbatch 1 and extrapolates the whole model's FLOPs, bytes and
    collectives as ``a + R·b`` (the reference's correction; the eager
    full-depth trace already counts every layer, so at microbatch 1 the
    two agree).  ``fast`` skips the full-depth trace.  ``save_hlo``: a
    path for the full-depth trace's collectives and op counts (the port
    has no HLO)."""
    cfg = get(arch)
    if overrides:
        cfg = dc.replace(cfg, **overrides)
    cell = SHAPES[shape]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "step": cell.step, "seq": effective_seq(cfg, cell),
        "global_batch": cell.global_batch,
    }
    skip = cell_is_skipped(arch, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    lm, aparams = abstract_params(cfg)
    coll_once = None
    if not fast:
        full = trace_step(cfg, cell, mesh, lm, aparams)
        rec["compile_s"] = full["seconds"]
        rec["memory"] = full["memory"]
        tr = full["trace"]
        f_once, b_once = float(tr.flops), float(tr.bytes)
        rec["cost_body_once"] = {"flops": f_once, "bytes_accessed": b_once}
        coll_once = _coll(full["mesh"])
        k5_once = tr.k5
        if save_hlo:
            with open(save_hlo, "w") as f:
                f.write("\n".join(coll_once.lines) + "\n")
                f.write(f"ops {tr.ops} flops {tr.flops} bytes {tr.bytes} "
                        f"k5 {tr.k5} {tr.k5_shapes[:4]}\n")

    R = cfg.n_layers // len(cfg.pattern)
    if fast and R <= 1:
        raise ValueError("fast mode needs R > 1")
    if corrected and R > 1:
        plen = len(cfg.pattern)
        ov1 = {"n_layers": plen, "loop_unroll": True, "microbatch": 1}
        ov2 = {"n_layers": 2 * plen, "loop_unroll": True, "microbatch": 1}
        if cfg.enc_layers:
            ov1["enc_layers"] = 1
            ov2["enc_layers"] = 2
        p1 = trace_step(dc.replace(cfg, **ov1), cell, mesh)
        p2 = trace_step(dc.replace(cfg, **ov2), cell, mesh)
        c1, c2 = _coll(p1["mesh"]), _coll(p2["mesh"])
        t1, t2 = p1["trace"], p2["trace"]
        flops = float(t1.flops + (R - 1) * (t2.flops - t1.flops))
        byts = float(t1.bytes + (R - 1) * (t2.bytes - t1.bytes))
        k5 = t1.k5 + (R - 1) * (t2.k5 - t1.k5)
        keys = set(c1.op_bytes) | set(c2.op_bytes)
        coll = CollectiveStats(
            {k: int(c1.op_counts.get(k, 0) + (R - 1)
                    * (c2.op_counts.get(k, 0) - c1.op_counts.get(k, 0)))
             for k in keys},
            {k: c1.op_bytes.get(k, 0.0) + (R - 1)
             * (c2.op_bytes.get(k, 0.0) - c1.op_bytes.get(k, 0.0))
             for k in keys},
            0.0, [])
        coll.total_bytes = max(c1.total_bytes + (R - 1)
                               * (c2.total_bytes - c1.total_bytes), 0.0)
    else:
        flops, byts, coll, k5 = f_once, b_once, coll_once, k5_once

    rec["cost"] = {"flops": flops, "bytes_accessed": byts,
                   "k5_launches": int(k5)}
    rec["collectives"] = {"counts": coll.op_counts,
                          "bytes": {k: float(v)
                                    for k, v in coll.op_bytes.items()},
                          "total_bytes": float(coll.total_bytes),
                          "links": {a: axis_link(mesh, a)
                                    for a in mesh.axis_names}}

    n_chips = mesh.size
    tot, act = _param_counts_abstract(lm, aparams, cfg)
    useful = model_flops(cfg, cell, act)
    rec["model_flops_global"] = useful
    rec["params_total"] = tot
    rec["params_active"] = act
    rl = roofline_terms(
        {"flops": flops, "bytes accessed": byts}, coll,
        link_bw=link_bandwidths(mesh),
        model_flops_per_device=useful / n_chips)
    rec["roofline"] = rl.table_row()
    rec["status"] = "ok"
    return rec


def model_flops(cfg, cell, active: int) -> float:
    """The useful work of a cell's step over the whole mesh: ``6 N D``
    to train, ``2 N D`` to serve, N the active params and D the tokens
    (one a row to decode)."""
    seq = effective_seq(cfg, cell)
    toks = cell.global_batch * (seq if cell.step != "decode" else 1)
    mult = 6.0 if cell.step == "train" else 2.0
    return mult * active * toks


def _param_counts_abstract(lm, aparams, cfg):
    """(total, active) parameters of the abstract tree: each MoE slot's
    experts counted at ``top_k / n_experts`` (the reference's floor)."""
    return lm.param_counts(aparams)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's collectives and op counts "
                    "beside its record (the port has no HLO)")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have results")
    ap.add_argument("--fast", action="store_true",
                    help="skip the full-depth trace: the depth-1 / depth-2 "
                    "traces alone (no compile_s, no memory)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]

    n_ok = n_skip = n_fail = 0
    # single-pod first (they feed the roofline table), multi-pod after
    cells = [(a, s, mp) for mp in sorted(pods) for s in shapes
             for a in archs]
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                rec = json.load(f)
            print(f"[cached] {tag}: {rec['status']}")
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skipped"
            n_fail += rec["status"] == "failed"
            continue
        t0 = time.time()
        try:
            hlo_path = (os.path.join(args.out, tag + ".trace.txt")
                        if args.save_hlo else None)
            # multi-pod cells are the trace-proof: skip the depth-1/2
            # correction probes (the roofline is single-pod's)
            rec = run_cell(arch, shape, mp, save_hlo=hlo_path,
                           corrected=args.fast or not mp, fast=args.fast)
        except Exception as e:
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "failed",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        secs = time.time() - t0
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok":
            n_ok += 1
            r = rec["roofline"]
            full = ("" if args.fast else
                    f"trace={rec['compile_s']:.1f}s hbm="
                    f"{rec['memory']['peak_hbm_bytes'] / 2**30:.2f}GiB ")
            print(f"[ok] {tag}: {full}cell={secs:.1f}s "
                  f"compute={r['compute_s'] * 1e3:.2f}ms "
                  f"memory={r['memory_s'] * 1e3:.2f}ms "
                  f"coll={r['collective_s'] * 1e3:.2f}ms "
                  f"dom={r['dominant']}", flush=True)
        elif rec["status"] == "skipped":
            n_skip += 1
            print(f"[skip] {tag}: {rec['reason'][:70]}", flush=True)
        else:
            n_fail += 1
            print(f"[FAIL] {tag}: cell={secs:.1f}s {rec['error'][:160]}",
                  flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
