"""Carry weights across from the JAX package.

The port keeps the reference's parameter layout (fc ``(in, out)``,
filters ``(*K, Cin, Cout)``, per-output-channel ``b`` and ``scale``; the
LM's tree with ``slots[j]`` stacked over the repeats), so converting is a
checked copy: every array is validated against the expected shape and
copied to the device unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.accounting import LayerSpec, NetworkSpec
from repro_torch.device import resolve_device


def _expected(layer: LayerSpec) -> Dict[str, tuple]:
    if layer.kind == "fc":
        return {"w": (layer.cin, layer.cout), "b": (layer.cout,)}
    return {"w": (*(layer.k,) * layer.rank, layer.cin, layer.cout),
            "b": (layer.cout,), "scale": (layer.cout,)}


def params_from_numpy(np_params: Mapping[str, Mapping[str, Any]],
                      device, spec: Optional[NetworkSpec] = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {leaf: array}}`` (numpy or anything ``np.asarray``
    takes, e.g. the JAX package's ``init`` output) -> the same dict of
    tensors on ``device``.  Checks that ``b``/``scale`` match the last
    axis of ``w``, and, given ``spec``, that every layer is present with
    exactly its expected leaves and shapes."""
    dev = resolve_device(device)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    if spec is not None:
        want = {l.name: _expected(l) for l in spec.layers}
        if set(np_params) != set(want):
            raise ValueError(f"layers {sorted(np_params)} do not match "
                             f"spec {spec.name}: {sorted(want)}")
    for name, leaves in np_params.items():
        arrs = {k: np.asarray(v) for k, v in leaves.items()}
        if "w" not in arrs or arrs["w"].ndim < 2:
            raise ValueError(f"layer {name!r} has no weight matrix 'w'")
        for k in ("b", "scale"):
            if k in arrs and arrs[k].shape != (arrs["w"].shape[-1],):
                raise ValueError(f"layer {name!r} {k} shape {arrs[k].shape}"
                                 f" != (w.shape[-1],) of {arrs['w'].shape}")
        if spec is not None:
            shapes = {k: a.shape for k, a in arrs.items()}
            if shapes != want[name]:
                raise ValueError(f"layer {name!r} shapes {shapes} != "
                                 f"expected {want[name]}")
        for k, a in arrs.items():
            if a.dtype.kind != "f":
                raise TypeError(f"layer {name!r} {k} has dtype {a.dtype}; "
                                "expected floating point")
        out[name] = {k: torch.from_numpy(np.array(a, copy=True)).to(dev)
                     for k, a in arrs.items()}
    return out


def _mixer_shapes(cfg: ArchConfig, kind: str, r: int) -> Dict[str, tuple]:
    """Slot kind ``kind``'s mixer leaves stacked over ``r`` repeats (the
    reference's ``init_attention`` / ``init_mamba`` / ``init_mlstm`` /
    ``init_slstm``)."""
    d = cfg.d_model
    if kind == "a":
        hq, hk = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
        attn = {"wq": (r, d, hq), "wk": (r, d, hk), "wv": (r, d, hk),
                "wo": (r, hq, d)}
        if cfg.qkv_bias:
            attn.update(bq=(r, hq), bk=(r, hk), bv=(r, hk))
        return attn
    if kind == "m":
        di, ds = cfg.mamba_expand * d, cfg.mamba_d_state
        rank = -(-d // 16)
        return {"in_proj": (r, d, 2 * di), "conv_w": (r, cfg.mamba_d_conv, di),
                "conv_b": (r, di), "x_proj": (r, di, rank + 2 * ds),
                "dt_proj": (r, rank, di), "dt_bias": (r, di),
                "A_log": (r, di, ds), "D": (r, di), "out_proj": (r, di, d)}
    if kind == "x":
        di, h = int(cfg.mlstm_proj * d), cfg.n_heads
        return {"up": (r, d, 2 * di), "wq": (r, di, di), "wk": (r, di, di),
                "wv": (r, di, di), "wif": (r, di, 2 * h), "bif": (r, 2 * h),
                "down": (r, di, d)}
    from repro_torch.models.ssm import slstm_inner_dim
    di = slstm_inner_dim(d, cfg.n_heads, cfg.slstm_proj)
    return {"wx": (r, d, 4 * di), "wh": (r, di, 4 * di), "b": (r, 4 * di),
            "down": (r, di, d)}


def _block_shapes(cfg: ArchConfig, kind: str, ffn: Optional[str],
                  r: int) -> Dict[str, Any]:
    """A block of mixer ``kind`` and FFN ``ffn`` stacked over ``r``
    layers: ``ln1`` and the mixer (``attn``, ``mamba``, ``mlstm`` or
    ``slstm``); where there is an FFN ``ln2`` and ``mlp`` or ``moe_ep``
    / ``moe_tp`` (``router`` (r, d, E), ``wg``/``wu`` (r, E, d, ff),
    ``wd`` (r, E, ff, d)); in an encoder-decoder's attention block
    ``xattn`` (no bias) and ``lnx``."""
    from repro_torch.models.lm import MIXER
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    slot = {"ln1": {"scale": (r, d)}, MIXER[kind]: _mixer_shapes(cfg, kind, r)}
    if ffn is not None:
        slot["ln2"] = {"scale": (r, d)}
    if ffn == "mlp":
        slot[ffn] = {"wg": (r, d, ff), "wu": (r, d, ff), "wd": (r, ff, d)}
    elif ffn is not None:
        slot[ffn] = {"router": (r, d, e), "wg": (r, e, d, ff),
                     "wu": (r, e, d, ff), "wd": (r, e, ff, d)}
    if cfg.enc_dec and kind == "a":
        hq, hk = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
        slot["xattn"] = {"wq": (r, d, hq), "wk": (r, d, hk),
                         "wv": (r, d, hk), "wo": (r, hq, d)}
        slot["lnx"] = {"scale": (r, d)}
    return slot


def _lm_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """The LM's parameter tree as shapes (the reference's ``LM.init``
    tree): ``embed``, ``head`` (unless tied), ``final_ln`` and
    ``slots[j]`` for each pattern slot, stacked over the R = ``n_layers
    / len(pattern)`` repeats (:func:`_block_shapes`); an encoder-decoder
    adds ``enc_slots`` (one attention block stacked over
    ``enc_layers``), ``pos_embed_enc`` (enc_positions, d),
    ``pos_embed_dec`` (max(max_positions, 1), d) and ``enc_final_ln``;
    the patch frontend adds ``patch_proj`` (frontend_dim, d)."""
    from repro_torch.models.lm import ffn_key, unsupported
    why = unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why} cannot be built")
    d, vp = cfg.d_model, cfg.vocab_padded
    r = cfg.n_layers // len(cfg.pattern)
    tree: Dict[str, Any] = {
        "embed": (vp, d), "final_ln": {"scale": (d,)},
        "slots": [_block_shapes(cfg, kind, ffn_key(cfg, j), r)
                  for j, kind in enumerate(cfg.pattern)]}
    if not cfg.tie_embeddings:
        tree["head"] = (d, vp)
    if cfg.enc_dec:
        tree["enc_slots"] = [_block_shapes(cfg, "a", "mlp", cfg.enc_layers)]
        tree["pos_embed_enc"] = (cfg.enc_positions, d)
        tree["pos_embed_dec"] = (max(cfg.max_positions, 1), d)
        tree["enc_final_ln"] = {"scale": (d,)}
    if cfg.frontend == "patch":
        tree["patch_proj"] = (cfg.frontend_dim, d)
    return tree


def lm_params_from_numpy(np_params: Mapping[str, Any], cfg: ArchConfig,
                         device) -> Dict[str, Any]:
    """The reference's ``LM.init`` tree (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's tree of tensors on ``device``.
    Raises on a missing or extra leaf, a wrong shape or a non-float
    array."""
    dev = resolve_device(device)

    def walk(tree, want, path):
        if isinstance(want, dict):
            if not isinstance(tree, Mapping) or set(tree) != set(want):
                got = sorted(tree) if isinstance(tree, Mapping) else tree
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"expected {sorted(want)}")
            return {k: walk(tree[k], want[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(tree, (list, tuple)) or len(tree) != len(want):
                raise ValueError(f"{path}: expected a list of {len(want)} "
                                 "slot(s)")
            return [walk(t, w, f"{path}/{i}")
                    for i, (t, w) in enumerate(zip(tree, want))]
        a = np.asarray(tree)
        if a.shape != want:
            raise ValueError(f"{path}: shape {a.shape} != expected {want}")
        if a.dtype.kind != "f":
            raise TypeError(f"{path}: dtype {a.dtype}; expected floating "
                            "point")
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return walk(np_params, _lm_shapes(cfg), "")


def _tensor_from_numpy(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or "bfloat16" in str(a.dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def tree_from_numpy(tree, device):
    """Nested dicts and lists of arrays (numpy, or anything ``np.asarray``
    takes; bf16 included) -> the same structure of tensors on
    ``device``; ``None`` stays ``None``."""
    dev = resolve_device(device)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, Mapping):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return _tensor_from_numpy(t, dev)
    return walk(tree)


def opt_state_from_numpy(state, device,
                         convert: Optional[Callable[[Any], Any]] = None):
    """The reference's ``OptState`` (``step``, ``mu``, ``nu``,
    ``master``; a 0-d int32 step and trees of arrays) -> the port's
    :class:`~repro_torch.optim.OptState` on ``device``, its ``step`` a
    Python int.  ``convert(tree)`` carries each of the three trees over
    (e.g. ``lambda t: lm_params_from_numpy(t, cfg, device)`` to check
    the LM's shapes); by default :func:`tree_from_numpy`."""
    from repro_torch.optim import OptState
    conv = convert or (lambda t: tree_from_numpy(t, device))
    master = state.master
    return OptState(int(np.asarray(state.step)), conv(state.mu),
                    conv(state.nu), None if master is None else conv(master))
