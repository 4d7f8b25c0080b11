"""Mamba's chunk scan as one operator (``repro_torch::mamba_chunk_scan``)
and its backward as a second (``repro_torch::mamba_chunk_scan_backward``),
on the CPU.

The operators run the plain body (``ssm._mamba_chunk``, a loop of one
``addcmul`` a step), so their forward and the gradients taken through
them are bit-identical to the body's under autograd, and
``mamba_forward`` to the checkpointed loop it replaces (kept here as
``_plain_scan``); ``gradcheck`` holds the pair in float64.  On the meta
device the fakes give the outputs' shapes.  The dry-run's ``StepTrace``
charges each call what its body dispatches: FLOPs by the registered
formula, bytes and peak by the body's own trace.  A reduced Jamba train
step traced on the meta device dispatches far fewer ops and keeps its
peak; its FLOPs and bytes grow by exactly the one contraction a call's
backward recomputes that the checkpoint's early stop skipped (the
``bmm`` of C, ``2·B·L·di·ds`` FLOPs over its operands' and output's
bytes).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import ShapeCell, get
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import dryrun as D
from repro_torch.models import ssm as S

SCAN = torch.ops.repro_torch.mamba_chunk_scan
SCAN_BWD = torch.ops.repro_torch.mamba_chunk_scan_backward


def _plain_scan(dt, x_c, A, bmat, cmat, h0, chunk):
    """The scan before the operators: each chunk's body under
    ``torch.utils.checkpoint``."""
    h, ys = h0, []
    for i in range(dt.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        h, y = S._recompute(S._mamba_chunk, h, dt[:, sl], x_c[:, sl],
                            bmat[:, sl], cmat[:, sl], A)
        ys.append(y)
    return torch.cat(ys, 1), h


def _chunk_inputs(b, l, di, ds, dtype=torch.float32, device="cpu",
                  grad=True, seed=0):
    """h (B, di, ds), dtb, xb (B, L, di), bb, cb (B, L, ds), A (di, ds):
    the time slices are views of a longer sequence, as the scan passes
    them; the leaves they are cut from come last."""
    g = torch.Generator().manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64).to(
            dtype).to(device).requires_grad_(grad)
    h = mk(b, di, ds)
    dt_full = mk(b, 3 * l, di)
    x_full, b_full, c_full = mk(b, 3 * l, di), mk(b, 3 * l, ds), \
        mk(b, 3 * l, ds)
    a = mk(di, ds)
    sl = slice(l, 2 * l)
    # positive step sizes and a negative A, as the scan feeds them
    dtb = torch.nn.functional.softplus(dt_full[:, sl])
    return ((h, dtb, x_full[:, sl], b_full[:, sl], c_full[:, sl],
             -torch.exp(a)), [h, dt_full, x_full, b_full, c_full, a])


@pytest.mark.parametrize("shape", [(2, 8, 12, 4), (1, 5, 3, 2)])
def test_op_is_the_plain_body_bit_for_bit(shape):
    args, leaves = _chunk_inputs(*shape)
    want = S._mamba_chunk(*args)
    got = SCAN(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g = torch.Generator().manual_seed(1)
    ws = [torch.randn(t.shape, generator=g) for t in want]

    def grads(outs):
        loss = sum((o * w).sum() for o, w in zip(outs, ws))
        return torch.autograd.grad(loss, leaves, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(grads(got), grads(want)))


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward_is_the_checkpointed_loop_bit_for_bit(monkeypatch,
                                                           with_state):
    """``mamba_forward``'s output, new state and every gradient (input,
    each param, the state) against the checkpointed loop, CPU f32, a
    sequence the chunk does not divide."""
    gen = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in
         S.init_mamba(gen, 16, d_state=4).items()}
    x = torch.randn(2, 19, 16, generator=gen).requires_grad_(True)
    state = None
    if with_state:
        state = S.MambaState(torch.randn(2, 3, 32, generator=gen),
                             torch.randn(2, 32, 4, generator=gen)
                             .requires_grad_(True))
    w = torch.randn(2, 19, 16, generator=gen)
    ws = torch.randn(2, 32, 4, generator=gen)
    leaves = [x, *p.values()] + ([state.ssm] if with_state else [])

    def run():
        y, new = S.mamba_forward(p, x, state, chunk=8)
        loss = (y * w).sum() + ((new.ssm * ws).sum() if with_state else 0)
        return y, new, torch.autograd.grad(loss, leaves)
    got = run()
    monkeypatch.setattr(S, "_mamba_scan_chunked", _plain_scan)
    want = run()
    assert torch.equal(got[0], want[0])
    if with_state:
        assert torch.equal(got[1].ssm, want[1].ssm)
        assert torch.equal(got[1].conv, want[1].conv)
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_gradcheck_in_float64():
    args, _ = _chunk_inputs(1, 4, 3, 2, dtype=torch.float64)
    args = tuple(a.detach().requires_grad_(True) for a in args)
    assert torch.autograd.gradcheck(SCAN, args)


def test_fakes_give_the_shapes():
    args, _ = _chunk_inputs(2, 8, 12, 4, device="meta", grad=False)
    h, y = SCAN(*args)
    assert h.device.type == "meta" and h.shape == (2, 12, 4)
    assert y.shape == (2, 8, 12)
    gh, gy = torch.empty_like(h), torch.empty_like(y)
    needs = [True, True, False, True, True, True]
    grads = SCAN_BWD(*args, gh, gy, needs)
    assert [tuple(g.shape) for g in grads] == [
        tuple(a.shape) for a, n in zip(args, needs) if n]


def _traced(fn, *args):
    tr = D.StepTrace()
    tr.exclude(args)
    with tr:
        fn(*args)
    return tr


@pytest.mark.parametrize("shape", [(2, 8, 12, 4), (1, 128, 64, 16)])
def test_step_trace_charges_the_plain_body(shape):
    """Forward and backward operator on meta tensors: the FLOPs (the
    registered formulas), bytes and peak of the plain body and of its
    recompute-and-grad."""
    args, _ = _chunk_inputs(*shape, device="meta", grad=False)
    op, body = _traced(SCAN, *args), _traced(S._mamba_chunk, *args)
    assert (op.flops, op.bytes, op.peak) == (body.flops, body.bytes,
                                             body.peak)
    assert op.flops == S.scan_flops(args[1].shape, shape[3])
    assert op.ops == 1 < body.ops
    g = (torch.empty(shape[0], shape[2], shape[3], device="meta"),
         torch.empty(shape[:3], device="meta"))
    for needs in ([True] * 6, [False, True, True, True, True, True]):
        def bwd_op(*a):
            return SCAN_BWD(*a, needs)

        def bwd_body(*a):
            return S._scan_grads(*a, needs)
        op = _traced(bwd_op, *args, *g)
        body = _traced(bwd_body, *args, *g)
        assert (op.flops, op.bytes, op.peak) == (body.flops, body.bytes,
                                                 body.peak)
        assert op.flops == S.scan_flops(args[1].shape, shape[3],
                                        backward=True)


def test_reduced_jamba_step_trace(monkeypatch):
    """The reduced Jamba's train step (2 x 32 tokens, chunk 8, 7 Mamba
    layers) traced on meta on dp1 x mp2, through the operators and
    through the checkpointed loop: far fewer ops, the same peak, and
    FLOPs and bytes above by exactly one C contraction per backward
    call (module doc)."""
    cfg = dataclasses.replace(get("jamba-1.5-large-398b").reduced(),
                              microbatch=1)
    cell = ShapeCell("t", "train", 32, 2)
    got = D.trace_step(cfg, cell, Mesh(1, 2))
    monkeypatch.setattr(S, "_mamba_scan_chunked", _plain_scan)
    want = D.trace_step(cfg, cell, Mesh(1, 2))
    b, l, ds = 2, cfg.mamba_chunk, cfg.mamba_d_state
    di = cfg.mamba_expand * cfg.d_model // 2          # the rank's channels
    calls = 32 // l * cfg.pattern.count("m") * (cfg.n_layers
                                                // len(cfg.pattern))
    g, w = got["trace"], want["trace"]
    assert g.ops < 0.6 * w.ops
    assert g.peak == w.peak
    assert got["memory"] == want["memory"]
    assert g.flops - w.flops == calls * 2 * b * l * di * ds
    assert g.bytes - w.bytes == calls * 4 * b * l * (di * ds + ds + di)
    assert dict(got["mesh"].counts) == dict(want["mesh"].counts)
