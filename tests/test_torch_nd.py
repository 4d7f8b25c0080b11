"""The port's 3-D serving path against the JAX package and against exact
restatements, on the CPU.

* K2's int8 pair: what :func:`sd_conv` runs for a CPU tensor (its plain
  version, ``sd_conv_ref`` on the int8 pair) equals an int64 numpy
  restatement exactly on ragged output windows, in-kernel pads, odd
  ``Cin`` and codes at +-127, and so does K2 int8's implicit GEMM
  (``csrc/sd_conv_int8.cu`` on ``sd_igemm.cuh``'s s8 path: A gathered
  with a zero halo from the window's origin, 64-deep k-tiles, ``GEMM_BM
  x bn`` blocks, int32 partials summed in split order, the window
  store) restated through ``_torch_igemm`` on the default ``gemm_plan``
  and forced ``GemmPlan``s; an int8 ``ConvGeom`` plans an int8 GEMM; the
  int32 range check counts every term the caller sums (``Cin x KT_d x
  KT_h x KT_w`` for 3-D).
* The rank-3 fused lowering (``ops.sd_deconv_presplit_fused_3d``: one K2
  launch per depth tap, here K2's plain version) matches the reference's
  ``backend="xla"`` rank-3 plans and its ``native_deconv`` at the
  reference's forward gate ``rtol=atol=1e-5``, on VoxGAN's three layers
  at narrow widths and on padding / ``output_padding`` cases.
* In int8 it equals the port's int8 ``torch`` backend exactly (both sum
  exactly and round at the same places) and matches the reference's int8
  xla path at the reference's ``rtol=atol=1e-3`` (the reference convolves
  f32-cast operands, so it is not exact); the zero rows of a padded
  bucket leave real samples bit-identical.
* The reduced VoxGAN (the reference's ``voxgan-dryrun`` spec, the
  reference's params) matches the reference model on xla (f32 1e-5,
  int8 1e-3); ``GenServer`` serves it in f32 and int8 on ``--device
  cpu``, and full-width VoxGAN through the CLI.

The reference's own rank-3 fused backend is not compared against: its
Pallas kernel needs ``pl.Unblocked``, which the installed jax lacks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sd as jsd
from repro.core.deconv import native_deconv as j_native
from repro.launch.serve_gen import reduced_specs as j_reduced_specs
from repro.models.generative import GenerativeModel as JModel
import repro_torch.kernels.sd_conv as K
import repro_torch.sd as tsd
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core.accounting import WORKLOADS
from repro_torch.core.deconv import same_deconv_pads
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import (GEMM_BK, GEMM_BK_INT8, GEMM_BN,
                                          GEMM_BN_INT8, SMEM_BUDGET,
                                          ConvGeom, GemmPlan, WinoPlan,
                                          check_gemm_plan, gemm_plan,
                                          gemm_smem_bytes)
from repro_torch.launch.serve_gen import (GenServer, main, reduced_specs,
                                          serve_async)
from repro_torch.models.generative import GenerativeModel
from _torch_igemm import gather_a, split_k_product

F32 = dict(rtol=1e-5, atol=1e-5)        # the reference's forward gate
INT8_REF = dict(rtol=1e-3, atol=1e-3)   # vs the reference's int8 xla path


# ---------------------------------------------------------------------------
# K2's int8 pair: plain version and blocking, exact against int64.
# ---------------------------------------------------------------------------

def _np_conv(xq, wq, pad, out_start, out_size):
    """Stride-1 VALID conv of the zero-padded input restated in int64,
    then the output window."""
    (plo_h, phi_h), (plo_w, phi_w) = pad
    xp = np.pad(xq.astype(np.int64), ((0, 0), (plo_h, phi_h),
                                      (plo_w, phi_w), (0, 0)))
    kth, ktw = wq.shape[:2]
    oh, ow = xp.shape[1] - kth + 1, xp.shape[2] - ktw + 1
    y = np.zeros((xq.shape[0], oh, ow, wq.shape[-1]), np.int64)
    for a in range(kth):
        for c in range(ktw):
            y += np.einsum("bhwi,io->bhwo", xp[:, a:a + oh, c:c + ow],
                           wq[a, c].astype(np.int64))
    (sh, sw), (n_h, n_w) = out_start, out_size or (oh, ow)
    return y[:, sh:sh + n_h, sw:sw + n_w]


def _emulate_k2_int8(xq, wq, pad, out_start, out_size, plan=None):
    """What ``csrc/sd_conv_int8.cu`` computes, from the integers the
    wrapper hands it: K2's GEMM of ``M = B*OH*OW`` output positions x ``N
    = Co`` x ``K = KTh*KTw*Cin``, A gathered from the int8 input in place
    (zero halo; the window's origin ``os - plo`` is the input offset of
    position (0, 0)), the int64 product of each ``GEMM_BM x bn`` block
    over its split's 64-deep k-tiles, the splits' int32 partials summed in
    split order, and the window store ``C[m, n] -> y[b, i, j, n]`` with
    ``m = (b*OH + i)*OW + j``, each element written once."""
    b = xq.shape[0]
    kth, ktw, cin, co = wq.shape
    oh, ow = out_size
    gg = ConvGeom(h=xq.shape[1], w=xq.shape[2], cin=cin, co=co, kth=kth,
                  ktw=ktw, out_h=oh, out_w=ow, dtype="int8").as_gemm(b)
    plan = plan if plan is not None else gemm_plan(gg)
    check_gemm_plan(gg, plan)
    assert gg.bk == GEMM_BK_INT8 and (gg.m, gg.n) == (b * oh * ow, co)
    (plo_h, _), (plo_w, _) = pad
    a = gather_a(xq, (kth, ktw), out_start[0] - plo_h,
                 out_start[1] - plo_w, oh, ow)
    c, _ = split_k_product(a.astype(np.int64),
                           wq.reshape(gg.k, gg.n).astype(np.int64), plan,
                           bk=gg.bk)
    assert np.abs(c).max() < 2 ** 31           # the int32 accumulator
    y = np.full(b * oh * ow * co, np.iinfo(np.int64).min)
    m, n = np.divmod(np.arange(c.size), co)
    y[m * co + n] = c[m, n]
    assert (y != np.iinfo(np.int64).min).all(), "an element never written"
    return y.reshape(b, oh, ow, co)


# (x shape, w shape, pad, out_start, out_size)
K2_INT8 = [
    ((3, 4, 4, 64), (2, 2, 64, 256), ((1, 1), (1, 1)), (0, 0), None),
    # VoxGAN up1's tap
    ((2, 5, 6, 3), (3, 3, 3, 5), ((2, 1), (0, 2)), (0, 0), None),
    # Cin 3 (byte copies), asym pads, Co 5
    ((2, 7, 6, 5), (2, 3, 5, 20), ((1, 1), (1, 1)), (1, 2), (5, 3)),
    # ragged window, Cin 5, Co 20 (4-byte B copies)
    ((1, 9, 10, 70), (3, 3, 70, 33), ((1, 1), (1, 1)), (0, 0), None),
    # Cin 70: K 630 is 10 k-tiles, Co 33
    ((2, 6, 5, 64), (2, 2, 64, 256), ((1, 0), (0, 1)), (0, 1), (5, 4)),
    # window + one-sided pads
]
# the default plan and every forced one: bn 16, 32 and 64, 1-3 splits
K2_INT8_PLANS = [None] + [GemmPlan(bn, sp) for bn in GEMM_BN
                          for sp in (1, 2, 3)]


@pytest.mark.parametrize("case", K2_INT8,
                         ids=[f"{c[0]}x{c[1]}" for c in K2_INT8])
def test_k2_int8_plain_and_blocking_equal_int64(case):
    sx, swh, pad, start, size = case
    rng = np.random.RandomState(sum(sx) + sum(swh))
    xq = rng.randint(-127, 128, sx).astype(np.int8)
    wq = rng.randint(-127, 128, swh).astype(np.int8)
    xq.flat[::7] = 127                      # codes at both ends
    wq.flat[::5] = -127
    ref = _np_conv(xq, wq, pad, start, size)
    before = K.SD_CONV_INT8_LAUNCHES, K.SD_CONV_LAUNCHES
    got = K.sd_conv(torch.from_numpy(xq), torch.from_numpy(wq), pad=pad,
                    out_start=start, out_size=size)
    assert (K.SD_CONV_INT8_LAUNCHES, K.SD_CONV_LAUNCHES) == before
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    for plan in K2_INT8_PLANS:
        np.testing.assert_array_equal(
            _emulate_k2_int8(xq, wq, pad, start, ref.shape[1:3], plan), ref,
            err_msg=str(plan))


@pytest.mark.parametrize("layer", ["up1", "up2", "to_vox"])
def test_k2_int8_plans_an_int8_gemm(layer):
    """An int8 ``ConvGeom`` is an int8 GEMM (64-deep k-tiles, at most
    ``GEMM_BN_INT8`` columns by default, an int32 split-K workspace); its
    f32 twin keeps 32-deep k-tiles and 64 columns.  On VoxGAN's tap conv
    of each layer at batch 16 (depth folded into the batch)."""
    l = {l.name: l for l in WORKLOADS["voxgan"]().deconv_layers()}[layer]
    p = tsd.plan((4, 4, 4, l.cin, l.cout), 2,
                 same_deconv_pads((4,) * 3, (2,) * 3), backend="torch")
    od = l.in_hw[0] + 2 * p.pi[0] - p.kt[0] + 1
    oh, ow = (n + 2 * pi - kt + 1 for n, pi, kt in
              zip(l.in_hw[1:], p.pi[1:], p.kt[1:]))
    f32 = ConvGeom(h=l.in_hw[1], w=l.in_hw[2], cin=l.cin,
                   co=p.phases * l.cout, kth=p.kt[1], ktw=p.kt[2], out_h=oh,
                   out_w=ow)
    gf, gq = (g.as_gemm(16 * od) for g in
              (f32, dataclasses.replace(f32, dtype="int8")))
    assert (gq.m, gq.n, gq.k) == (gf.m, gf.n, gf.k) == (
        16 * od * oh * ow, p.phases * l.cout, p.kt[1] * p.kt[2] * l.cin)
    assert (gq.dtype, gq.bk, gq.itemsize) == ("int8", GEMM_BK_INT8, 1)
    assert (gf.dtype, gf.bk) == ("", GEMM_BK)
    pq, pf = gemm_plan(gq), gemm_plan(gf)
    assert min(gq.n, GEMM_BN_INT8) <= pq.bn <= GEMM_BN_INT8
    assert pf.bn >= min(gf.n, GEMM_BN[-1])
    for g, pl in ((gq, pq), (gf, pf)):
        check_gemm_plan(g, pl)
        assert gemm_smem_bytes(g, pl) <= SMEM_BUDGET
    work = K._split_workspace(gq, GemmPlan(pq.bn, 2), torch.device("cpu"))
    assert work.dtype == torch.int32 and work.shape == (2, gq.m, gq.n)


def test_k2_int8_contract():
    xq = torch.randint(-127, 128, (1, 3, 3, 8), dtype=torch.int8)
    wq = torch.randint(-127, 128, (2, 2, 8, 4), dtype=torch.int8)
    assert K.sd_conv(xq, wq, sum_terms=8 * 8).dtype == torch.int32
    with pytest.raises(ValueError, match="overflow"):      # caller's taps
        K.sd_conv(xq, wq, sum_terms=140_000)
    with pytest.raises(ValueError, match="below"):
        K.sd_conv(xq, wq, sum_terms=8)
    with pytest.raises(TypeError, match="int8"):
        K.sd_conv(xq, wq.float())
    with pytest.raises(ValueError, match="sum_terms"):
        K.sd_conv(xq.float(), wq.float(), sum_terms=64)
    # Both dtypes run the GEMM on a GemmPlan; the int8 geometry is its
    # own GEMM (64-deep k-tiles, int8's column cap).
    f32 = ConvGeom(h=8, w=8, cin=32, co=128, kth=2, ktw=2, out_h=9, out_w=9)
    i8 = ConvGeom(h=8, w=8, cin=32, co=128, kth=2, ktw=2, out_h=9, out_w=9,
                  dtype="int8")
    assert f32 != i8
    gg, gq = f32.as_gemm(6), i8.as_gemm(6)
    assert (gg.m, gg.n, gg.k) == (gq.m, gq.n, gq.k) == (6 * 9 * 9, 128,
                                                        2 * 2 * 32)
    gp = gemm_plan(gg)
    assert isinstance(gp, GemmPlan) and gp.bn == 64
    assert gemm_plan(gq) == GemmPlan(GEMM_BN_INT8, 1)
    check_gemm_plan(gg, gp)
    assert torch.equal(K.sd_conv(xq, wq, plan=GemmPlan(16, 3)),
                       K.sd_conv(xq, wq))
    wp = WinoPlan(nth=2, ntw=2, nb=1, tc=16)
    for x, w in ((xq, wq), (xq.float(), wq.float())):
        with pytest.raises(TypeError, match="GemmPlan"):
            K.sd_conv(x, w, plan=wp)


def test_fused_3d_int8_contract():
    """The lowering refuses a 3-D sum that only its depth taps push past
    2^31 (Cin x 2 x 2 x 2), takes the calibrated half of the contract (a
    static row, int8 out) and refuses int8 out through tanh."""
    cin = 20_000                         # Cin*4*127^2 < 2^31 <= Cin*8*127^2
    xq = torch.zeros((1, 1, 1, 1, cin), dtype=torch.int8)
    ws = torch.zeros((2, 2, 2, cin, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        ops.sd_deconv_presplit_fused_3d(xq, ws, 4, 2, 1,
                                        scale=torch.ones(1, 8))
    gen = torch.Generator().manual_seed(9)
    xq = torch.randint(-127, 128, (2, 2, 2, 2, 4), generator=gen,
                       dtype=torch.int8)
    ws = torch.randint(-127, 128, (2, 2, 2, 4, 8), generator=gen,
                       dtype=torch.int8)
    # a static (1, NC) row is every sample's row
    row = ops.sd_deconv_presplit_fused_3d(xq, ws, 4, 2, 1,
                                          scale=torch.full((1, 8), 0.01))
    assert torch.equal(row, ops.sd_deconv_presplit_fused_3d(
        xq, ws, 4, 2, 1, scale=torch.full((2, 8), 0.01)))
    # int8 out: round half to even and a saturating clamp of the f32 out
    q = ops.sd_deconv_presplit_fused_3d(xq, ws, 4, 2, 1,
                                        scale=torch.full((2, 8), 0.01),
                                        out_dtype=torch.int8)
    assert q.dtype == torch.int8 and torch.equal(q, K.requantize(row))
    assert int((q.abs() == 127).sum()) > 0
    with pytest.raises(ValueError, match="tanh"):
        ops.sd_deconv_presplit_fused_3d(xq, ws, 4, 2, 1, act="tanh",
                                        scale=torch.ones(1, 8),
                                        out_dtype=torch.int8)
    with pytest.raises(ValueError, match="scale"):
        ops.sd_deconv_presplit_fused_3d(xq.float(), ws.float(), 4, 2, 1,
                                        scale=torch.ones(2, 8))


# ---------------------------------------------------------------------------
# The rank-3 fused lowering against the reference.
# ---------------------------------------------------------------------------

def _narrow(layer, div=8):
    return (layer.k, layer.s, "same", 0,
            (2, *layer.in_hw, max(1, layer.cin // div)),
            max(1, layer.cout // div))


VOX = {l.name: _narrow(l) for l in WORKLOADS["voxgan"]().deconv_layers()}
# (kernel, stride, padding, output_padding, x shape, Cout)
ODD = {
    "k3s2p1op1": (3, 2, 1, 1, (2, 3, 4, 3, 5), 3),
    "k5s2asym": (5, 2, ((1, 2), (2, 1), (0, 1)), 0, (1, 3, 3, 4, 3), 2),
    "k4s122op": (4, (1, 2, 2), 1, (0, 1, 0), (2, 4, 3, 3, 4), 3),
}
CASES = {**{f"voxgan/{k}": v for k, v in VOX.items()}, **ODD}


def _case_data(name, seed=0):
    k, s, pad, op, sx, cout = CASES[name]
    pad = same_deconv_pads((k,) * 3, (s,) * 3) if pad == "same" else pad
    rng = np.random.RandomState(seed + sum(sx))
    x = rng.randn(*sx).astype(np.float32)
    w = (rng.randn(k, k, k, sx[-1], cout) / np.sqrt(k ** 3 * sx[-1])) \
        .astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(cout)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    return x, w, scale, bias, k, s, pad, op


def _count_taps(monkeypatch):
    calls = []
    real = ops.sd_conv

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "sd_conv", counted)
    return calls


@pytest.mark.parametrize("name", list(CASES))
def test_fused_3d_matches_reference_xla_and_native(name, monkeypatch):
    x, w, scale, bias, k, s, pad, op = _case_data(name)
    wshape = w.shape
    ref = np.asarray(jsd.execute(
        jsd.plan(wshape, s, pad, backend="xla", act="relu",
                 output_padding=op).bind(jnp.asarray(w), jnp.asarray(scale),
                                         jnp.asarray(bias)),
        jnp.asarray(x)))
    nat = np.maximum(np.asarray(j_native(jnp.asarray(x), jnp.asarray(w), s,
                                         pad, output_padding=op))
                     * scale + bias, 0)
    p = tsd.plan(wshape, s, pad, backend="fused", act="relu",
                 output_padding=op).bind(torch.from_numpy(w),
                                         torch.from_numpy(scale),
                                         torch.from_numpy(bias))
    assert p.layout == "nmajor" and p.rank == 3
    calls = _count_taps(monkeypatch)
    got = tsd.execute(p, torch.from_numpy(x)).numpy()
    assert calls == [torch.float32] * p.kt[0]      # one K2 per depth tap
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **F32)
    np.testing.assert_allclose(got, nat, **F32)


@pytest.mark.parametrize("name", list(CASES))
def test_fused_3d_int8_exact_vs_torch_and_close_to_reference(name,
                                                             monkeypatch):
    x, w, scale, bias, k, s, pad, op = _case_data(name, seed=1)
    kw = dict(act="tanh", output_padding=op, dtype="int8")
    args = (torch.from_numpy(w), torch.from_numpy(scale),
            torch.from_numpy(bias))
    pf = tsd.plan(w.shape, s, pad, backend="fused", **kw).bind(*args)
    pt = tsd.plan(w.shape, s, pad, backend="torch", **kw).bind(*args)
    assert pf.layout == pt.layout == "nmajor"
    assert torch.equal(pf.ws, pt.ws) and torch.equal(pf.wscale, pt.wscale)
    calls = _count_taps(monkeypatch)
    got = tsd.execute(pf, torch.from_numpy(x))
    assert calls == [torch.int8] * pf.kt[0]
    assert got.dtype == torch.float32
    assert torch.equal(got, tsd.execute(pt, torch.from_numpy(x)))
    ref = np.asarray(jsd.execute(
        jsd.plan(w.shape, s, pad, backend="xla", **kw).bind(
            *(jnp.asarray(a) for a in (w, scale, bias))), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, **INT8_REF)


def test_fused_3d_int8_quantizes_each_sample_volume():
    """Per-sample scales are taken over each sample's whole volume before
    depth is folded into the batch, so the zero rows of a padded bucket
    never touch a real sample."""
    x, w, scale, bias, k, s, pad, op = _case_data("voxgan/up2", seed=2)
    xt = torch.from_numpy(x)
    xp = torch.cat([xt, torch.zeros_like(xt)])
    p = tsd.plan(w.shape, s, pad, backend="fused", act="relu",
                 dtype="int8").bind(torch.from_numpy(w),
                                    torch.from_numpy(scale),
                                    torch.from_numpy(bias))
    q, sx = tq.quantize_act(xt)
    assert torch.equal(sx, xt.abs().amax(dim=(1, 2, 3, 4)) / 127.0)
    assert torch.equal(tsd.execute(p, xt), tsd.execute(p, xp)[:2])


def test_fused_3d_conv_transpose_grads_match_reference():
    """A rank-3 fused plan is differentiable: its forward is the lowering,
    its backward the plain torch formulation (as in the reference, whose
    rank-3 backward is lax's); held to the reference's xla grads at the
    gradient gate 1e-4."""
    x, w, scale, bias, k, s, pad, op = _case_data("k3s2p1op1", seed=3)
    jp = jsd.plan(w.shape, s, pad, backend="xla", output_padding=op)
    y0 = jsd.conv_transpose(jp, jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(bias))
    c = np.random.RandomState(4).randn(*y0.shape).astype(np.float32)

    def loss(xa, wa, ba):
        return jnp.sum(jsd.conv_transpose(jp, xa, wa, ba) * c)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(bias))
    tp = tsd.plan(w.shape, s, pad, backend="fused", output_padding=op)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    y = tsd.conv_transpose(tp, xt, wt, bt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y0), **F32)
    (y * torch.from_numpy(c)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad, bt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# The reduced VoxGAN model and its server.
# ---------------------------------------------------------------------------

def _reference_voxgan(dtype="native"):
    spec = j_reduced_specs()["voxgan-dryrun"]
    jm = JModel(spec, "sd_kernel", engine_backend="xla", engine_dtype=dtype)
    jp = jm.init(jax.random.PRNGKey(0))
    z = np.random.RandomState(6).randn(3, spec.layers[0].cin).astype(
        np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(z)))
    return jax.tree_util.tree_map(np.asarray, jp), z, ref


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_voxgan_dryrun_model_matches_reference(dtype):
    np_params, z, ref = _reference_voxgan(dtype)
    spec = reduced_specs()["voxgan-dryrun"]
    outs = {}
    for backend in ("fused", "torch"):
        m = GenerativeModel(spec, "sd_kernel", engine_backend=backend,
                            device="cpu", engine_dtype=dtype)
        params = params_from_numpy(np_params, "cpu", spec=spec)
        with torch.no_grad():
            outs[backend] = m.apply(params, torch.from_numpy(z))
        assert outs[backend].shape == ref.shape == (3, 8, 8, 8, 1)
        np.testing.assert_allclose(outs[backend].numpy(), ref,
                                   **(F32 if dtype == "native"
                                      else INT8_REF))
    if dtype == "int8":
        assert torch.equal(outs["fused"], outs["torch"])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_genserver_serves_voxgan_dryrun(dtype, monkeypatch):
    spec = reduced_specs()["voxgan-dryrun"]
    server = GenServer(nets=("voxgan-dryrun",),
                       specs={"voxgan-dryrun": spec}, device="cpu",
                       max_batch=4, backend="fused",
                       dtype=torch.float32 if dtype == "float32" else "int8")
    assert server.warmup() == len(server.buckets())
    model, params = server.model("voxgan-dryrun")
    plans = model.engine.plans()
    assert [(p.rank, p.backend, p.layout, p.dtype) for p in plans.values()] \
        == [(3, "fused", "nmajor",
             "int8" if dtype == "int8" else "native")] * 2
    reqs = server.random_requests("voxgan-dryrun", 3, seed=2)
    calls = _count_taps(monkeypatch)
    results, stats = serve_async(server, reqs)
    assert stats["served"] == 3 and stats["shed"] == 0
    assert len(calls) == 2 * 2 * stats["launches"]   # layers x depth taps
    # The same bucket of 4 (3 latents and a zero row) through the model.
    z = torch.stack([r.latent for r in reqs] + [torch.zeros_like(
        reqs[0].latent)])
    with torch.no_grad():
        ref = model.apply(params, z)[:3]
    out = torch.stack([results[r.rid] for r in reqs])
    assert out.shape == (3, 8, 8, 8, 1)
    if dtype == "int8":              # exact sums, per-sample scales
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, **F32)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_serve_gen_full_width_voxgan_cpu(dtype):
    results, stats = main(["--nets", "voxgan", "--device", "cpu",
                           "--requests", "2", "--max-batch", "2",
                           "--backend", "fused", "--dtype", dtype])
    assert stats["served"] == 2 and stats["shed"] == 0
    assert stats["compile_cache"] == [f"('voxgan', 2, '{dtype}')"]
    out = results[0]
    assert out.shape == (32, 32, 32, 1) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and out.abs().max() <= 1.0
