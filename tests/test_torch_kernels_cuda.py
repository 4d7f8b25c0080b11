"""The port's CUDA kernels K1, K2 (f32 and its int8 pair), K3, K4 and K5
against their plain versions.

Marked ``cuda``: each test decides inside itself whether a card is
present and skips, with the reason, where there is none.  On a machine
with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider \\
        tests/test_torch_kernels_cuda.py

f32 gate ``max|d| <= 1e-4 * max(1, max|y_ref|)`` with TF32 off (K1's
float branch and K2 run 3xTF32 on the tensor cores into f32
accumulators, the plain version runs cuDNN in f32, in another order);
bf16 gate ``1e-2 * max|y_ref|`` (both accumulate in f32, so the
difference is the bf16 rounding of the output). K1 and K2 also run on
forced GEMM plans (ragged M/N/K, split-K with 1, 2 and an uneven last
split, Cin not a multiple of 4, bf16) and split-K twice, bit-identical;
K3 (the filter grad, on the same tiles) on forced ``GemmPlan``s too.
K4 (Winograd) is held to the same gates against its plain version
``sd_wino_ref``, and against K1 on the same split filters at the
reference's ``tolerance(K_T) * max(1, max|y_K1|)``, on the default and
forced ``WinoPlan``s. K1's int8 branch (the same GEMM on the s8
tensor cores) is held to its plain version (``sd_fused_ref`` on the int8
pair, exact sums) at two gates: bit-identical at unit scale, zero bias
and linear act, and ``1e-6 * max(1, max|y_ref|)`` with real per-sample
scales, folded-BN filter scales, bias and relu/tanh, on default and
forced ``GemmPlan``s (ragged N, Cin tails, several splits); every code
at +-127 on DCGAN d1 is exact against an int64 restatement. K2's int8 pair is
bit-identical to its plain version (exact int32 sums); the 3-D lowering
(one K2 launch per depth tap) equals the card's ``torch`` backend within
``1e-5 * max(1, max|y_ref|)`` in f32 and exactly in int8. K1 int8's
calibrated half (a static (1, NC) scale row, int8 output) is
bit-identical to its plain version on saturating scales, and the
calibrated servers (DCGAN on K1 int8, VoxGAN on K2 int8) chain int8
between layers and equal the card's int8 ``torch`` backend. K1, K4 and
the 3-D lowering refuse an operand that requires grad under grad mode.
The port's own f32 cuDNN convs run in full f32 with cuDNN's TF32 default
on.
K5 (flash attention) is held to ``flash_attention_ref`` at ``2e-5 *
max(1, max|ref|)`` in f32 (``tests/test_flash_attn.py``'s tolerance) and
``1e-2 * max|ref|`` in bf16 (the oracle in f32 on the bf16 inputs), and
each bf16 element within ``2^-7 * |ref| + 1e-4 * max|ref|``, on ragged
sequences around both kernels' tiles, grouped heads and D up to 256, in
f32 also head dims that are not a multiple of 8 and operands that only
4-byte copies can read; the f32 kernel's SASS runs on TF32 HMMA; the
reduced LM's prefill through K5 matches the plain scan.  Rank 1
(WaveGAN): K1 (f32 and int8), K4, K2 and K3 as H=1 launches on
WaveGAN's layers at batch 16, at the same gates, and full-width WaveGAN
served in f32, dynamic and calibrated int8 against the card's ``torch``
backend.  Measured tiles: ``autotune.measure`` reads device time below
the host's time per call; every candidate tile of DCGAN d1's K1, K1 int8
and K4 at batches 1 and 16 matches the default plan (f32 within 1e-5 of
max(1, max|ref|), int8 bit for bit); a pretuned DCGAN server passes
chip_smoke phase 12's gates.
"""

import pytest
import torch

from repro_torch.core.accounting import BENCHMARKS, WORKLOADS
from repro_torch.core.deconv import same_deconv_pads
from repro_torch import sd
import repro_torch.kernels.sd_conv as K
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import GemmPlan, WinoPlan

pytestmark = pytest.mark.cuda

PAPER_LAYERS = [(net, l) for net, fn in BENCHMARKS.items()
                for l in fn().deconv_layers()]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _pair(x, p):
    geo = dict(bias=p.bias, act=p.act,
               pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
               crop=(p.pk[0] + p.padding[0][0], p.pk[1] + p.padding[1][0]),
               out_space=p.out_shape(x.shape[1:3]))
    before = K.SD_FUSED_LAUNCHES
    out = ops.sd_deconv_presplit_fused(
        x, p.ws, p.kernel, p.stride, p.padding,
        output_padding=p.output_padding, bias=p.bias, act=p.act,
        plan=p.tile)
    assert K.SD_FUSED_LAUNCHES == before + 1
    ref = K.sd_fused_ref(x, p.ws, p.stride, **geo)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == x.dtype
    return out.float(), ref.float()


def _layer(layer, dev, act, dtype=torch.float32, batch=2):
    g = torch.Generator().manual_seed(layer.cin + layer.cout)
    x = torch.randn(batch, *layer.in_hw, layer.cin, generator=g)
    w = torch.randn(layer.k, layer.k, layer.cin, layer.cout, generator=g)
    w /= (layer.k * layer.k * layer.cin) ** 0.5
    bias = torch.randn(layer.cout, generator=g) * 0.1
    p = sd.plan(w.shape, layer.s, same_deconv_pads(layer.k, layer.s),
                backend="fused", act=act, device=dev).bind(
                    w.to(dev, dtype), bias=bias.to(dev))
    return x.to(dev, dtype), p


@pytest.mark.parametrize("net,layer", PAPER_LAYERS,
                         ids=[f"{n}/{l.name}" for n, l in PAPER_LAYERS])
def test_paper_layers_f32(dev, net, layer):
    out, ref = _pair(*_layer(layer, dev, "relu"))
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.parametrize("act", ["linear", "relu", "tanh"])
def test_dcgan_layers_bf16(dev, act):
    for _, layer in PAPER_LAYERS[:3]:
        out, ref = _pair(*_layer(layer, dev, act, torch.bfloat16))
        assert (out - ref).abs().max().item() <= \
            1e-2 * ref.abs().max().item()


@pytest.mark.parametrize("sx,sw,s,pad,op,tile", [
    ((2, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1, None),          # op > pad_hi
    ((1, 6, 7, 3), (5, 5, 3, 2), 2, ((1, 3), (0, 2)), 0, None),
    ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1,
     GemmPlan(32, 2)),       # ragged, split 2
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
     GemmPlan(16, 3)),       # Cin 70, K ragged
])
def test_odd_geometries(dev, sx, sw, s, pad, op, tile):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(sx, generator=g).to(dev)
    w = (torch.randn(sw, generator=g) * 0.2).to(dev)
    bias = torch.randn(sw[-1], generator=g).to(dev)
    p = sd.plan(w.shape, s, pad, backend="fused", act="tanh",
                output_padding=op, tile=tile, device=dev).bind(w, bias=bias)
    out, ref = _pair(x, p)
    assert (out - ref).abs().max().item() <= 1e-4


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn(1, 4, 4, 3, device=dev)
    ws = torch.randn(2, 2, 3, 8, device=dev)
    with pytest.raises(TypeError, match="int8"):
        K.sd_fused(x.to(torch.int8), ws, 2)
    with pytest.raises(TypeError, match="dtype"):
        K.sd_fused(x, ws.bfloat16(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.sd_fused(x.transpose(1, 2), ws, 2)


# Forced GEMM plans of the float kernels (csrc/sd_igemm.cuh): (x shape, w
# shape, stride, pad, output_padding, plan).
GEMM_CASES = [
    ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1,
     GemmPlan(64, 1)),       # ragged M, N 96 of 2 x 64, K
    ((2, 9, 10, 64), (3, 3, 64, 12), 2, 1, 1,
     GemmPlan(16, 2)),       # split 2, N 48 of 16-tiles
    ((2, 9, 10, 72), (4, 4, 72, 20), 2, 1, 0,
     GemmPlan(32, 5)),       # 11 k-tiles in 5: uneven
    ((1, 7, 6, 5), (5, 5, 5, 3), 1, 2, 0,
     GemmPlan(16, 2)),       # Cin 5 (4-byte copies), s 1
    ((2, 6, 7, 7), (4, 4, 7, 9), 2, 1, 0,
     GemmPlan(64, 3)),       # Cin 7, N 36, 2 k-tiles
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("sx,sw,s,pad,op,plan", GEMM_CASES,
                         ids=[f"{c[0]}-{c[5]}" for c in GEMM_CASES])
def test_k1_forced_gemm_plans(dev, dtype, sx, sw, s, pad, op, plan):
    g = torch.Generator().manual_seed(sum(sx))
    x = torch.randn(sx, generator=g).to(dev, dtype)
    w = (torch.randn(sw, generator=g) * 0.2).to(dev)
    bias = torch.randn(sw[-1], generator=g).to(dev)
    p = sd.plan(w.shape, s, pad, backend="fused", act="tanh",
                output_padding=op, tile=plan, device=dev).bind(
                    w.to(dtype), bias=bias)
    out, ref = _pair(x, p)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= \
            1e-4 * max(1.0, ref.abs().max().item())
    else:
        assert (out - ref).abs().max().item() <= \
            1e-2 * ref.abs().max().item()


@pytest.mark.parametrize("sx,sw,s,pad,op,plan", GEMM_CASES,
                         ids=[f"{c[0]}-{c[5]}" for c in GEMM_CASES])
def test_k2_forced_gemm_plans(dev, sx, sw, s, pad, op, plan):
    """K2 on the same plans: the dx conv of the case's layer (contraction
    over the sw[-1] * s^2 phase channels, Co = Cin)."""
    from repro_torch.core.accounting import LayerSpec
    layer = LayerSpec("deconv", sx[3], sw[3], k=sw[0], s=s, in_hw=sx[1:3],
                      name="forced")
    _, ws, dy1, p = _backward_case(layer, dev, batch=sx[0], seed=5)
    _gate(*_k2_pair(dy1, ws, p, layer.in_hw, plan))


def test_split_k_is_bit_identical(dev):
    """Split-K sums its partials in a fixed order: two runs of K1 (f32
    and bf16) and of K2 with splits > 1 agree bit for bit."""
    layer = PAPER_LAYERS[0][1]                        # DCGAN d1
    for dtype in (torch.float32, torch.bfloat16):
        x, p = _layer(layer, dev, "relu", dtype, batch=4)
        args = (x, p.ws, p.kernel, p.stride, p.padding)
        plan = GemmPlan(64, 5)
        a, b = (ops.sd_deconv_presplit_fused(
            *args, output_padding=p.output_padding, bias=p.bias,
            act="relu", plan=plan) for _ in range(2))
        assert torch.equal(a, b)
    _, ws, dy1, p = _backward_case(layer, dev, batch=4)
    outs = [_k2_pair(dy1, ws, p, layer.in_hw, GemmPlan(64, 7))[0]
            for _ in range(2)]
    assert torch.equal(*outs)


# ---------------------------------------------------------------------------
# K2 (stride-1 conv, the SD backward's input grad) and K3 (filter grad)
# ---------------------------------------------------------------------------

def _backward_case(layer, dev, batch=2, seed=0):
    """x, split filters and the split cotangent dy1 of one paper layer."""
    from repro_torch.sd.grad import split_cotangent
    g = torch.Generator().manual_seed(seed)
    p = sd.plan((layer.k, layer.k, layer.cin, layer.cout), layer.s,
                same_deconv_pads(layer.k, layer.s), backend="fused",
                device=dev)
    x = torch.randn(batch, *layer.in_hw, layer.cin, generator=g)
    w = torch.randn(layer.k, layer.k, layer.cin, layer.cout, generator=g)
    w /= (layer.k * layer.k * layer.cin) ** 0.5
    dy = torch.randn(batch, *p.out_shape(layer.in_hw), layer.cout,
                     generator=g)
    dy1 = split_cotangent(p, dy.to(dev))
    return x.to(dev), sd.split_weights(p, w.to(dev)), dy1, p


def _k2_pair(dy1, ws, p, space, plan=None):
    kt, pi = p.kt, p.pi
    w_t = ws.flip(0, 1).transpose(-1, -2).contiguous()
    geo = dict(pad=tuple((k - 1, k - 1) for k in kt), out_start=pi,
               out_size=tuple(space))
    before = K.SD_CONV_LAUNCHES
    out = K.sd_conv(dy1, w_t, plan=plan, **geo)
    assert K.SD_CONV_LAUNCHES == before + 1
    ref = K.sd_conv_ref(dy1, w_t, **geo)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    return out, ref


def _k3_pair(x, dy1, p, plan=None):
    geo = dict(pad=tuple((q, q) for q in p.pi))
    before = K.SD_FILTER_GRAD_LAUNCHES
    out = K.sd_filter_grad(x, dy1, p.kt, plan=plan, **geo)
    assert K.SD_FILTER_GRAD_LAUNCHES == before + 1
    ref = K.sd_filter_grad_ref(x, dy1, p.kt, **geo)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    return out, ref


def _gate(out, ref):
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.parametrize("net,layer", PAPER_LAYERS[:3] + PAPER_LAYERS[-2:],
                         ids=[f"{n}/{l.name}" for n, l in
                              PAPER_LAYERS[:3] + PAPER_LAYERS[-2:]])
def test_backward_kernels_on_paper_layers(dev, net, layer):
    x, ws, dy1, p = _backward_case(layer, dev)
    _gate(*_k2_pair(dy1, ws, p, layer.in_hw))
    _gate(*_k3_pair(x, dy1, p))


def test_backward_kernels_ragged_tiles(dev):
    from repro_torch.core.accounting import LayerSpec
    layer = LayerSpec("deconv", 70, 5, k=5, s=2, in_hw=(13, 11), name="odd")
    x, ws, dy1, p = _backward_case(layer, dev, batch=3, seed=4)
    _gate(*_k2_pair(dy1, ws, p, layer.in_hw, GemmPlan(16, 5)))
    for plan in (GemmPlan(16, 9),          # many splits, an uneven last
                 GemmPlan(32, 1)):         # one split: no reduce kernel
        _gate(*_k3_pair(x, dy1, p, plan))
    # K3's split-K sums in split order: two runs agree bit for bit.
    a, _ = _k3_pair(x, dy1, p, GemmPlan(16, 9))
    b, _ = _k3_pair(x, dy1, p, GemmPlan(16, 9))
    assert torch.equal(a, b)


def test_training_step_runs_the_three_kernels(dev):
    from repro_torch.launch import train_gen
    from repro_torch.optim import adamw_init
    gen, disc = train_gen.make_gan(True, "sd_kernel", dev)
    gp = train_gen.trainable(gen.init(torch.Generator().manual_seed(0)))
    dp = train_gen.trainable(disc.init(torch.Generator().manual_seed(1)))
    g_opt = adamw_init(gp)
    z = torch.randn(4, 32, generator=torch.Generator().manual_seed(2))
    counts = (K.SD_FUSED_LAUNCHES, K.SD_CONV_LAUNCHES,
              K.SD_FILTER_GRAD_LAUNCHES)
    loss = train_gen.g_step(gen, disc, gp, dp, g_opt, z.to(dev))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert (K.SD_FUSED_LAUNCHES - counts[0], K.SD_CONV_LAUNCHES - counts[1],
            K.SD_FILTER_GRAD_LAUNCHES - counts[2]) == (2, 2, 2)


# ---------------------------------------------------------------------------
# K4: the Winograd split conv
# ---------------------------------------------------------------------------

def _wino_pair(x, p):
    """K4 through the deconv wrapper and its plain version, on a bound
    winograd plan."""
    from repro_torch.kernels import winograd as W
    geo = dict(bias=p.bias, act=p.act,
               pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
               crop=(p.pk[0] + p.padding[0][0], p.pk[1] + p.padding[1][0]),
               out_space=p.out_shape(x.shape[1:3]))
    before = W.SD_WINO_LAUNCHES
    out = ops.sd_deconv_presplit_wino(
        x, p.ws, p.kernel, p.stride, p.padding,
        output_padding=p.output_padding, bias=p.bias, act=p.act,
        plan=p.tile)
    assert W.SD_WINO_LAUNCHES == before + 1
    ref = W.sd_wino_ref(x, p.ws, p.kt, p.stride, **geo)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == x.dtype
    return out.float(), ref.float()


@pytest.mark.parametrize("net,layer", PAPER_LAYERS,
                         ids=[f"{n}/{l.name}" for n, l in PAPER_LAYERS])
def test_wino_paper_layers_f32(dev, net, layer):
    """K4 vs its plain version (1e-4 gate), and vs K1 on the same split
    filters at the reference's tolerance(K_T)."""
    from repro_torch.kernels.winograd import tolerance
    g = torch.Generator().manual_seed(layer.cin + layer.cout)
    x = torch.randn(2, *layer.in_hw, layer.cin, generator=g).to(dev)
    w = torch.randn(layer.k, layer.k, layer.cin, layer.cout, generator=g)
    w = (w / (layer.k * layer.k * layer.cin) ** 0.5).to(dev)
    bias = (torch.randn(layer.cout, generator=g) * 0.1).to(dev)
    pads = same_deconv_pads(layer.k, layer.s)
    pw = sd.plan(w.shape, layer.s, pads, backend="winograd",
                 act="relu").bind(w, bias=bias)
    pf = sd.plan(w.shape, layer.s, pads, backend="fused",
                 act="relu").bind(w, bias=bias)
    out, ref = _wino_pair(x, pw)
    _gate(out, ref)
    k1 = sd.execute(pf, x)
    torch.cuda.synchronize()
    assert (out - k1).abs().max().item() <= \
        tolerance(pw.kt) * max(1.0, k1.abs().max().item())


@pytest.mark.parametrize("act", ["linear", "relu", "tanh"])
def test_wino_dcgan_layers_bf16(dev, act):
    for _, layer in PAPER_LAYERS[:3]:
        g = torch.Generator().manual_seed(layer.cout)
        x = torch.randn(2, *layer.in_hw, layer.cin, generator=g)
        w = torch.randn(layer.k, layer.k, layer.cin, layer.cout, generator=g)
        w /= (layer.k * layer.k * layer.cin) ** 0.5
        p = sd.plan(w.shape, layer.s, same_deconv_pads(layer.k, layer.s),
                    backend="winograd", act=act).bind(
                        w.to(dev, torch.bfloat16),
                        bias=(0.1 * torch.randn(layer.cout, generator=g)
                              ).to(dev))
        assert p.ws.dtype == torch.bfloat16
        out, ref = _wino_pair(x.to(dev, torch.bfloat16), p)
        assert (out - ref).abs().max().item() <= \
            1e-2 * ref.abs().max().item()


@pytest.mark.parametrize("sx,sw,s,pad,op,tile", [
    ((2, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1, None),          # op > pad_hi
    ((1, 6, 7, 3), (5, 5, 3, 2), 2, ((1, 3), (0, 2)), 0, None),
    ((2, 7, 6, 4), (5, 5, 4, 3), 3, 2, 0, None),          # k5/s3
    ((2, 7, 6, 4), (6, 6, 4, 3), 3, 2, 2, None),          # k6/s3
    ((2, 7, 6, 4), (7, 7, 4, 3), 4, 3, 0, None),          # k7/s4
    ((2, 7, 6, 4), (2, 2, 4, 3), 2, 0, 0, None),          # taps 1
    ((1, 5, 6, 3), (5, 2, 3, 2), 2, ((2, 2), (0, 1)), 0, None),
    ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1,
     WinoPlan(nth=3, ntw=2, nb=2, tc=16)),                # ragged bands
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
     WinoPlan(nth=2, ntw=3, nb=2, tc=32)),                # Cin 70, tc 32
    ((2, 9, 7, 12), (5, 5, 12, 6), 1, 2, 0,
     WinoPlan(nth=3, ntw=1, nb=2, tc=16)),                # F(2,5), odd
])
def test_wino_odd_geometries(dev, sx, sw, s, pad, op, tile):
    from repro_torch.kernels.winograd import tolerance
    g = torch.Generator().manual_seed(2)
    x = torch.randn(sx, generator=g).to(dev)
    w = (torch.randn(sw, generator=g) * 0.2).to(dev)
    bias = torch.randn(sw[-1], generator=g).to(dev)
    p = sd.plan(w.shape, s, pad, backend="winograd", act="tanh",
                output_padding=op, tile=tile).bind(w, bias=bias)
    out, ref = _wino_pair(x, p)
    assert (out - ref).abs().max().item() <= 1e-4
    k1 = sd.execute(sd.plan(w.shape, s, pad, backend="fused", act="tanh",
                            output_padding=op).bind(w, bias=bias), x)
    assert (out - k1).abs().max().item() <= tolerance(p.kt)


def test_wino_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.winograd import sd_wino, transform_filters
    x = torch.randn(1, 4, 4, 3, device=dev)
    u = transform_filters(torch.randn(2, 2, 3, 8, device=dev))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sd_wino(x.to(torch.int8), u.to(torch.int8), (2, 2), 2)
    with pytest.raises(TypeError, match="dtype"):
        sd_wino(x, u.bfloat16(), (2, 2), 2)
    with pytest.raises(ValueError, match="contiguous"):
        sd_wino(x.transpose(1, 2), u, (2, 2), 2)
    with pytest.raises(ValueError, match="shapes"):
        sd_wino(x, u, (3, 3), 2)
    with pytest.raises(ValueError, match="unsupported"):
        sd_wino(x, u, (6, 6), 2)


def test_wino_server_runs_k4_only(dev):
    """A winograd server launches K4 once per deconv layer and K1 never,
    and serves what the fused server serves (tolerance((3, 3)))."""
    from repro_torch.kernels import winograd as W
    from repro_torch.kernels.winograd import tolerance
    from repro_torch.launch.serve_gen import GenServer, reduced_specs
    specs = reduced_specs()
    wino = GenServer(nets=("dcgan-dryrun",), specs=specs, device=dev,
                     backend="winograd", max_batch=4)
    fused = GenServer(nets=("dcgan-dryrun",), specs=specs, device=dev,
                      backend="fused", max_batch=4)
    zs = [r.latent for r in wino.random_requests("dcgan-dryrun", 4)]
    ref = fused.run_group("dcgan-dryrun", zs)
    k1, k4 = K.SD_FUSED_LAUNCHES, W.SD_WINO_LAUNCHES
    out = wino.run_group("dcgan-dryrun", zs)
    torch.cuda.synchronize()
    assert (K.SD_FUSED_LAUNCHES - k1, W.SD_WINO_LAUNCHES - k4) == (0, 2)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= \
        tolerance((3, 3)) * ref.abs().max().item()



# ---------------------------------------------------------------------------
# K1's int8 branch (dynamic per-sample scales, f32 out) and the grad guard
# ---------------------------------------------------------------------------

INT8_REL = 1e-6


def _int8_case(dev, sx, sw, s, pad, act, op=0, tile=None, seed=0):
    """(xq, int8 fused plan, comb): the activation quantized per sample,
    the plan bound with a folded BN scale and bias, and the combined
    (B, NC) oc-major dequant scale."""
    from repro_torch.core.quant import quantize_act
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(sx, generator=g)
    w = torch.randn(sw, generator=g) / (sw[0] * sw[1] * sw[2]) ** 0.5
    gamma = torch.rand(sw[-1], generator=g) + 0.5
    bias = torch.randn(sw[-1], generator=g) * 0.1
    p = sd.plan(w.shape, s, pad, backend="fused", act=act,
                output_padding=op, tile=tile, dtype="int8",
                device=dev).bind(w.to(dev), gamma.to(dev), bias.to(dev))
    xq, sxs = quantize_act(x.to(dev))
    return xq, p, (sxs[:, None] * p.wscale[None, :]).contiguous()


def _int8_pair(xq, p, comb, bias, act):
    geo = dict(pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
               crop=(p.pk[0] + p.padding[0][0], p.pk[1] + p.padding[1][0]),
               out_space=p.out_shape(xq.shape[1:3]))
    before = (K.SD_FUSED_INT8_LAUNCHES, K.SD_FUSED_LAUNCHES)
    out = ops.sd_deconv_presplit_fused(
        xq, p.ws, p.kernel, p.stride, p.padding,
        output_padding=p.output_padding, bias=bias, act=act, scale=comb,
        plan=p.tile)
    assert (K.SD_FUSED_INT8_LAUNCHES, K.SD_FUSED_LAUNCHES) == \
        (before[0] + 1, before[1])
    ref = K.sd_fused_ref(xq, p.ws, p.stride, bias=bias, act=act,
                         scale=comb, **geo)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.float32
    return out, ref


def _int8_gates(xq, p, comb):
    """(a) unit scale, zero bias, linear: bit-identical; (b) the real
    scales, the plan's bias and act: within 1e-6 * max(1, max|ref|)."""
    ones = torch.ones_like(comb)
    zero = torch.zeros_like(p.bias)
    out, ref = _int8_pair(xq, p, ones, zero, "linear")
    assert torch.equal(out, ref)
    out, ref = _int8_pair(xq, p, comb, p.bias, p.act)
    assert (out - ref).abs().max().item() <= \
        INT8_REL * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("net,layer", PAPER_LAYERS,
                         ids=[f"{n}/{l.name}" for n, l in PAPER_LAYERS])
def test_int8_paper_layers(dev, net, layer):
    for act in ("relu", "tanh"):
        _int8_gates(*_int8_case(dev, (4, *layer.in_hw, layer.cin),
                                (layer.k, layer.k, layer.cin, layer.cout),
                                layer.s, same_deconv_pads(layer.k, layer.s),
                                act))


@pytest.mark.parametrize("sx,sw,s,pad,op,tile", [
    ((2, 5, 6, 7), (4, 4, 7, 2), 2, 0, 1, None),      # Cin 7, op > pad_hi
    ((1, 6, 7, 5), (5, 5, 5, 2), 2, ((1, 3), (0, 2)), 0, None),
    ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1,
     GemmPlan(64, 4)),       # Cin 40 (4-byte copies), N 96 over bn 64,
                             # 6 k-tiles in 4 splits (the last empty)
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
     GemmPlan(16, 3)),       # Cin 70 (byte copies), N 20 over bn 16
    ((16, 8, 8, 256), (5, 5, 256, 128), 2, 2, 1, None),   # DCGAN d1, b16
])
def test_int8_odd_geometries(dev, sx, sw, s, pad, op, tile):
    _int8_gates(*_int8_case(dev, sx, sw, s, pad, "relu", op, tile, seed=3))


@pytest.mark.parametrize("plan", [None, GemmPlan(64, 4)])
def test_int8_saturating_d1_exact(dev, plan):
    """Every code at +-127 on DCGAN d1 at batch 16 (K = 3*3*256 = 2,304):
    interior sums reach 127^2 * 2,304 = 37,161,216 in magnitude, and the
    int32 path (split partials and their ordered sum included) is exact
    against an int64 restatement, rounded to f32 once (unit scale, zero
    bias, linear act)."""
    import numpy as np
    g = torch.Generator().manual_seed(7)
    sample = torch.where(torch.rand(16, 1, 1, 1, generator=g) < 0.5, 127,
                         -127)
    column = torch.where(torch.rand(512, generator=g) < 0.5, 127, -127)
    xq = sample.expand(16, 8, 8, 256).to(torch.int8).contiguous()
    ws = column.expand(3, 3, 256, 512).to(torch.int8).contiguous()
    p = sd.plan((5, 5, 256, 128), 2, 2, backend="fused", output_padding=1,
                dtype="int8", device=dev)
    geo = dict(pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
               crop=(p.pk[0] + p.padding[0][0], p.pk[1] + p.padding[1][0]),
               out_space=p.out_shape((8, 8)))
    out = K.sd_fused(xq.to(dev), ws.to(dev), 2,
                     scale=torch.ones(1, 512, device=dev), plan=plan,
                     **geo).cpu()
    (plo_h, phi_h), (plo_w, phi_w) = geo["pad"]
    xp = np.pad(xq.numpy().astype(np.int64),
                ((0, 0), (plo_h, phi_h), (plo_w, phi_w), (0, 0)))
    oh, ow = xp.shape[1] - 2, xp.shape[2] - 2
    acc = np.zeros((16, oh, ow, 512), np.int64)
    for a in range(3):
        for c in range(3):
            acc += np.tensordot(xp[:, a:a + oh, c:c + ow],
                                ws.numpy()[a, c].astype(np.int64), axes=1)
    assert np.abs(acc).max() == 127 * 127 * 2304
    ref = K.shuffle_epilogue(torch.from_numpy(acc.astype(np.float32)), 2,
                             None, "linear", geo["crop"], geo["out_space"],
                             torch.float32)
    assert torch.equal(out, ref)
    assert out.abs().max().item() == float(127 * 127 * 2304)


def test_int8_wrapper_refusals(dev):
    xq = torch.randint(-127, 128, (2, 4, 4, 8), dtype=torch.int8,
                       device=dev)
    ws = torch.randint(-127, 128, (3, 3, 8, 12), dtype=torch.int8,
                       device=dev)
    scale = torch.rand(2, 12, device=dev)
    geo = dict(pad=((2, 2), (2, 2)), crop=(1, 1), out_space=(8, 8))
    # the static row and int8 output launch and equal the plain version
    row = K.sd_fused(xq, ws, 2, scale=scale[:1], **geo)
    assert torch.equal(row, K.sd_fused_ref(xq.cpu(), ws.cpu(), 2,
                                           scale=scale[:1].cpu(),
                                           **geo).to(dev))
    q = K.sd_fused(xq, ws, 2, scale=scale, out_dtype=torch.int8, **geo)
    assert q.dtype == torch.int8 and torch.equal(
        q.cpu(), K.sd_fused_ref(xq.cpu(), ws.cpu(), 2, scale=scale.cpu(),
                                out_dtype=torch.int8, **geo))
    with pytest.raises(ValueError, match="tanh"):
        K.sd_fused(xq, ws, 2, scale=scale, act="tanh",
                   out_dtype=torch.int8, **geo)
    with pytest.raises(TypeError, match="int8"):
        K.sd_fused(xq, ws.float(), 2, scale=scale, **geo)
    with pytest.raises(TypeError, match="float32"):
        K.sd_fused(xq, ws, 2, scale=scale.double(), **geo)
    with pytest.raises(ValueError, match="device"):
        K.sd_fused(xq, ws, 2, scale=scale.cpu(), **geo)
    with pytest.raises(ValueError, match="contiguous"):
        K.sd_fused(xq, ws, 2, scale=scale.t().contiguous().t(), **geo)
    with pytest.raises(ValueError, match="overflow"):
        K.sd_fused(torch.zeros((1, 3, 3, 15_000), dtype=torch.int8,
                               device=dev),
                   torch.zeros((3, 3, 15_000, 4), dtype=torch.int8,
                               device=dev),
                   2, scale=torch.ones(1, 4, device=dev),
                   pad=((2, 2), (2, 2)))


def test_f32_cudnn_convs_ignore_the_tf32_default(dev, monkeypatch):
    """With cuDNN's TF32 default on (the ``dev`` fixture's pin undone),
    the port's own f32 convs stay in full f32, forward and backward: the
    small GAN's generator grads J_G^T c through native
    ``F.conv_transpose2d`` match f64 at 1e-4 of each leaf's max|ref|
    (TF32 reads about 4e-2 there), ``native_deconv``, ``conv_valid`` and
    ``conv_nd`` are within 1e-5 of their f64 results, and the caller's
    flag is left as it was."""
    from repro_torch.core.deconv import conv_nd, conv_valid, native_deconv
    from repro_torch.launch.train_gen import main
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    main(["--small", "--steps", "0", "--deconv-impl", "native",
          "--grad-check", "--device", "cuda"])
    g = torch.Generator().manual_seed(11)
    x = torch.randn(4, 16, 16, 128, generator=g).to(dev)
    w = (torch.randn(5, 5, 128, 64, generator=g) / 40).to(dev)
    for fn in (lambda a, b: native_deconv(a, b, 2, 2, 1),
               lambda a, b: conv_valid(a, b),
               lambda a, b: conv_nd(a, b, 2, "SAME")):
        out, ref = fn(x, w), fn(x.double(), w.double())
        assert (out.double() - ref).abs().max().item() <= \
            1e-5 * max(1.0, ref.abs().max().item())
    assert torch.backends.cudnn.allow_tf32


def test_kernels_refuse_grad_operands(dev):
    """A kernel's output has no graph: under grad mode an operand that
    requires grad raises instead of returning a detached tensor."""
    from repro_torch.kernels.winograd import sd_wino, transform_filters
    x = torch.randn(1, 4, 4, 3, device=dev, requires_grad=True)
    ws = torch.randn(2, 2, 3, 8, device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        K.sd_fused(x, ws, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        K.sd_fused(x.detach(), ws.requires_grad_(True), 2)
    u = transform_filters(ws.detach())
    with pytest.raises(RuntimeError, match="requires grad"):
        sd_wino(x, u, (2, 2), 2)
    with torch.no_grad():
        assert K.sd_fused(x, ws, 2).grad_fn is None
        assert sd_wino(x, u, (2, 2), 2).grad_fn is None


def test_int8_server_runs_int8_k1_only(dev):
    """An int8 server launches K1's int8 branch once per deconv layer and
    float K1 never; its outputs are the card's int8 torch backend's
    (1e-3 * max(1, max|ref|), the reference's fused-vs-xla gate)."""
    from repro_torch.launch.serve_gen import GenServer, reduced_specs
    from repro_torch.models.generative import GenerativeModel
    specs = reduced_specs()
    server = GenServer(nets=("dcgan-dryrun",), specs=specs, device=dev,
                       backend="fused", max_batch=4, dtype="int8")
    zs = [r.latent for r in server.random_requests("dcgan-dryrun", 4)]
    before = (K.SD_FUSED_INT8_LAUNCHES, K.SD_FUSED_LAUNCHES)
    out = server.run_group("dcgan-dryrun", zs)
    torch.cuda.synchronize()
    assert (K.SD_FUSED_INT8_LAUNCHES - before[0],
            K.SD_FUSED_LAUNCHES - before[1]) == (2, 0)
    model, params = server.model("dcgan-dryrun")
    ref_m = GenerativeModel(model.spec, "sd_kernel", engine_backend="torch",
                            device=dev, engine_dtype="int8")
    with torch.no_grad():
        ref = ref_m.apply(params, torch.stack(zs))
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= \
        1e-3 * max(1.0, ref.abs().max().item())


# ---------------------------------------------------------------------------
# K1's int8 branch, calibrated: the static (1, NC) row and int8 output
# ---------------------------------------------------------------------------

DCGAN_LAYERS = BENCHMARKS["dcgan"]().deconv_layers()


@pytest.mark.parametrize("sx,sw,s,pad,op,tile,act,out_int8", [
    ((16, 8, 8, 256), (5, 5, 256, 128), 2, 2, 1, None, "relu", True),
    ((16, 16, 16, 128), (5, 5, 128, 64), 2, 2, 1, None, "relu", True),
    ((16, 32, 32, 64), (5, 5, 64, 3), 2, 2, 1, None, "linear", False),
    ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1,
     GemmPlan(64, 4), "linear", True),
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
     GemmPlan(16, 3), "relu", True),       # Cin 70: byte copies
], ids=["dcgan-d1", "dcgan-d2", "dcgan-d3", "ragged", "tcin9"])
def test_int8_static_row_bit_identical(dev, sx, sw, s, pad, op, tile, act,
                                       out_int8):
    """K1 int8 with a static (1, NC) row (read in place by every sample)
    and, chained, int8 output: bit-identical to its plain version, with
    scales that saturate part of the codes at +-127."""
    xq, p, comb = _int8_case(dev, sx, sw, s, pad, act, op, tile, seed=5)
    row = (comb[:1] * 2000).contiguous()       # next layer's code units
    geo = dict(pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
               crop=(p.pk[0] + p.padding[0][0], p.pk[1] + p.padding[1][0]),
               out_space=p.out_shape(xq.shape[1:3]))
    out_dtype = torch.int8 if out_int8 else None
    before = K.SD_FUSED_INT8_LAUNCHES
    out = ops.sd_deconv_presplit_fused(
        xq, p.ws, p.kernel, p.stride, p.padding,
        output_padding=p.output_padding, bias=p.bias * 50, act=act,
        scale=row, out_dtype=out_dtype, plan=p.tile)
    assert K.SD_FUSED_INT8_LAUNCHES == before + 1
    ref = K.sd_fused_ref(xq, p.ws, p.stride, bias=p.bias * 50, act=act,
                         scale=row, out_dtype=out_dtype, **geo)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == (torch.int8 if out_int8
                                      else torch.float32)
    assert torch.equal(out, ref)
    if out_int8:
        assert int((out.abs() == 127).sum()) > 0


def test_calibrated_server_chains_k1_int8(dev, tmp_path, monkeypatch):
    """The dryrun DCGAN served calibrated on the card: 2 K1-int8 launches
    per batch and no float K1, d1 writes int8 for d2, and the outputs
    equal the card's int8 torch backend with the same scales within
    1e-3 * max(1, max|ref|) (the chained codes agree exactly)."""
    from repro_torch.launch.serve_gen import GenServer, reduced_specs
    from repro_torch.models.generative import GenerativeModel
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE",
                       str(tmp_path / "sd_calib.json"))
    spec = reduced_specs()["dcgan-dryrun"]
    server = GenServer(nets=("dcgan-dryrun",), specs={"dcgan-dryrun": spec},
                       device=dev, backend="fused", max_batch=4,
                       dtype="int8", calib=8)
    zs = [r.latent for r in server.random_requests("dcgan-dryrun", 4)]
    model, params = server.model("dcgan-dryrun")
    plans = model.engine.plans()
    assert plans["d1"].chain_out and not plans["d2"].chain_out
    before = (K.SD_FUSED_INT8_LAUNCHES, K.SD_FUSED_LAUNCHES)
    out = server.run_group("dcgan-dryrun", zs)
    torch.cuda.synchronize()
    assert (K.SD_FUSED_INT8_LAUNCHES - before[0],
            K.SD_FUSED_LAUNCHES - before[1]) == (2, 0)
    ref_m = GenerativeModel(spec, "sd_kernel", engine_backend="torch",
                            device=dev, engine_dtype="int8")
    ref_m.engine.set_calibration({n: p.sx_in.item()
                                  for n, p in model.engine.plans().items()})
    z = torch.stack(zs)
    with torch.no_grad():
        ref = ref_m.apply(params, z)
        h = z @ params["project"]["w"] + params["project"]["b"]
        h = torch.relu(h.reshape(4, 4, 4, 32))
        codes = sd.execute(plans["d1"], h)
        codes_ref = sd.execute(ref_m.engine.plans()["d1"], h)
    assert codes.dtype == torch.int8 and torch.equal(codes, codes_ref)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= \
        1e-3 * max(1.0, ref.abs().max().item())


# ---------------------------------------------------------------------------
# K2's int8 pair and the 3-D lowering (one K2 launch per depth tap).
# ---------------------------------------------------------------------------

VOXGAN_LAYERS = [l for l in WORKLOADS["voxgan"]().deconv_layers()]


def _band(td=1):
    """Depth tap ``td``'s band of a batch-1 5-D input as the 3-D lowering
    hands it to K2 (``xp[:, td:td + od].reshape(od, H, W, Cin)``): a view
    whose base lies ``td*H*W*Cin`` bytes into its storage."""
    def make(t):
        od, h, w, c = t.shape
        full = torch.zeros((1, od + td, h, w, c), dtype=t.dtype,
                           device=t.device)
        full[:, td:] = t
        band = full[:, td:td + od].reshape(od, h, w, c)
        assert band.data_ptr() != full.data_ptr() and band.is_contiguous()
        return band
    return make


def _offset(nbytes):
    """The same values in a contiguous view ``nbytes`` into its storage, so
    that the base is not 16-byte aligned."""
    def make(t):
        buf = torch.empty(t.numel() + nbytes, dtype=t.dtype,
                          device=t.device)
        view = buf[nbytes:].view(t.shape)
        view.copy_(t)
        return view
    return make


@pytest.mark.parametrize("sx,sw,pad,start,size,tile,place", [
    ((6, 4, 4, 64), (2, 2, 64, 256), ((1, 1), (1, 1)), (0, 0), None, None,
     None),
    ((6, 8, 8, 32), (2, 2, 32, 128), ((1, 1), (1, 1)), (0, 0), None, None,
     None),
    ((6, 16, 16, 16), (2, 2, 16, 8), ((1, 1), (1, 1)), (0, 0), None, None,
     None),
    ((2, 5, 6, 3), (3, 3, 3, 5), ((2, 1), (0, 2)), (0, 0), None,
     GemmPlan(16, 3), None),
    ((2, 7, 6, 5), (2, 3, 5, 20), ((1, 1), (1, 1)), (1, 2), (5, 3),
     GemmPlan(32, 2), None),
    ((1, 9, 10, 70), (3, 3, 70, 33), ((1, 1), (1, 1)), (0, 0), None,
     GemmPlan(64, 3), None),
    ((5, 7, 9, 5), (2, 2, 5, 8), ((1, 1), (1, 1)), (0, 0), None, None,
     _band()),
    ((3, 6, 6, 64), (2, 2, 64, 32), ((1, 1), (1, 1)), (0, 0), None,
     GemmPlan(32, 2), _offset(4)),
])
def test_k2_int8_bit_identical_to_plain(dev, sx, sw, pad, start, size,
                                        tile, place):
    """K2's int8 pair against its plain version (exact sums): VoxGAN's
    three tap convs (batch 6 x D_out), odd Cin and Co, ragged windows,
    forced GEMM plans (empty and uneven splits, ragged N), a batch-1 tap
    band with odd Cin and a Cin-64 input whose base is 4 bytes past a
    16-byte boundary (the kernel's copy width follows the real pointer),
    codes at +-127; 0 elements may differ."""
    g = torch.Generator().manual_seed(sum(sx))
    xq = torch.randint(-127, 128, sx, generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, sw, generator=g, dtype=torch.int8)
    xq.view(-1)[::7] = 127
    wq.view(-1)[::5] = -127
    xq, wq = xq.to(dev), wq.to(dev)
    if place is not None:
        xq = place(xq)
    before = K.SD_CONV_INT8_LAUNCHES, K.SD_CONV_LAUNCHES
    out = K.sd_conv(xq, wq, pad=pad, out_start=start, out_size=size,
                    plan=tile)
    assert (K.SD_CONV_INT8_LAUNCHES, K.SD_CONV_LAUNCHES) == (
        before[0] + 1, before[1])
    ref = K.sd_conv_ref(xq, wq, pad, start, size)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and out.shape == ref.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("layer", VOXGAN_LAYERS,
                         ids=[l.name for l in VOXGAN_LAYERS])
@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_fused_3d_matches_torch_backend(dev, layer, dtype):
    """Each full-width VoxGAN layer (batch 2): the lowering makes KT_d = 2
    K2 (or K2-int8) launches and equals the torch backend on the card
    within 1e-5 * max(1, max|ref|) in f32 (TF32 off), exactly in int8."""
    g = torch.Generator().manual_seed(layer.cin)
    x = torch.randn(2, *layer.in_hw, layer.cin, generator=g).to(dev)
    w = (torch.randn(4, 4, 4, layer.cin, layer.cout, generator=g)
         / (64 * layer.cin) ** 0.5).to(dev)
    scale = (1 + 0.1 * torch.randn(layer.cout, generator=g)).to(dev)
    bias = (0.1 * torch.randn(layer.cout, generator=g)).to(dev)
    pads = same_deconv_pads((4,) * 3, (2,) * 3)
    pf, pt = (sd.plan(w.shape, 2, pads, backend=b, act="relu", dtype=dtype,
                      device=dev).bind(w, scale, bias)
              for b in ("fused", "torch"))
    counter = "SD_CONV_INT8_LAUNCHES" if dtype == "int8" else \
        "SD_CONV_LAUNCHES"
    before = getattr(K, counter)
    out = sd.execute(pf, x)
    assert getattr(K, counter) - before == 2
    ref = sd.execute(pt, x)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (2, *(2 * n for n in layer.in_hw),
                                      layer.cout)
    if dtype == "int8":
        assert torch.equal(out, ref)
    else:
        assert (out - ref).abs().max().item() <= \
            1e-5 * max(1.0, ref.abs().max().item())


def test_fused_3d_refuses_grad_operands(dev):
    """K2's output has no graph: the 3-D lowering raises for an operand
    that requires grad under grad mode (int8 tensors cannot require
    grad)."""
    x = torch.randn(1, 2, 2, 2, 4, device=dev, requires_grad=True)
    ws = torch.randn(2, 2, 2, 4, 8, device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.sd_deconv_presplit_fused_3d(x, ws, 4, 2, 1)
    with torch.no_grad():
        assert ops.sd_deconv_presplit_fused_3d(x, ws, 4, 2, 1).grad_fn \
            is None


def test_voxgan_server_runs_k2_per_depth_tap(dev):
    """The dryrun VoxGAN served on the card in f32 and int8: 2 layers x 2
    depth taps of K2 (or K2-int8) per batch and nothing of K1; outputs
    equal the torch backend's (f32 1e-5 * max(1, max|ref|), int8 exact)."""
    from repro_torch.launch.serve_gen import GenServer, reduced_specs
    from repro_torch.models.generative import GenerativeModel
    spec = reduced_specs()["voxgan-dryrun"]
    for dtype, counter in (("native", "SD_CONV_LAUNCHES"),
                           ("int8", "SD_CONV_INT8_LAUNCHES")):
        server = GenServer(nets=("voxgan-dryrun",),
                           specs={"voxgan-dryrun": spec}, device=dev,
                           backend="fused", max_batch=4,
                           dtype="int8" if dtype == "int8" else torch.float32)
        zs = [r.latent for r in server.random_requests("voxgan-dryrun", 4)]
        before = (getattr(K, counter), K.SD_FUSED_LAUNCHES,
                  K.SD_FUSED_INT8_LAUNCHES)
        out = server.run_group("voxgan-dryrun", zs)
        torch.cuda.synchronize()
        assert (getattr(K, counter) - before[0], K.SD_FUSED_LAUNCHES
                - before[1], K.SD_FUSED_INT8_LAUNCHES - before[2]) == (4, 0, 0)
        model, params = server.model("voxgan-dryrun")
        ref_m = GenerativeModel(spec, "sd_kernel", engine_backend="torch",
                                device=dev, engine_dtype=dtype)
        with torch.no_grad():
            ref = ref_m.apply(params, torch.stack(zs))
        assert torch.isfinite(out).all()
        if dtype == "int8":
            assert torch.equal(out, ref)
        else:
            assert (out - ref).abs().max().item() <= \
                1e-5 * max(1.0, ref.abs().max().item())


def test_calibrated_voxgan_server_equals_torch_backend(dev, tmp_path,
                                                       monkeypatch):
    """The dryrun VoxGAN served calibrated on the card: 4 K2-int8
    launches per batch, the up1 -> to_vox tensor int8, outputs equal to
    the card's int8 torch backend with the same scales, exactly."""
    from repro_torch.launch.serve_gen import GenServer, reduced_specs
    from repro_torch.models.generative import GenerativeModel
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE",
                       str(tmp_path / "sd_calib.json"))
    spec = reduced_specs()["voxgan-dryrun"]
    server = GenServer(nets=("voxgan-dryrun",),
                       specs={"voxgan-dryrun": spec}, device=dev,
                       backend="fused", max_batch=4, dtype="int8", calib=8)
    zs = [r.latent for r in server.random_requests("voxgan-dryrun", 4)]
    model, params = server.model("voxgan-dryrun")
    assert model.engine.plans()["up1"].chain_out
    before = K.SD_CONV_INT8_LAUNCHES
    out = server.run_group("voxgan-dryrun", zs)
    torch.cuda.synchronize()
    assert K.SD_CONV_INT8_LAUNCHES - before == 4
    ref_m = GenerativeModel(spec, "sd_kernel", engine_backend="torch",
                            device=dev, engine_dtype="int8")
    ref_m.engine.set_calibration({n: p.sx_in.item()
                                  for n, p in model.engine.plans().items()})
    with torch.no_grad():
        ref = ref_m.apply(params, torch.stack(zs))
    assert torch.isfinite(out).all() and torch.equal(out, ref)


# ---------------------------------------------------------------------------
# Rank 1 (WaveGAN): K1, K1 int8, K4, K2 and K3 as H=1 launches.
# ---------------------------------------------------------------------------

WAVEGAN_LAYERS = WORKLOADS["wavegan"]().deconv_layers()


def _wave_case(dev, layer, act, batch=16, dtype="native", tile=None,
               seed=0):
    """A full-width WaveGAN layer at ``batch``: the input and a bound
    rank-1 fused plan (folded BN scale, bias, act)."""
    g = torch.Generator().manual_seed(seed + layer.cin)
    x = torch.randn(batch, *layer.in_hw, layer.cin, generator=g)
    w = torch.randn(layer.k, layer.cin, layer.cout, generator=g) \
        / (layer.k * layer.cin) ** 0.5
    scale = 1 + 0.1 * torch.randn(layer.cout, generator=g)
    bias = 0.1 * torch.randn(layer.cout, generator=g)
    p = sd.plan(w.shape, layer.s, same_deconv_pads((layer.k,), (layer.s,)),
                backend="fused", act=act, dtype=dtype, tile=tile,
                device=dev).bind(w.to(dev), scale.to(dev), bias.to(dev))
    return x.to(dev), p


def _h1_geo(p, length):
    """The H=1 launch's arguments of a rank-1 plan (what
    ``ops.sd_deconv_presplit_fused_1d`` hands K1)."""
    return dict(pad=((0, 0), (p.pi[0],) * 2),
                crop=(0, p.pk[0] + p.padding[0][0]),
                out_space=(1, p.out_shape((length,))[0]))


def _k1_h1_pair(x, p, scale=None, out_dtype=None, bias=None):
    bias = p.bias if bias is None else bias
    quant = x.dtype == torch.int8
    counter = "SD_FUSED_INT8_LAUNCHES" if quant else "SD_FUSED_LAUNCHES"
    before = getattr(K, counter)
    out = ops.sd_deconv_presplit_fused_1d(
        x, p.ws, p.kernel, p.stride, p.padding,
        output_padding=p.output_padding, bias=bias, act=p.act, scale=scale,
        out_dtype=out_dtype, plan=p.tile)
    assert getattr(K, counter) == before + 1
    ref = K.sd_fused_ref(x[:, None], p.ws[None], (1, p.stride[0]),
                         bias=bias, act=p.act, scale=scale,
                         out_dtype=out_dtype, **_h1_geo(p, x.shape[1]))[:, 0]
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert out.is_contiguous()
    return out, ref


@pytest.mark.parametrize("tile", [None, GemmPlan(16, 2), GemmPlan(32, 3),
                                  GemmPlan(64, 5)],
                         ids=["default", "bn16-split2", "bn32-split3",
                              "bn64-split5"])
@pytest.mark.parametrize("layer", WAVEGAN_LAYERS,
                         ids=[l.name for l in WAVEGAN_LAYERS])
def test_wavegan_k1_h1(dev, layer, tile):
    """K1 f32 as an H=1 launch on each full-width WaveGAN layer at batch
    16 (K_T 7 on one axis, 4 phases, to_audio's 4 phase channels), on the
    default plan and forced ones (split-K with an uneven last split),
    within 1e-4 * max(1, max|ref|) of its plain version."""
    act = "tanh" if layer.name == "to_audio" else "relu"
    out, ref = _k1_h1_pair(*_wave_case(dev, layer, act, tile=tile))
    _gate(out, ref)


def test_wavegan_k1_h1_split_k_is_bit_identical(dev):
    x, p = _wave_case(dev, WAVEGAN_LAYERS[0], "relu", tile=GemmPlan(64, 4))
    a, _ = _k1_h1_pair(x, p)
    b, _ = _k1_h1_pair(x, p)
    assert torch.equal(a, b)


@pytest.mark.parametrize("row", ["dynamic", "static"])
@pytest.mark.parametrize("layer", WAVEGAN_LAYERS,
                         ids=[l.name for l in WAVEGAN_LAYERS])
def test_wavegan_k1_int8_h1_bit_identical(dev, layer, row):
    """K1 int8 as an H=1 launch (K = 7 * Cin = 448 / 224 / 112 bytes
    against 64-byte k-tiles): per-sample rows or a static row, f32 out,
    and on up1 / up2 int8 out through relu with saturating codes:
    bit-identical to its plain version."""
    from repro_torch.core.quant import quantize_act
    chain = layer.name != "to_audio"
    x, p = _wave_case(dev, layer, "relu" if chain else "tanh",
                      dtype="int8", seed=1)
    xq, sxs = quantize_act(x)
    comb = (sxs[:, None] * p.wscale[None, :]).contiguous()
    if row == "static":
        comb = comb[:1].contiguous()
    out, ref = _k1_h1_pair(xq, p, comb)
    assert torch.equal(out, ref)
    if chain:
        out, ref = _k1_h1_pair(xq, p, (comb * 2000).contiguous(),
                               torch.int8, p.bias * 50)
        assert torch.equal(out, ref) and int((out.abs() == 127).sum()) > 0


WINO_1D = [(9, 2, 8, 4, 8), (9, 2, 4, 1, 16),        # wavegan-dryrun
           (17, 4, 64, 32, 16), (17, 4, 32, 16, 64),  # WaveGAN's widths
           (17, 4, 16, 1, 256)]                       # at 5 taps


@pytest.mark.parametrize("k,s,cin,cout,length", WINO_1D,
                         ids=[f"k{c[0]}s{c[1]}-{c[2]}x{c[3]}-L{c[4]}"
                              for c in WINO_1D])
def test_wavegan_k4_h1(dev, k, s, cin, cout, length):
    """K4 as an H=1 launch (alphas (1, 6): F(1,1) on the unit axis, the
    loop path of the input transform) at batch 16 against its plain
    version (1e-4 * max(1, max|ref|)) and against K1 on the same split
    filters within tolerance(K_T) * max(1, max|y_K1|)."""
    from repro_torch.kernels import winograd as W
    g = torch.Generator().manual_seed(k + cin)
    x = torch.randn(16, length, cin, generator=g).to(dev)
    w = (torch.randn(k, cin, cout, generator=g) / (k * cin) ** 0.5).to(dev)
    bias = (0.1 * torch.randn(cout, generator=g)).to(dev)
    pads = same_deconv_pads((k,), (s,))
    pw = sd.plan(w.shape, s, pads, backend="winograd", act="relu",
                 device=dev).bind(w, bias=bias)
    pf = sd.plan(w.shape, s, pads, backend="fused", act="relu",
                 device=dev).bind(w, bias=bias)
    kt = (1, pw.kt[0])
    geo = _h1_geo(pw, length)
    assert pw.kt == (5,) and W.wino_launch(
        (16, 1, length, cin), (1, *pw.ws.shape), kt, (1, s), geo["pad"],
        geo["crop"], geo["out_space"]).plan.nth == 1
    before = W.SD_WINO_LAUNCHES
    out = ops.sd_deconv_presplit_wino_1d(x, pw.ws, k, s, pads, bias=bias,
                                         act="relu")
    assert W.SD_WINO_LAUNCHES == before + 1
    ref = W.sd_wino_ref(x[:, None], pw.ws[None], kt, (1, s), bias=bias,
                        act="relu", **geo)[:, 0]
    y1 = sd.execute(pf, x)
    torch.cuda.synchronize()
    _gate(out, ref)
    assert (out - y1).abs().max().item() <= \
        W.tolerance(kt) * max(1.0, y1.abs().max().item())


@pytest.mark.parametrize("layer", WAVEGAN_LAYERS,
                         ids=[l.name for l in WAVEGAN_LAYERS])
def test_wavegan_backward_kernels_h1(dev, layer):
    """K2 (dx) and K3 (dw) as H=1 launches on each full-width WaveGAN
    layer's backward at batch 16, against their plain versions; then
    ``sd.conv_transpose`` on a rank-1 fused plan makes one K2 and one K3
    launch and matches the torch backend's grads at 1e-4."""
    from repro_torch.sd.grad import split_cotangent
    g = torch.Generator().manual_seed(layer.cout)
    p = sd.plan((layer.k, layer.cin, layer.cout), layer.s,
                same_deconv_pads((layer.k,), (layer.s,)), backend="fused",
                device=dev)
    x = torch.randn(16, *layer.in_hw, layer.cin, generator=g).to(dev)
    w = (torch.randn(layer.k, layer.cin, layer.cout, generator=g)
         / (layer.k * layer.cin) ** 0.5).to(dev)
    dy = torch.randn(16, *p.out_shape(layer.in_hw), layer.cout,
                     generator=g).to(dev)
    dy1 = split_cotangent(p, dy)
    ws = sd.split_weights(p, w)
    (kt,), (pi,), (length,) = p.kt, p.pi, layer.in_hw
    w_t = ws[None].flip(0, 1).transpose(-1, -2).contiguous()
    geo = dict(pad=((0, 0), (kt - 1, kt - 1)), out_start=(0, pi),
               out_size=(1, length))
    before = (K.SD_CONV_LAUNCHES, K.SD_FILTER_GRAD_LAUNCHES)
    dx = K.sd_conv(dy1[:, None], w_t, **geo)
    dws = K.sd_filter_grad(x[:, None], dy1[:, None], (1, kt),
                           pad=((0, 0), (pi, pi)))
    assert (K.SD_CONV_LAUNCHES, K.SD_FILTER_GRAD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    _gate(dx, K.sd_conv_ref(dy1[:, None], w_t, **geo))
    _gate(dws, K.sd_filter_grad_ref(x[:, None], dy1[:, None], (1, kt),
                                    pad=((0, 0), (pi, pi))))
    grads = {}
    for backend in ("fused", "torch"):
        pb = sd.plan(w.shape, layer.s, p.padding, backend=backend,
                     device=dev)
        xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = (K.SD_CONV_LAUNCHES, K.SD_FILTER_GRAD_LAUNCHES)
        (sd.conv_transpose(pb, xt, wt) * dy).sum().backward()
        launched = (K.SD_CONV_LAUNCHES - before[0],
                    K.SD_FILTER_GRAD_LAUNCHES - before[1])
        assert launched == ((1, 1) if backend == "fused" else (0, 0))
        grads[backend] = (xt.grad, wt.grad)
    for got, ref in zip(grads["fused"], grads["torch"]):
        assert (got - ref).abs().max().item() <= \
            1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("dtype", ["f32", "int8", "calibrated"])
def test_wavegan_server_runs_k1_per_layer(dev, dtype, tmp_path,
                                          monkeypatch):
    """Full-width WaveGAN served on the card: 3 K1 (or K1-int8) launches
    per batch and nothing else, the outputs the card's torch backend's
    (f32 1e-4, int8 1e-6 of max(1, max|ref|); calibrated with the same
    scales, the chained codes between layers taken as they are)."""
    from repro_torch.kernels import winograd as W
    from repro_torch.launch.serve_gen import GenServer
    from repro_torch.models.generative import GenerativeModel
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE",
                       str(tmp_path / "sd_calib.json"))
    server = GenServer(nets=("wavegan",), device=dev, backend="fused",
                       max_batch=4,
                       dtype=torch.float32 if dtype == "f32" else "int8",
                       calib=8 if dtype == "calibrated" else 0)
    zs = [r.latent for r in server.random_requests("wavegan", 4)]
    model, params = server.model("wavegan")
    names = ("SD_FUSED_LAUNCHES", "SD_FUSED_INT8_LAUNCHES",
             "SD_CONV_LAUNCHES", "SD_CONV_INT8_LAUNCHES",
             "SD_FILTER_GRAD_LAUNCHES")
    before = [getattr(K, n) for n in names] + [W.SD_WINO_LAUNCHES]
    out = server.run_group("wavegan", zs)
    torch.cuda.synchronize()
    after = [getattr(K, n) for n in names] + [W.SD_WINO_LAUNCHES]
    want = [3, 0, 0, 0, 0, 0] if dtype == "f32" else [0, 3, 0, 0, 0, 0]
    assert [a - b for a, b in zip(after, before)] == want
    ref_m = GenerativeModel(model.spec, "sd_kernel", engine_backend="torch",
                            device=dev,
                            engine_dtype="native" if dtype == "f32"
                            else "int8")
    if dtype == "calibrated":
        plans = model.engine.plans()
        assert plans["up1"].chain_out and plans["up2"].chain_out
        ref_m.engine.set_calibration({n: p.sx_in.item()
                                      for n, p in plans.items()})
    with torch.no_grad():
        ref = ref_m.apply(params, torch.stack(zs))
    assert out.shape == (4, 1024, 1) and torch.isfinite(out).all()
    rel = 1e-4 if dtype == "f32" else 1e-6
    assert (out - ref).abs().max().item() <= \
        rel * max(1.0, ref.abs().max().item())


# ---------------------------------------------------------------------------
# Measured tiles: autotune.measure, the candidate pools, a pretuned server
# ---------------------------------------------------------------------------

def test_measure_returns_device_ms_below_host_time(dev):
    """``autotune.measure`` on the card reads device time with the host's
    time per call hidden: on DCGAN d3 at batch 16 it is below the wall
    clock per call of back-to-back calls."""
    import time
    from repro_torch.kernels import autotune as A
    layer = PAPER_LAYERS[2][1]
    x, p = _layer(layer, dev, "linear", batch=16)

    def fn():
        return ops.sd_deconv_presplit_fused(x, p.ws, p.kernel, p.stride,
                                            p.padding, bias=p.bias)

    ms = A.measure(fn, device=dev)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / 50
    assert 0.0 < ms < host


def _d1_geoms():
    from repro_torch.engine import SDEngine
    spec = BENCHMARKS["dcgan"]()
    eng = SDEngine(spec, backend="fused", device="cpu")
    return eng, spec.deconv_layers()[0]


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("kind", ["k1", "k1_int8", "k4"])
def test_every_candidate_tile_matches_the_default(dev, kind, batch):
    """Each tile ``pretune`` may time on DCGAN d1 runs and gives the
    default plan's output: f32 (K1, K4) within 1e-5 * max(1, max|ref|),
    int8 bit for bit (exact int32 sums in any split)."""
    from repro_torch.core.quant import quantize_act
    from repro_torch.kernels import autotune as A
    eng, layer = _d1_geoms()
    x, p = _layer(layer, dev, "relu", batch=batch)
    algo = "wino" if kind == "k4" else ""
    dtype = "int8" if kind == "k1_int8" else "native"
    geom = eng.layer_geom(layer, batch, dtype, algo)
    cands = A.candidate_plans(geom)
    assert len(cands) > 1
    if kind == "k4":
        pw = sd.plan(p.kernel + (layer.cin, layer.cout), p.stride,
                     p.padding, backend="winograd", act="relu",
                     device=dev)
        w = torch.randn(*p.kernel, layer.cin, layer.cout,
                        generator=torch.Generator().manual_seed(3))
        pw = pw.bind((w / (25 * layer.cin) ** 0.5).to(dev), bias=p.bias)

        def run(plan):
            return ops.sd_deconv_presplit_wino(
                x, pw.ws, pw.kernel, pw.stride, pw.padding, bias=pw.bias,
                act="relu", plan=plan)
    elif kind == "k1":
        def run(plan):
            return ops.sd_deconv_presplit_fused(
                x, p.ws, p.kernel, p.stride, p.padding, bias=p.bias,
                act="relu", plan=plan)
    else:
        p8 = sd.plan(p.kernel + (layer.cin, layer.cout), p.stride,
                     p.padding, backend="fused", act="relu", dtype="int8",
                     device=dev)
        w = torch.randn(*p.kernel, layer.cin, layer.cout,
                        generator=torch.Generator().manual_seed(4))
        p8 = p8.bind(w.to(dev), bias=p.bias)
        xq, sx = quantize_act(x)
        comb = (sx[:, None] * p8.wscale[None, :]).contiguous()

        def run(plan):
            return ops.sd_deconv_presplit_fused(
                xq, p8.ws, p8.kernel, p8.stride, p8.padding, bias=p8.bias,
                act="relu", scale=comb, plan=plan)
    ref = run(None)
    assert torch.equal(ref, run(A.default_plan(geom)))
    for plan in cands:
        out = run(plan)
        torch.cuda.synchronize()
        if kind == "k1_int8":
            assert torch.equal(out, ref), plan
        else:
            d = (out - ref).abs().max().item()
            assert d <= 1e-5 * max(1.0, ref.abs().max().item()), (plan, d)


def test_pretuned_server_passes_the_phase_12_gates(dev, tmp_path,
                                                   monkeypatch):
    """A full-width f32 DCGAN server pretuned on the card (buckets 1-4):
    6 geometries per layer, launches per batch matching each layer's
    bound backend, outputs against the torch backend (1e-4 of max(1,
    max|ref|) where every layer stayed on K1, else ``WINO_TOL[3]`` of
    max|ref|), ``estimate_ms`` set for every bucket, and a second server
    on the same cache measuring nothing."""
    from repro_torch.kernels import autotune as A
    from repro_torch.kernels import winograd as W
    from repro_torch.launch.serve_gen import GenServer
    from repro_torch.models.generative import GenerativeModel
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE",
                       str(tmp_path / "sd_plans.json"))
    server = GenServer(nets=("dcgan",), device=dev, backend="fused",
                       max_batch=4)
    tuned = server.pretune(iters=1)
    assert len(tuned) == 3 * 3 * 2
    assert all(server.estimate_ms("dcgan", b) is not None
               for b in server.buckets())
    model, params = server.model("dcgan")
    backends = [p.backend for p in model.engine.plans().values()]
    zs = [r.latent for r in server.random_requests("dcgan", 4)]
    before = (K.SD_FUSED_LAUNCHES, W.SD_WINO_LAUNCHES)
    out = server.run_group("dcgan", zs)
    torch.cuda.synchronize()
    assert (K.SD_FUSED_LAUNCHES - before[0],
            W.SD_WINO_LAUNCHES - before[1]) == (
                backends.count("fused"), backends.count("winograd"))
    with torch.no_grad():
        ref = GenerativeModel(model.spec, "sd_kernel",
                              engine_backend="torch",
                              device=dev).apply(params, torch.stack(zs))
    d = (out - ref).abs().max().item()
    if "winograd" in backends:
        assert d <= W.WINO_TOL[3] * ref.abs().max().item()
    else:
        assert d <= 1e-4 * max(1.0, ref.abs().max().item())
    calls = []
    real = A.measure
    monkeypatch.setattr(A, "measure",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    GenServer(nets=("dcgan",), device=dev, backend="fused",
              max_batch=4).pretune(iters=1)
    assert calls == []


def test_k4_bound_server_serves_and_trains_on_the_kernels(dev, tmp_path,
                                                          monkeypatch):
    """A cache whose batch-1 entries make K4 the faster algorithm on
    every DCGAN layer (the measured tiles kept, the ms rewritten) binds
    every layer to K4: each bucket launches the measured ``WinoPlan``,
    a batch launches K4 three times and K1 never, the outputs are within
    ``WINO_TOL[3]`` of the torch backend, and the generator's ``J_G^T
    c`` runs every layer's backward on K2 and K3 within 1e-4 of the
    torch backend in f64 (phase 12 (f))."""
    from repro_torch.kernels import autotune as A
    from repro_torch.kernels import winograd as W
    from repro_torch.launch import train_gen
    from repro_torch.launch.serve_gen import GenServer
    from repro_torch.models.generative import GenerativeModel
    path = str(tmp_path / "sd_plans.json")
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE", path)
    server = GenServer(nets=("dcgan",), device=dev, backend="fused",
                       max_batch=4)
    tuned = server.pretune(iters=1)
    eng = server.model("dcgan")[0].engine
    layers = eng.spec.deconv_layers()
    plans = dict(A.load_cache(path))
    for l in layers:
        for algo, ms in (("", 1.0), ("wino", 0.5)):
            plans[eng.layer_geom(l, 1, algo=algo).key()]["ms"] = ms
    A.save_cache(plans, path)
    sw = GenServer(nets=("dcgan",), device=dev, backend="fused",
                   max_batch=4)
    model, params = sw.model("dcgan")
    assert {p.backend for p in model.engine.plans().values()} == \
        {"winograd"}
    for b in sw.buckets():
        pb = model.engine.plans_for_batch(b)
        for l in layers:
            g = model.engine.layer_geom(l, b, algo="wino")
            assert pb[l.name].tile == tuned[g.key()]
            assert isinstance(pb[l.name].tile, A.WinoPlan)
    zs = [r.latent for r in sw.random_requests("dcgan", 4)]
    before = (K.SD_FUSED_LAUNCHES, W.SD_WINO_LAUNCHES)
    out = sw.run_group("dcgan", zs)
    torch.cuda.synchronize()
    assert (K.SD_FUSED_LAUNCHES - before[0],
            W.SD_WINO_LAUNCHES - before[1]) == (0, 3)
    with torch.no_grad():
        ref = GenerativeModel(model.spec, "sd_kernel",
                              engine_backend="torch",
                              device=dev).apply(params, torch.stack(zs))
    d = (out - ref).abs().max().item()
    assert d <= W.WINO_TOL[3] * ref.abs().max().item()

    gen, disc = train_gen.make_gan(False, "sd_kernel", dev)
    assert {gen._functional_plan(l).backend for l in layers} == {"winograd"}
    gp = train_gen.trainable(gen.init(torch.Generator().manual_seed(0)))
    dp = train_gen.trainable(disc.init(torch.Generator().manual_seed(1)))
    ref_gen = GenerativeModel(gen.spec, "sd_kernel", engine_backend="torch",
                              device=dev)
    z = torch.randn((4, gen.spec.layers[0].cin),
                    generator=torch.Generator().manual_seed(2)).to(dev)
    before = (K.SD_CONV_LAUNCHES, K.SD_FILTER_GRAD_LAUNCHES)
    errs = train_gen.grad_check(gen, ref_gen, disc, gp, dp, z)
    torch.cuda.synchronize()
    assert (K.SD_CONV_LAUNCHES - before[0],
            K.SD_FILTER_GRAD_LAUNCHES - before[1]) == (3, 3)
    assert max(errs.values()) <= 1e-4, errs


# ---------------------------------------------------------------------------
# K5: flash attention
# ---------------------------------------------------------------------------

K5_F32_GATE = 2e-5       # tests/test_flash_attn.py:30, rel. max(1, max|ref|)
K5_BF16_GATE = 1e-2      # rel. max|ref|, the ref in f32 on the bf16 inputs
# bf16, element by element: the kernel sums in f32 and rounds its output
# once (at most 2^-8 |ref|), so |d| <= 2^-7 |ref| + 1e-4 max|ref|
K5_BF16_REL, K5_BF16_FLOOR = 2.0 ** -7, 1e-4


def _k5_case(dev, b, h, hkv, s, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = ((torch.randn(b, n, s, d, generator=g) * 0.3).to(dev, dtype)
               for n in (h, hkv, hkv))
    return q, k, v


K5_SHAPES = [
    (1, 2, 2, 128, 32), (2, 4, 2, 1, 16), (2, 4, 2, 63, 64),
    (1, 4, 1, 65, 128), (1, 4, 2, 2049, 160), (2, 2, 2, 200, 256),
    (1, 3, 3, 97, 40),
    # both kernels' 128-row query tiles and the bf16 kernel's 64-key tile
    # at their edges
    (1, 4, 2, 127, 64), (2, 4, 2, 128, 160), (1, 4, 2, 129, 40),
    (1, 4, 1, 255, 128), (1, 2, 2, 257, 16),
    # the serving grouping (32 q / 8 kv heads of 160), and D 256
    (1, 32, 8, 300, 160), (1, 4, 2, 257, 256)]
# f32 only (bf16's TMA maps refuse rows of 40 or 200 bytes)
K5_F32_SHAPES = [
    # the f32 kernel's 32-key tile at its edges
    (1, 4, 2, 31, 64), (2, 4, 2, 32, 160), (1, 4, 2, 33, 128),
    # its 64-row query tile past F32_WIDE_D at its edges
    (1, 4, 2, 63, 256), (2, 4, 2, 64, 200), (1, 4, 2, 65, 256),
    # head dims not a multiple of 8, zero-filled in shared memory
    (1, 4, 2, 130, 20), (1, 4, 2, 97, 100),
    # D 256 over a long sweep
    (1, 4, 2, 2049, 256)]
K5_CASES = [(dt, c, *shape)
            for dt in (torch.float32, torch.bfloat16)
            for c in (True, False) for shape in K5_SHAPES] + \
    [(torch.float32, c, *shape) for c in (True, False)
     for shape in K5_F32_SHAPES]


def _k5_id(case):
    dt, c, b, h, hkv, s, d = case
    return (f"{'f32' if dt == torch.float32 else 'bf16'}-"
            f"{'causal' if c else 'full'}-{b}x{h}/{hkv}x{s}x{d}")


@pytest.mark.parametrize("dtype,causal,b,h,hkv,s,d", K5_CASES,
                         ids=[_k5_id(c) for c in K5_CASES])
def test_k5_matches_plain(dev, dtype, causal, b, h, hkv, s, d):
    """K5 against flash_attention_ref on the same inputs (grouped heads
    expanded for the oracle), ragged S around both kernels' tiles, D up
    to 256 and, in f32, D not a multiple of 8."""
    import repro_torch.kernels.flash_attn as FA
    q, k, v = _k5_case(dev, b, h, hkv, s, d, dtype, seed=s + d)
    before = FA.FLASH_ATTN_LAUNCHES
    out = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.FLASH_ATTN_LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = FA.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
    diff = (out.float() - ref).abs()
    d_, m = diff.max().item(), ref.abs().max().item()
    tol = K5_F32_GATE * max(1.0, m) if dtype == torch.float32 \
        else K5_BF16_GATE * m
    assert d_ <= tol, (d_, tol)
    if dtype == torch.bfloat16:
        worst = (diff / (K5_BF16_REL * ref.abs() + K5_BF16_FLOOR * m)).max()
        assert worst.item() <= 1.0, worst.item()


def test_k5_reads_and_writes_bshd_views(dev):
    """The LM's layout: (B, S, H, D) activations handed in as transposed
    views; the output comes back with q's strides."""
    import repro_torch.kernels.flash_attn as FA
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 130, 8, 64, generator=g).to(dev)
    k = torch.randn(2, 130, 2, 64, generator=g).to(dev)
    v = torch.randn(2, 130, 2, 64, generator=g).to(dev)
    out = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    torch.cuda.synchronize()
    assert out.stride() == q.transpose(1, 2).stride()
    ref = FA.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2))
    assert (out - ref).abs().max().item() <= K5_F32_GATE * max(
        1.0, ref.abs().max().item())


@pytest.mark.parametrize("layout", ["odd_sequence_stride", "base_off_16"])
def test_k5_f32_takes_4_byte_copies(dev, layout):
    """f32 operands that a 16-byte copy cannot read: a sequence stride of
    126 floats (504 bytes) or a base 4 bytes off a 16-byte boundary; the
    kernel copies them 4 bytes at a time."""
    import repro_torch.kernels.flash_attn as FA
    g = torch.Generator().manual_seed(5)
    if layout == "odd_sequence_stride":
        x = torch.randn(2, 300, 6, 21, generator=g).to(dev)[..., :20]
        q, k, v = (x[:, :, sl].transpose(1, 2)
                   for sl in (slice(0, 4), slice(4, 5), slice(5, 6)))
        assert q.stride(2) * 4 % 16
    else:
        n = 2 * 4 * 160 * 32
        q, k, v = (torch.randn(n + 1, generator=g).to(dev)[1:]
                   .view(2, 4, 160, 32) for _ in range(3))
        assert q.data_ptr() % 16 == 4
    before = FA.FLASH_ATTN_LAUNCHES
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.FLASH_ATTN_LAUNCHES == before + 1
    ref = FA.flash_attention_ref(q, k, v)
    assert (out - ref).abs().max().item() <= K5_F32_GATE * max(
        1.0, ref.abs().max().item())


def test_k5_f32_runs_on_tf32_tensor_cores(dev):
    """The f32 kernel's SASS, read by chip_smoke._sass_counts: its nine
    instantiations (one per head-dim bucket) run on TF32 HMMA
    (mma.sync)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from repro_torch.kernels.build import load
    counts = chip_smoke._sass_counts(load("flash_attn").path,
                                     "flash_attn_kernel")
    assert counts["functions"] == 9 and counts["HMMA_TF32"] > 0, counts


def test_k5_bf16_reads_and_writes_bshd_views(dev):
    """The served LM's layout in bf16: the TMA maps walk (B, S, H, D)
    activations through their transposed views (head stride below the
    sequence stride), and the output comes back with q's strides."""
    import repro_torch.kernels.flash_attn as FA
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 300, n, 160, generator=g).to(dev,
                                                           torch.bfloat16)
               for n in (8, 2, 2))
    out = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    torch.cuda.synchronize()
    assert out.stride() == q.transpose(1, 2).stride()
    ref = FA.flash_attention_ref(*(t.transpose(1, 2).float()
                                   for t in (q, k, v)))
    diff = (out.float() - ref).abs()
    m = ref.abs().max().item()
    assert diff.max().item() <= K5_BF16_GATE * m
    assert (diff / (K5_BF16_REL * ref.abs() + K5_BF16_FLOOR * m)).max() \
        .item() <= 1.0


def test_k5_refuses_what_it_does_not_take(dev):
    import repro_torch.kernels.flash_attn as FA
    q = torch.randn(1, 2, 8, 272, device=dev)
    with pytest.raises(ValueError, match="head dim 272"):
        FA.flash_attention(q, q, q)
    q = torch.randn(1, 2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="tile"):
        FA.flash_attention(q, q, q, bq=32, bk=32)
    with pytest.raises(ValueError, match="tile"):
        FA.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                           bq=32, bk=32)
    # bf16 operands go through TMA: a 40-byte row stride is refused
    qb = torch.randn(1, 2, 8, 20, device=dev).bfloat16()
    with pytest.raises(ValueError, match="sequence stride"):
        FA.flash_attention(qb, qb, qb)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="Sq == Sk"):
        FA.flash_attention(q[:, :, :5], q, q)
    with pytest.raises(RuntimeError, match="requires grad"):
        FA.flash_attention(q.requires_grad_(), q, q)


def test_lm_prefill_through_k5_matches_the_scan(dev, monkeypatch):
    """Reduced StableLM-2-12B on the card, a 2,080-token prompt: one K5
    launch per layer, last-token logits within 1e-4 * max(1, max|ref|)
    of the same LM with blockwise_attention held to its plain scan."""
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.models import layers as L
    from repro_torch.models.lm import build_lm
    cfg = get("stablelm-12b").reduced()
    lm = build_lm(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 2080),
                         generator=torch.Generator().manual_seed(1))
    toks = toks.to(dev, torch.int32)
    with torch.no_grad():
        before = FA.FLASH_ATTN_LAUNCHES
        out, _ = lm.prefill(params, {"inputs": toks},
                            lm.init_cache(2, 2096))
        torch.cuda.synchronize()
        assert FA.FLASH_ATTN_LAUNCHES - before == cfg.n_layers
        monkeypatch.setattr(L, "_in_k5_contract", lambda *a: False)
        ref, _ = lm.prefill(params, {"inputs": toks},
                            lm.init_cache(2, 2096))
        assert FA.FLASH_ATTN_LAUNCHES - before == cfg.n_layers
    assert (out - ref).abs().max().item() <= 1e-4 * max(
        1.0, ref.abs().max().item())
