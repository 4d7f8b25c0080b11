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
split, Cin not a multiple of 4, bf16) and split-K twice, bit-identical.
K4 (Winograd) is held to the same gates against its plain version
``sd_wino_ref``, and against K1 on the same split filters at the
reference's ``tolerance(K_T) * max(1, max|y_K1|)``. K1's int8 branch is
held to its plain version (``sd_fused_ref`` on the int8 pair, exact
sums) at two gates: bit-identical at unit scale, zero bias and linear
act, and ``1e-6 * max(1, max|y_ref|)`` with real per-sample scales,
folded-BN filter scales, bias and relu/tanh. K2's int8 pair is
bit-identical to its plain version (exact int32 sums); the 3-D lowering
(one K2 launch per depth tap) equals the card's ``torch`` backend within
``1e-5 * max(1, max|y_ref|)`` in f32 and exactly in int8. K1 int8's
calibrated half (a static (1, NC) scale row, int8 output) is
bit-identical to its plain version on saturating scales, and the
calibrated servers (DCGAN on K1 int8, VoxGAN on K2 int8) chain int8
between layers and equal the card's int8 ``torch`` backend. K1, K4 and
the 3-D lowering refuse an operand that requires grad under grad mode.
K5 (flash attention) is held to ``flash_attention_ref`` at ``2e-5 *
max(1, max|ref|)`` in f32 (``tests/test_flash_attn.py``'s tolerance) and
``1e-2 * max|ref|`` in bf16 (the oracle in f32 on the bf16 inputs), and
each bf16 element within ``2^-7 * |ref| + 1e-4 * max|ref|``, on ragged
sequences around both kernels' tiles, grouped heads and D up to 256; the
reduced LM's prefill through K5 matches the plain scan.
"""

import pytest
import torch

from repro_torch.core.accounting import BENCHMARKS, WORKLOADS
from repro_torch.core.deconv import same_deconv_pads
from repro_torch import sd
import repro_torch.kernels.sd_conv as K
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import GemmPlan, KernelPlan

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
    from repro_torch.kernels.autotune import FilterGradPlan
    from repro_torch.core.accounting import LayerSpec
    layer = LayerSpec("deconv", 70, 5, k=5, s=2, in_hw=(13, 11), name="odd")
    x, ws, dy1, p = _backward_case(layer, dev, batch=3, seed=4)
    _gate(*_k2_pair(dy1, ws, p, layer.in_hw, GemmPlan(16, 5)))
    for plan in (FilterGradPlan(tco=16, chunk=32),     # many chunks
                 FilterGradPlan(tco=32, chunk=10 ** 6)):   # one chunk
        _gate(*_k3_pair(x, dy1, p, plan))
    # K3 is deterministic: two runs agree bit for bit.
    a, _ = _k3_pair(x, dy1, p)
    b, _ = _k3_pair(x, dy1, p)
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
     KernelPlan(th=3, tw=4, tcin=7, tc=16)),              # ragged tiles
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
     KernelPlan(th=2, tw=3, tcin=8, tc=4)),               # tcin ragged
    ((2, 9, 7, 12), (5, 5, 12, 6), 1, 2, 0,
     KernelPlan(th=3, tw=1, tcin=5, tc=8)),               # F(2,5), odd
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
     KernelPlan(th=3, tw=2, tcin=12, tc=32)),          # ragged tiles
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
     KernelPlan(th=2, tw=3, tcin=9, tc=16)),           # tcin 9: tail words
    ((16, 8, 8, 256), (5, 5, 256, 128), 2, 2, 1, None),   # DCGAN d1, b16
])
def test_int8_odd_geometries(dev, sx, sw, s, pad, op, tile):
    _int8_gates(*_int8_case(dev, sx, sw, s, pad, "relu", op, tile, seed=3))


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
     KernelPlan(th=3, tw=2, tcin=12, tc=32), "linear", True),
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
     KernelPlan(th=2, tw=3, tcin=9, tc=16), "relu", True),
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


@pytest.mark.parametrize("sx,sw,pad,start,size,tile", [
    ((6, 4, 4, 64), (2, 2, 64, 256), ((1, 1), (1, 1)), (0, 0), None, None),
    ((6, 8, 8, 32), (2, 2, 32, 128), ((1, 1), (1, 1)), (0, 0), None, None),
    ((6, 16, 16, 16), (2, 2, 16, 8), ((1, 1), (1, 1)), (0, 0), None, None),
    ((2, 5, 6, 3), (3, 3, 3, 5), ((2, 1), (0, 2)), (0, 0), None,
     KernelPlan(th=2, tw=3, tcin=3, tc=16)),
    ((2, 7, 6, 5), (2, 3, 5, 20), ((1, 1), (1, 1)), (1, 2), (5, 3),
     KernelPlan(th=3, tw=2, tcin=2, tc=16)),
    ((1, 9, 10, 70), (3, 3, 70, 33), ((1, 1), (1, 1)), (0, 0), None,
     KernelPlan(th=4, tw=3, tcin=9, tc=32)),
])
def test_k2_int8_bit_identical_to_plain(dev, sx, sw, pad, start, size,
                                        tile):
    """K2's int8 pair against its plain version (exact sums): VoxGAN's
    three tap convs (batch 6 x D_out), odd Cin, ragged windows, forced
    tiles, codes at +-127; 0 elements may differ."""
    g = torch.Generator().manual_seed(sum(sx))
    xq = torch.randint(-127, 128, sx, generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, sw, generator=g, dtype=torch.int8)
    xq.view(-1)[::7] = 127
    wq.view(-1)[::5] = -127
    xq, wq = xq.to(dev), wq.to(dev)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (1, 2, 2, 128, 32), (2, 4, 2, 1, 16), (2, 4, 2, 63, 64),
    (1, 4, 1, 65, 128), (1, 4, 2, 2049, 160), (2, 2, 2, 200, 256),
    (1, 3, 3, 97, 40),
    # the bf16 kernel's 128-row query tile and 64-key tile at their edges
    (1, 4, 2, 127, 64), (2, 4, 2, 128, 160), (1, 4, 2, 129, 40),
    (1, 4, 1, 255, 128), (1, 2, 2, 257, 16),
    # the serving grouping (32 q / 8 kv heads of 160), and D 256
    (1, 32, 8, 300, 160), (1, 4, 2, 257, 256)])
def test_k5_matches_plain(dev, dtype, causal, b, h, hkv, s, d):
    """K5 against flash_attention_ref on the same inputs (grouped heads
    expanded for the oracle), ragged S around both kernels' tiles, D up
    to 256."""
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
