"""The fused split-deconv CUDA kernel against its plain version, on the card.

Marked ``cuda``: each test decides inside itself whether a card is
present and skips, with the reason, where there is none.  On a machine
with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider \\
        tests/test_torch_kernels_cuda.py

f32 gate ``max|d| <= 1e-4 * max(1, max|y_ref|)`` with TF32 off (the
kernel accumulates in plain f32 FMA, the plain version through cuDNN in
another order); bf16 gate ``1e-2 * max|y_ref|`` (both accumulate in f32,
so the difference is the bf16 rounding of the output).
"""

import pytest
import torch

from repro_torch.core.accounting import BENCHMARKS
from repro_torch.core.deconv import same_deconv_pads
from repro_torch import sd
import repro_torch.kernels.sd_conv as K
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import KernelPlan

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
     KernelPlan(th=3, tw=2, tcin=16, tc=32)),              # ragged tiles
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
     KernelPlan(th=2, tw=3, tcin=8, tc=16)),              # tcin ragged
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
        K.sd_fused(x.to(torch.int8), ws.to(torch.int8), 2)
    with pytest.raises(TypeError, match="dtype"):
        K.sd_fused(x, ws.bfloat16(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.sd_fused(x.transpose(1, 2), ws, 2)
