"""The port's split-deconv array code against the JAX reference.

Same inputs (numpy, from a seed) through ``repro.core.deconv`` and
``repro_torch.core.deconv``: the filter split and its inverse, the
pixel shuffle, presplit SD, the native transposed conv and the plain
conv (TF "SAME" pads included), on all 22 deconv layers of the paper's
six networks and on the odd geometries of ``tests/test_sd_nd.py``.
f32 gate: the reference's own ``rtol=atol=1e-5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deconv as J
from repro.core.accounting import BENCHMARKS
from repro_torch.core import deconv as T

TOL = dict(rtol=1e-5, atol=1e-5)

PAPER_LAYERS = [(net, l) for net, fn in BENCHMARKS.items()
                for l in fn().deconv_layers()]
PAPER_IDS = [f"{net}/{l.name}" for net, l in PAPER_LAYERS]

# (x shape, w shape, stride, padding, output_padding)
ODD = [
    ((2, 16, 8), (25, 8, 4), 4, J.same_deconv_pads((25,), (4,)), 0),
    ((2, 9, 3), (5, 3, 2), 2, 1, 0),
    ((1, 7, 2), (4, 2, 3), 3, ((2, 1),), 0),        # asymmetric, K % s
    ((1, 10, 3), (5, 3, 2), 3, 1, 2),               # 1-D, op > pad_hi
    ((1, 5, 6, 3), (4, 4, 3, 2), 2, 1, (1, 0)),     # per-dim op
    ((1, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1),          # op past support
    ((1, 6, 7, 3), (5, 5, 3, 2), 2, ((1, 3), (0, 2)), 0),   # asymmetric
    ((1, 6, 7, 3), (5, 5, 3, 2), 1, 2, 0),          # stride 1
    ((1, 3, 4, 5, 2), (3, 3, 3, 2, 3), 2, 1, 0),    # 3-D, K % s == 1
    ((1, 3, 4, 4, 2), (4, 4, 4, 2, 2), 2, 1, 1),    # 3-D with op
]


def _data(shape_x, shape_w, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_x).astype(np.float32),
            (rng.randn(*shape_w) / np.sqrt(np.prod(shape_w[:-1])))
            .astype(np.float32))


def _both(fn_j, fn_t, *arrays, **kw):
    ref = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays], **kw))
    out = fn_t(*[torch.from_numpy(a) for a in arrays], **kw).numpy()
    return out, ref


def _paper_case(layer, batch=2, seed=0):
    x, w = _data((batch, *layer.in_hw, layer.cin),
                 (layer.k, layer.k, layer.cin, layer.cout), seed)
    return x, w, layer.s, J.same_deconv_pads(layer.k, layer.s)


@pytest.mark.parametrize("net,layer", PAPER_LAYERS, ids=PAPER_IDS)
def test_paper_layer_split_and_sd(net, layer):
    x, w, s, pads = _paper_case(layer)
    ws, ws_ref = _both(J.split_filters, T.split_filters, w, stride=s)
    np.testing.assert_array_equal(ws, ws_ref)
    back = T.unsplit_filters(torch.from_numpy(ws), (layer.k,) * 2, s)
    np.testing.assert_array_equal(back.numpy(), w)
    out = T.sd_deconv_presplit(torch.from_numpy(x), torch.from_numpy(ws),
                               (layer.k,) * 2, s, pads).numpy()
    ref = np.asarray(J.sd_deconv_presplit(jnp.asarray(x),
                                          jnp.asarray(ws_ref),
                                          (layer.k,) * 2, s, pads))
    assert out.shape == ref.shape == (2, *layer.out_hw(), layer.cout)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("net,layer", PAPER_LAYERS[:6],
                         ids=PAPER_IDS[:6])
def test_paper_layer_native(net, layer):
    x, w, s, pads = _paper_case(layer, seed=1)
    out, ref = _both(lambda a, b: J.native_deconv(a, b, s, pads),
                     lambda a, b: T.native_deconv(a, b, s, pads), x, w)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("case", ODD, ids=[str(c[:2]) for c in ODD])
def test_odd_geometries(case):
    sx, sw, s, pad, op = case
    x, w = _data(sx, sw, seed=sum(sw))
    ref = np.asarray(J.native_deconv(jnp.asarray(x), jnp.asarray(w), s,
                                     pad, output_padding=op))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(
        T.native_deconv(tx, tw, s, pad, output_padding=op).numpy(), ref,
        **TOL)
    np.testing.assert_allclose(
        T.sd_deconv(tx, tw, s, pad, output_padding=op).numpy(), ref, **TOL)
    rank = len(sx) - 2
    ws = np.asarray(J.split_filters(jnp.asarray(w), s))
    np.testing.assert_array_equal(T.split_filters(tw, s).numpy(), ws)
    y = np.random.RandomState(3).randn(
        2, *([3] * rank), ws.shape[-1]).astype(np.float32)
    st = T._ntuple(s, rank)
    np.testing.assert_array_equal(
        T.depth_to_space(torch.from_numpy(y), st).numpy(),
        np.asarray(J.depth_to_space(jnp.asarray(y), st)))
    assert T.deconv_output_shape(sx[1:-1], sw[:-2], s, pad, op) == \
        J.deconv_output_shape(sx[1:-1], sw[:-2], s, pad, op)


def test_geometry_helpers_match():
    for k, s in [(5, 2), (4, 2), (3, 2), (5, 1), (7, 3), ((25,), (4,)),
                 ((4, 4, 4), (2, 2, 2))]:
        assert T.sd_geometry(k, s) == J.sd_geometry(k, s)
        assert T.same_deconv_pads(k, s) == J.same_deconv_pads(k, s)


def test_validation_matches_reference():
    x, w = _data((1, 4, 3), (4, 3, 2), 0)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="output_padding"):
        T.native_deconv(tx, tw, 2, 1, output_padding=3)
    with pytest.raises(ValueError, match="too large"):
        T.sd_deconv(tx, tw, 2, 4)


# (x shape, w shape, stride, padding) of the models' plain convs,
# including mde e1 (k7/s2, TF SAME pads (2, 3)) and fst c1 (k9/s1).
CONVS = [
    ((1, 256, 512, 3), (7, 7, 3, 4), 2, "SAME"),
    ((1, 64, 64, 3), (9, 9, 3, 4), 1, "SAME"),
    ((2, 8, 8, 3), (4, 4, 3, 5), 2, "SAME"),
    ((2, 9, 9, 3), (3, 3, 3, 4), 2, "SAME"),
    ((2, 8, 8, 3), (3, 3, 3, 5), 1, 1),
    ((2, 9, 3), (3, 3, 4), 2, "SAME"),
]


@pytest.mark.parametrize("case", CONVS, ids=[str(c[:2]) for c in CONVS])
def test_conv_nd(case):
    sx, sw, s, pad = case
    x, w = _data(sx, sw, seed=7)
    out, ref = _both(lambda a, b: J.conv_nd(a, b, s, pad),
                     lambda a, b: T.conv_nd(a, b, s, pad), x, w)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)
