"""The float kernels' implicit GEMM (``csrc/sd_igemm.cuh``) restated in
numpy, for the CPU tests of K1's float branch and K2 in f32, and the
3xTF32 arithmetic that K1, K2, K3 and K4 share.

The kernel reads ``A[m, k] = x[b, v + r0 + kh, u + c0 + kw, ci]`` (zero
outside x) with ``m = (b*MH + v)*MW + u`` and ``k = (kh*KTw + kw)*Cin +
ci``, multiplies it by the filters read as a K x N matrix, one
``GEMM_BM x bn`` tile per block and one run of whole ``GEMM_BK``-wide
k-tiles per split, and sums the splits' partials in split order.

:func:`tf32` is ``cvt.rna.tf32.f32`` (the kernels' ``igemm::tf32``),
:func:`split` its hi/lo pair, and :func:`mma3` one k-tile's products as
the tensor cores take them: ``lo*hi + hi*lo + hi*hi`` of the split
operands, summed in f64 (the dropped ``lo*lo`` is the whole error of the
products; the mma accumulator's own rounding is not modelled).
"""

import numpy as np

from repro_torch.kernels.autotune import GEMM_BK, GEMM_BM


def tf32(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round the magnitude to 10 mantissa bits,
    ties away from zero (add half of the dropped 13 bits' unit, then
    clear them), the sign kept."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((mag & ~0x1FFF) | (bits & np.int32(-2 ** 31))).view(np.float32)


def split(a):
    """``igemm::split``: hi = tf32(a), lo = tf32(a - hi), both f32."""
    a = np.asarray(a, np.float32)
    hi = tf32(a)
    return hi, tf32(a - hi)


def mma3(a, b):
    """One k-tile's product ``a (m, k) @ b (k, n)`` of f32 operands in
    3xTF32: ``lo*hi + hi*lo + hi*hi`` in f64.  A bf16 operand splits with
    ``lo == 0``, so its pass drops out (K4's two bf16 passes)."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = np.float64
    return (al.astype(f) @ bh.astype(f) + ah.astype(f) @ bl.astype(f)
            + ah.astype(f) @ bh.astype(f))


def promote(total, part):
    """The register sum a k-tile's mma sum is promoted into: f32 adds."""
    return (np.asarray(total, np.float32)
            + np.asarray(part, np.float64).astype(np.float32))


def gather_a(x, kt, r0, c0, mh, mw):
    """A (M, K) as ``load_a`` reads it: each row's sample and tap-(0, 0)
    input position, each column's tap and input channel, zero where the
    input position lies outside x."""
    b, h, wd, cin = x.shape
    kth, ktw = kt
    m = np.arange(b * mh * mw)
    bb, rem = m // (mh * mw), m % (mh * mw)
    v, u = rem // mw, rem % mw
    k = np.arange(kth * ktw * cin)
    tap, ci = k // cin, k % cin
    kh, kw = tap // ktw, tap % ktw
    xr = (v + r0)[:, None] + kh[None, :]
    xc = (u + c0)[:, None] + kw[None, :]
    ok = (xr >= 0) & (xr < h) & (xc >= 0) & (xc < wd)
    a = np.zeros((m.size, k.size), x.dtype)
    a[ok] = x[np.broadcast_to(bb[:, None], ok.shape)[ok], xr[ok], xc[ok],
              np.broadcast_to(ci[None, :], ok.shape)[ok]]
    # The halo reads as zero: the same matrix from an explicitly padded x.
    p = abs(r0) + abs(c0) + mh + mw + kth + ktw
    xp = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
    ref = xp[bb[:, None], xr + p, xc + p, ci[None, :]]
    np.testing.assert_array_equal(a, ref)
    if cin % 4 == 0:
        # A 16-byte copy of 4 consecutive k never crosses a tap.
        assert (tap[0::4] == tap[3::4]).all()
    return a


def split_k_product(a, wkn, plan):
    """C = A @ W as the kernel blocks it: every ``(m, n, k)`` product
    taken by exactly one block (``hits == 1``), the splits' partial slabs
    summed in split order.  Returns (C, number of blocks)."""
    m, k = a.shape
    n = wkn.shape[1]
    k_tiles = -(-k // GEMM_BK)
    per = -(-k_tiles // plan.splits)
    mt, nt = -(-m // GEMM_BM), -(-n // plan.bn)
    part = np.zeros((plan.splits, m, n))
    hits = np.zeros((m, n, k), np.int64)
    for z in range(plan.splits):
        ks = slice(min(k, z * per * GEMM_BK), min(k, (z + 1) * per * GEMM_BK))
        for i in range(mt):
            ms = slice(i * GEMM_BM, min(m, (i + 1) * GEMM_BM))
            for j in range(nt):
                ns = slice(j * plan.bn, min(n, (j + 1) * plan.bn))
                part[z, ms, ns] = a[ms, ks] @ wkn[ks, ns]
                hits[ms, ns, ks] += 1
    assert (hits == 1).all(), "a (m, n, k) product taken != once"
    c = part[0]
    for z in range(1, plan.splits):
        c = c + part[z]
    return c, mt * nt * plan.splits


def shuffle_store(c, b, mh, mw, s, res, out_space, bias, act):
    """K1's epilogue (``ShuffleEpi``): phase channel ``n = oc*sh*sw +
    py*sw + px`` of position ``(v, u)`` lands on output ``(v*sh + py -
    res_h, u*sw + px - res_w)`` when inside; every output element must
    be written exactly once."""
    sh, sw = s
    oh, ow = out_space
    cout = c.shape[1] // (sh * sw)
    y = np.full((b, oh, ow, cout), np.nan)
    m = np.arange(c.shape[0])
    bb, rem = m // (mh * mw), m % (mh * mw)
    v, u = rem // mw, rem % mw
    for n in range(c.shape[1]):
        oc, ph = divmod(n, sh * sw)
        oy = v * sh + ph // sw - res[0]
        ox = u * sw + ph % sw - res[1]
        ok = (oy >= 0) & (oy < oh) & (ox >= 0) & (ox < ow)
        assert np.isnan(y[bb[ok], oy[ok], ox[ok], oc]).all(), "written twice"
        r = c[ok, n] + bias[oc]
        y[bb[ok], oy[ok], ox[ok], oc] = {"linear": r,
                                         "relu": np.maximum(r, 0),
                                         "tanh": np.tanh(r)}[act]
    assert not np.isnan(y).any(), "output element never written"
    return y
