"""The implicit GEMM (``csrc/sd_igemm.cuh``) restated in numpy, for the
CPU tests of K1's float and int8 branches and K2 in f32, the 3xTF32
arithmetic that K1, K2, K3 and K4 share, and the int8 path's s8 mma
fragments.

The kernel reads ``A[m, k] = x[b, v + r0 + kh, u + c0 + kw, ci]`` (zero
outside x) with ``m = (b*MH + v)*MW + u`` and ``k = (kh*KTw + kw)*Cin +
ci``, multiplies it by the filters read as a K x N matrix, one
``GEMM_BM x bn`` tile per block and one run of whole k-tiles per split
(``GEMM_BK`` deep, ``GEMM_BK_INT8`` for int8), and sums the splits'
partials in split order (exactly, in int64, for int8).

:func:`warp_tile_s8` restates one int8 block's k-tile lane by lane: the
A fragments as ``ldmatrix.x4`` hands them out, the B fragments as each
thread reads its four k-rows of adjacent columns and transposes their
bytes with ``prmt`` (:func:`byte_perm`), the ``m16n8k32`` products in
the PTX fragment layout, and the epilogue's column map.

:func:`tf32` is ``cvt.rna.tf32.f32`` (the kernels' ``igemm::tf32``),
:func:`split` its hi/lo pair, and :func:`mma3` one k-tile's products as
the tensor cores take them: ``lo*hi + hi*lo + hi*hi`` of the split
operands, summed in f64 (the dropped ``lo*lo`` is the whole error of the
products; the mma accumulator's own rounding is not modelled).
"""

import numpy as np

from repro_torch.kernels.autotune import GEMM_BK, GEMM_BK_INT8, GEMM_BM


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


def split_k_product(a, wkn, plan, bk=GEMM_BK):
    """C = A @ W as the kernel blocks it, in k-tiles of ``bk``: every
    ``(m, n, k)`` product taken by exactly one block (``hits == 1``), the
    splits' partial slabs summed in split order (f64 slabs, or int64 for
    integer operands).  Returns (C, number of blocks)."""
    m, k = a.shape
    n = wkn.shape[1]
    k_tiles = -(-k // bk)
    per = -(-k_tiles // plan.splits)
    mt, nt = -(-m // GEMM_BM), -(-n // plan.bn)
    exact = a.dtype.kind == "i" and wkn.dtype.kind == "i"
    part = np.zeros((plan.splits, m, n), np.int64 if exact else np.float64)
    hits = np.zeros((m, n, k), np.int64)
    for z in range(plan.splits):
        ks = slice(min(k, z * per * bk), min(k, (z + 1) * per * bk))
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


def byte_perm(x: int, y: int, s: int) -> int:
    """``__byte_perm`` (``prmt``): byte ``n`` of the result is byte
    ``(s >> 4n) & 7`` of the eight bytes of ``x`` (0-3) and ``y`` (4-7)."""
    src = [(v >> (8 * i)) & 0xFF for v in (x, y) for i in range(4)]
    return sum(src[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _word(b) -> int:
    """Little-endian packing of up to four int8 values, lowest first."""
    u = np.asarray(b, np.int8).view(np.uint8)
    return sum(int(v) << (8 * i) for i, v in enumerate(u))


def _s8(word: int) -> np.ndarray:
    return np.array([(word >> (8 * i)) & 0xFF for i in range(4)],
                    np.uint8).view(np.int8).astype(np.int64)


def _b_frag_s8(bt, nt, row, col):
    """``igemm::b_frag_s8``: register ``h`` of NT n-tiles' B fragments,
    from the four k-rows ``row .. row+3`` of the thread's NT adjacent
    columns ``col .. col+NT-1`` of the K x N tile ``bt``."""
    if nt == 4:
        w = [_word(bt[row + r, col:col + 4]) for r in range(4)]
        t0, t1 = byte_perm(w[0], w[1], 0x5140), byte_perm(w[0], w[1], 0x7362)
        t2, t3 = byte_perm(w[2], w[3], 0x5140), byte_perm(w[2], w[3], 0x7362)
        return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
                byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]
    h = [_word(bt[row + r, col:col + 2]) for r in range(4)]
    u01, u23 = byte_perm(h[0], h[1], 0x5410), byte_perm(h[2], h[3], 0x5410)
    return [byte_perm(u01, u23, 0x6420), byte_perm(u01, u23, 0x7531)]


def _ldmatrix_s8(tile):
    """``igemm::ldmatrix_s8`` on a 16 x 32-byte tile: lane ``l`` names
    row ``(l & 7) + (l & 8)``, byte ``16 * (l >> 4)`` of matrix ``l // 8``;
    lane ``t`` receives row ``t // 4`` of each matrix, bytes ``4 * (t %
    4)`` .. +3.  Returns [lane][register]."""
    regs = [[0] * 4 for _ in range(32)]
    for j in range(4):
        for t in range(32):
            src = 8 * j + t // 4
            r, c = (src & 7) + (src & 8), 16 * (src >> 4) + 4 * (t % 4)
            regs[t][j] = _word(tile[r, c:c + 4])
    return regs


def _mma_s8(acc, a, b):
    """``mma.sync.m16n8k32.row.col.s32.s8.s8.s32`` in the PTX ISA's
    fragment layout: lane (gid, tig) holds A rows gid / gid+8 at k 4*tig
    (+16) in a0-a3, B column gid at k 4*tig (+16) in b0-b1, and C row
    gid (+8), columns 2*tig, 2*tig+1 in c0-c3."""
    am = np.zeros((16, 32), np.int64)
    bm = np.zeros((32, 8), np.int64)
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for r in range(4):
            k = 4 * tig + (16 if r >= 2 else 0)
            am[gid + (8 if r % 2 else 0), k:k + 4] = _s8(a[lane][r])
        for r in range(2):
            bm[4 * tig + 16 * r:4 * tig + 16 * r + 4, gid] = _s8(b[lane][r])
    c = am @ bm
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for e in range(4):
            acc[lane][e] += c[gid + (8 if e >= 2 else 0), 2 * tig + (e & 1)]


def warp_tile_s8(a_tile, b_tile, bn):
    """One int8 block's product of a ``GEMM_BM x GEMM_BK_INT8`` A tile and
    a ``GEMM_BK_INT8 x bn`` B tile, restated lane by lane as
    ``igemm_kernel<int8_t, bn>`` computes it: 4 warps of MT x NT
    m16n8k32 tiles, two k-steps, each product accumulated in int32 and
    stored at the epilogue's column ``c * NT + j`` of the warp.  Returns
    (C int64 ``GEMM_BM x bn``, how often each element was written)."""
    warps_m = 4 if bn == 16 else 2
    warps_n = 4 // warps_m
    wm_rows, wn_cols = GEMM_BM // warps_m, bn // warps_n
    mt, nt = wm_rows // 16, wn_cols // 8
    c = np.zeros((GEMM_BM, bn), np.int64)
    hits = np.zeros((GEMM_BM, bn), np.int64)
    for warp in range(4):
        wm, wn = warp // warps_n, warp % warps_n
        acc = [[[[0] * 4 for _ in range(32)] for _ in range(nt)]
               for _ in range(mt)]
        for kk in range(0, GEMM_BK_INT8, 32):
            a = [_ldmatrix_s8(a_tile[wm * wm_rows + 16 * i:
                                     wm * wm_rows + 16 * i + 16, kk:kk + 32])
                 for i in range(mt)]
            b = [[_b_frag_s8(b_tile, nt, kk + 16 * h + 4 * (lane % 4),
                             wn * wn_cols + nt * (lane // 4))
                  for h in range(2)] for lane in range(32)]
            for i in range(mt):
                for j in range(nt):
                    _mma_s8(acc[i][j], a[i],
                            [[b[lane][0][j], b[lane][1][j]]
                             for lane in range(32)])
        for i in range(mt):
            for j in range(nt):
                for lane in range(32):
                    gid, tig = lane // 4, lane % 4
                    for e in range(4):
                        m = wm * wm_rows + 16 * i + gid + (8 if e >= 2 else 0)
                        n = wn * wn_cols + (2 * tig + (e & 1)) * nt + j
                        v = acc[i][j][lane][e]
                        # the int32 accumulator wraps; the wrapper keeps
                        # every sum below 2^31
                        assert -2 ** 31 <= v < 2 ** 31
                        c[m, n] = v
                        hits[m, n] += 1
    return c, hits
