"""The float kernels' shared implicit GEMM (``csrc/sd_igemm.cuh``) on the
CPU: the build key that covers its header, and its 3xTF32 arithmetic.

* ``build._target`` hashes every ``csrc/*.cuh`` with the ``.cu``, so a
  header edit rebuilds the libraries that include it;
* 3xTF32 restated in numpy at DCGAN d1's shapes (K2's dx, K = 4,608;
  K1's forward, K = 2,304): ``cvt.rna.tf32.f32`` emulated on the int32
  view, each operand split ``hi = tf32(a)``, ``lo = tf32(a - hi)``, and
  ``hi*hi + hi*lo + lo*hi`` summed in f64 holds half of the 3-D
  lowering's 1e-5 gate against the f64 product of the f32 operands, where
  one rounding (1xTF32) does not; bf16 operands split with ``lo == 0``.
"""

import numpy as np
import pytest

from repro_torch.kernels import build

GATE = 1e-5          # ND_F32_GATE, the tightest f32 gate on these kernels


def test_build_target_covers_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_bytes(b'#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_bytes(b"// one\n")
    first = build._target("k")
    assert build._target("k") == first             # stable
    (tmp_path / "h.cuh").write_bytes(b"// two\n")
    second = build._target("k")
    assert second != first                         # header bytes
    (tmp_path / "other.cuh").write_bytes(b"\n")
    assert build._target("k") != second            # a new header
    (tmp_path / "k.cu").write_bytes(b'#include "h.cuh"\n// edit\n')
    assert build._target("k") not in (first, second)
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")


def tf32(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round the magnitude to 10 mantissa bits,
    ties away from zero (add half of the dropped 13 bits' unit, then
    clear them), the sign kept."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((mag & ~0x1FFF) | (bits & np.int32(-2 ** 31))).view(np.float32)


def test_tf32_rounding_emulated():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                   # TF32's unit at 1
    vals = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                     -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11],
                    np.float32)
    np.testing.assert_array_equal(
        tf32(vals), np.array([one, one + ulp, one, -(one + ulp),
                              one + 2 * ulp], np.float32))
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    assert (tf32(x).view(np.int32) & 0x1FFF == 0).all()
    assert (np.abs(tf32(x) - x) <= np.abs(x) * 2.0 ** -11).all()


def _split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def _dx_operands(rng):
    """DCGAN d1's dx for one sample: the pixel-unshuffled cotangent's
    patches (8 x 8 positions of the FULL conv, 3 x 3 taps x 512 phase
    channels, zero halo) and the rotated split filters (4,608 x 256)."""
    dy1 = rng.randn(1, 10, 10, 512).astype(np.float32)
    dyp = np.pad(dy1, ((0, 0), (2, 2), (2, 2), (0, 0)))
    a = np.stack([dyp[0, 1 + i:4 + i, 1 + j:4 + j].reshape(-1)
                  for i in range(8) for j in range(8)])
    w = (rng.randn(3 * 3 * 512, 256) / np.sqrt(4608)).astype(np.float32)
    return a, w


def _fwd_operands(rng):
    """DCGAN d1's forward for one sample: the input's patches (9 x 9
    conv positions, 3 x 3 taps x 256 channels) and the oc-major split
    filters (2,304 x 512)."""
    x = rng.randn(1, 8, 8, 256).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 2), (1, 2), (0, 0)))
    a = np.stack([xp[0, i:i + 3, j:j + 3].reshape(-1)
                  for i in range(9) for j in range(9)])
    w = (rng.randn(3 * 3 * 256, 512) / np.sqrt(2304)).astype(np.float32)
    return a, w


@pytest.mark.parametrize("shape", ["k2_dx_d1", "k1_d1"])
def test_3xtf32_holds_the_f32_gate(shape):
    rng = np.random.RandomState(23)
    a, w = (_dx_operands if shape == "k2_dx_d1" else _fwd_operands)(rng)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    limit = GATE * max(1.0, np.abs(ref).max())
    (ah, al), (wh, wl) = _split(a), _split(w)
    f64 = np.float64
    three = (ah.astype(f64) @ wh.astype(f64) + ah.astype(f64) @ wl.astype(f64)
             + al.astype(f64) @ wh.astype(f64))
    one = ah.astype(f64) @ wh.astype(f64)
    share3 = np.abs(three - ref).max() / limit
    share1 = np.abs(one - ref).max() / limit
    print(f"{shape}: K {a.shape[1]}, 3xTF32 {share3:.4f} and 1xTF32 "
          f"{share1:.4f} of the {GATE} gate")
    assert share3 <= 0.5
    assert share1 > 1.0           # one rounding alone would fail the gate


def test_bf16_operands_split_exactly():
    """A bf16 value has 8 mantissa bits: TF32 keeps it, lo is 0, and the
    bf16 branch's single hi*hi pass takes exact products."""
    x = np.random.RandomState(1).randn(4096).astype(np.float32)
    bf16 = (x.view(np.int32) & np.int32(-65536)).view(np.float32)
    hi, lo = _split(bf16)
    np.testing.assert_array_equal(hi, bf16)
    assert not lo.any()
