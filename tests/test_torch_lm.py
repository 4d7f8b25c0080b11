"""The port's dense LM serving path against the JAX package, on the CPU.

Same inputs (numpy seeds), same weights (the reference's ``LM.init``
carried over with ``lm_params_from_numpy``), both packages on the CPU:

* K5's oracle ``flash_attention_ref`` and K5's contract on the CPU (the
  wrapper's CPU path, the oracle) against the reference's oracle and its
  Pallas kernel in interpret mode, at the shapes of
  ``tests/test_flash_attn.py``, within 2e-5 (that file's tolerance);
* ``blockwise_attention``'s plain scan with ``q_offset``, ``kv_len``,
  ``window`` and grouped heads within 1e-5, and its K5 dispatch;
* ``rms_norm``, rope, ``attention_cached`` (prefill at S <= 2048 and S >
  2048, ring-cache decode);
* ``LM.prefill``/``decode_step`` on the reduced StableLM-2-12B: logits
  within ``1e-4 * max(1, max|ref|)``, ``pos`` and ``kpos`` equal;
* ``serve``: identical tokens, including 2,064-token prompts (the
  blockwise branch) and mixed prompt lengths;
* the configs are the reference's, ``build_lm`` builds every one of
  them, full and reduced, and refuses a pattern with an unknown mixer
  kind.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get as jget
from repro.kernels.flash_attn import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.launch.serve import serve as j_serve
from repro.models import layers as JL
from repro.models.lm import build_lm as j_build_lm

from repro_torch.configs import ARCHS, get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attn as FA
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import serve
from repro_torch.models import layers as L
from repro_torch.models.lm import build_lm

from _torch_igemm import mma3, promote, tf32

FLASH_TOL = 2e-5        # tests/test_flash_attn.py:30
SCAN_TOL = 1e-5
LOGIT_TOL = 1e-4        # relative to max(1, max|ref|)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _qkv(b, h, s, d, seed=0, hkv=None, sk=None):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, s, d) * 0.3).astype(np.float32)
    kv = [(rng.randn(b, hkv or h, sk or s, d) * 0.3).astype(np.float32)
          for _ in range(2)]
    return q, kv[0], kv[1]


@pytest.fixture(scope="module")
def reduced():
    cfg = jget("stablelm-12b").reduced()
    jlm = j_build_lm(cfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    tcfg = get("stablelm-12b").reduced()
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jlm, jp, tcfg, tp


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_configs_are_the_reference(name):
    assert dataclasses.asdict(get(name)) == dataclasses.asdict(jget(name))
    assert (dataclasses.asdict(get(name).reduced())
            == dataclasses.asdict(jget(name).reduced()))
    assert set(ARCHS) == set(J_ARCHS)


@pytest.mark.parametrize("name,reduced", [
    ("internvl2-76b", False), ("whisper-small", False),
    ("internvl2-76b", True), ("whisper-small", True)],
    ids=["internvl2-76b", "whisper-small", "internvl2-76b-reduced",
         "whisper-small-reduced"])
def test_build_lm_refuses_what_is_not_a_dense_decoder(name, reduced):
    """The VLM's patch frontend and the encoder-decoder build, full and
    reduced (``tests/test_torch_frontends.py`` holds them against the
    reference); what the port still refuses is a mixer kind outside
    ``a`` / ``m`` / ``x`` / ``s``, here in the same config."""
    cfg = get(name).reduced() if reduced else get(name)
    assert build_lm(cfg, device="cpu").cfg is cfg
    with pytest.raises(NotImplementedError, match=r"mixer kinds \['q'\]"):
        build_lm(dataclasses.replace(cfg, pattern=("q",)), device="cpu")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_build_lm_builds_every_config(name, reduced):
    """All ten configs build in the port, full and reduced (no weights
    drawn), with the reference's repeat count."""
    cfg = get(name).reduced() if reduced else get(name)
    lm = build_lm(cfg, device="cpu")
    assert lm.cfg is cfg
    assert lm.repeats == j_build_lm(jget(name).reduced() if reduced
                                    else jget(name)).repeats


# ---------------------------------------------------------------------------
# K5: oracle and contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, None, 64, 64), (False, None, 64, 64), (True, 16, 48, 48),
    (True, None, 8, 40), (False, 7, 24, 33), (True, 5, 1, 30)])
def test_flash_ref_matches_reference(causal, window, sq, sk):
    q, _, _ = _qkv(2, 3, sq, 16, seed=sq + sk)
    _, k, v = _qkv(2, 3, sk, 16, seed=sk)
    ref = j_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window)
    out = FA.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s,d,bq,bk", [
    (1, 2, 128, 32, 64, 64),
    (2, 3, 256, 64, 64, 128),
    (1, 1, 192, 16, 64, 64),
])
def test_k5_contract_matches_reference_kernel(causal, b, h, s, d, bq, bk):
    """The shapes of tests/test_flash_attn.py::test_flash_matches_ref:
    the wrapper's CPU path against the Pallas kernel in interpret mode."""
    q, k, v = _qkv(b, h, s, d)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, bq=bq, bk=bk)
    before = FA.FLASH_ATTN_LAUNCHES
    out = FA.flash_attention(_t(q), _t(k), _t(v), causal=causal, bq=bq,
                             bk=bk)
    assert FA.FLASH_ATTN_LAUNCHES == before      # the CPU never launches
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


def test_k5_contract_bf16_matches_reference_kernel():
    q, k, v = _qkv(1, 2, 128, 32, seed=3)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    ref = np.asarray(j_flash(jq, jk, jv, causal=True, bq=64, bk=64),
                     np.float32)
    tq, tk, tv = (_t(np.asarray(t, np.float32)).to(torch.bfloat16)
                  for t in (jq, jk, jv))
    out = FA.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    # both sum in f32 and round once to bf16: one bf16 step at most
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d,h,hkv,bq,bk", [
    (1, 16, 2, 2, 64, 64), (63, 16, 4, 2, 64, 64), (65, 32, 4, 1, 64, 64),
    (130, 16, 2, 2, 64, 64), (97, 160, 4, 2, 32, 16), (70, 8, 3, 3, 16, 64)])
def test_k5_ragged_and_grouped_match_reference_oracle(causal, s, d, h, hkv,
                                                      bq, bk):
    """Sequences the kernel's tiles do not divide and grouped kv heads
    through the wrapper's CPU path, against the reference's oracle on
    expanded k/v."""
    q, k, v = _qkv(2, h, s, d, seed=s + d, hkv=hkv)
    g = h // hkv
    ref = j_flash_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, g, 1)),
                      jnp.asarray(np.repeat(v, g, 1)), causal=causal)
    out = FA.flash_attention(_t(q), _t(k), _t(v), causal=causal, bq=bq,
                             bk=bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


def test_k5_contract_refusals():
    q, k, v = (_t(a) for a in _qkv(1, 4, 8, 16, hkv=2))
    with pytest.raises(ValueError, match="divide"):
        FA.flash_attention(q, k[:, :1].repeat(1, 3, 1, 1),
                           v[:, :1].repeat(1, 3, 1, 1))
    with pytest.raises(ValueError, match="shapes"):
        FA.flash_attention(q, k, v[:, :, :4])
    with pytest.raises(TypeError, match="dtypes"):
        FA.flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError, match="positive"):
        FA.flash_attention(q, k, v, bq=0)
    with pytest.raises(ValueError, match="Sq == Sk"):
        FA.flash_attention(q[:, :, :5], k, v)
    FA.flash_attention(q[:, :, :5], k, v, causal=False)


def test_k5_bf16_tma_strides():
    """The bf16 kernel's TMA maps: the LM's (B, S, H, D) views pass with
    their own strides, a size-1 dim's stride is replaced by a valid one,
    and what a map cannot describe is refused before any launch."""
    x = torch.zeros(2, 300, 8, 160, dtype=torch.bfloat16)
    assert FA._tma_strides("q", x.transpose(1, 2)) == (300 * 8 * 160, 160,
                                                        8 * 160)
    one = torch.zeros(1, 1, 5, 40, dtype=torch.bfloat16)[:, :, :1]
    assert FA._tma_strides("k", one) == (40, 40, 40)
    with pytest.raises(ValueError, match="sequence stride"):
        FA._tma_strides("q", torch.zeros(1, 2, 8, 20, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="head stride"):
        FA._tma_strides("v", torch.zeros(1, 4, 3, 20, dtype=torch.bfloat16)
                        .transpose(1, 2)[..., :16])
    with pytest.raises(ValueError, match="16-byte boundary"):
        FA._tma_strides("q", torch.zeros(1, 2, 8, 17, dtype=torch.bfloat16)
                        [..., 1:])


def _k5_bf16_schedule(q, k, v, causal, split):
    """The bf16 kernel's arithmetic restated in torch on the CPU: blocks
    of 128 query rows as two independent 64-row warpgroups, tiles of 128
    keys, f32 scores of the bf16 inputs, one multiply by scale * log2(e)
    and exp2, P split into bf16 hi + lo (``split``) or rounded once to
    bf16, f32 sums, the output rounded once."""
    _, h, sq, d = q.shape
    g, sk, bk = h // k.shape[1], k.shape[2], 128
    c = (1.0 / np.sqrt(d)) * np.log2(np.e)
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    for first in range(0, sq, 64):
        rows = torch.arange(first, min(first + 64, sq))
        m = torch.full((q.shape[0], h, len(rows)), -np.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape[0], h, len(rows), d)
        kend = min(sk, first // 128 * 128 + 128) if causal else sk
        for k0 in range(0, kend, bk):
            if causal and k0 > first + 63:
                continue
            keys = torch.arange(k0, min(k0 + bk, sk))
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(),
                             kf[:, :, keys])
            if causal:
                s = s.masked_fill(keys[None] > rows[:, None], -np.inf)
            m_new = torch.maximum(m, s.amax(-1) * c)
            safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp2(s * c - safe[..., None])
            corr = torch.exp2(m - safe)
            l, m = l * corr + p.sum(-1), m_new
            hi = p.bfloat16().float()
            parts = (hi, (p - hi).bfloat16().float()) if split else (hi,)
            acc = acc * corr[..., None] + sum(
                torch.einsum("bhqk,bhkd->bhqd", x, vf[:, :, keys])
                for x in parts)
        out[:, :, rows] = (acc / l.clamp_min(1e-30)[..., None]).bfloat16()
    return out


@pytest.mark.parametrize("causal,d", [(True, 160), (False, 160),
                                      (False, 16)])
def test_k5_bf16_needs_p_split(causal, d):
    """Why the bf16 kernel splits P: on its schedule, rounding P once to
    bf16 before P.V breaks the element-by-element gate that the card
    holds it to (2^-7 |ref| + 1e-4 max|ref|), and the hi/lo pair holds it
    with the margin of the output's one rounding."""
    gen = torch.Generator().manual_seed(d)
    q, k, v = ((torch.randn(1, n, 257, d, generator=gen) * 0.5).bfloat16()
               for n in (4, 2, 2))
    ref = FA.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
    lim = 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()
    share = {split: ((_k5_bf16_schedule(q, k, v, causal, split).float()
                      - ref).abs() / lim).max().item()
             for split in (True, False)}
    print(f"worst share of the element limit: split {share[True]:.3f}, "
          f"one rounding {share[False]:.3f}")
    assert share[True] <= 0.55 and share[False] > 2.0, share


def _rtz(x):
    """f64 to f32 rounded toward zero: the model here of the tensor
    cores' f32 accumulator, which adds with truncation."""
    y = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _mma(a, b, passes):
    """One k8 step of mma.sync on f32 operands: 3xTF32 (``mma3``) or one
    TF32 rounding of each operand, the products summed in f64."""
    if passes == 3:
        return mma3(a, b)
    return tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)


def _k5_f32_schedule(q, k, v, causal, passes=3, promote_o=False):
    """The f32 kernel's arithmetic restated in numpy: q times the scale in
    f32; per tile of ``F32_TILE[1]`` keys, S over k8 steps of the head dim
    zero-filled to a multiple of 8, each step's products added into the
    f32 accumulator with truncation (:func:`_rtz`); the mask, the online
    softmax in f32 (expf, corr, l); O rescaled by corr in f32 and the
    tile's P V added over k8 steps of keys, either into O itself (the
    kernel: O stays in the mma accumulator) or into a zeroed tile sum
    promoted into O (``promote_o``); O / max(l, 1e-30).  The query tiling
    is left out: rows are independent, and a tile a warp skips above its
    diagonal is all masked, which leaves m, l and O as they are."""
    b, h, sq, d = q.shape
    grp, sk, bk = h // k.shape[1], k.shape[2], FA.F32_TILE[1]
    dp = -(-d // 8) * 8
    pad = ((0, 0), (0, 0), (0, 0), (0, dp - d))
    qs = np.pad(q * np.float32(1.0 / np.sqrt(d)), pad)
    ks = np.pad(np.repeat(k, grp, 1), pad)
    vs = np.repeat(v, grp, 1)
    m = np.full((b, h, sq), -np.inf, np.float32)
    l = np.zeros((b, h, sq), np.float32)
    o = np.zeros((b, h, sq, d), np.float32)
    rows = np.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        nk = min(bk, sk - k0)
        kt = ks[:, :, k0:k0 + nk].swapaxes(-1, -2)
        s = np.zeros((b, h, sq, nk), np.float32)
        for kd in range(0, dp, 8):
            s = _rtz(s + _mma(qs[..., kd:kd + 8], kt[..., kd:kd + 8, :],
                              passes))
        if causal:
            s = np.where(k0 + np.arange(nk)[None] > rows, -np.inf, s)
        m_new = np.maximum(m, s.max(-1))
        safe = np.where(m_new == -np.inf, 0, m_new).astype(np.float32)
        corr = np.where(m == -np.inf, 0, np.exp(m - safe)).astype(np.float32)
        p = np.exp(s - safe[..., None]).astype(np.float32)
        l, m = l * corr + p.sum(-1, dtype=np.float32), m_new
        o = o * corr[..., None]
        part = o if not promote_o else np.zeros_like(o)
        for j in range(0, nk, 8):
            part = _rtz(part + _mma(p[..., j:j + 8],
                                    vs[:, :, k0 + j:k0 + min(j + 8, nk)],
                                    passes))
        o = promote(o, part) if promote_o else part
    return o / np.maximum(l, np.float32(1e-30))[..., None]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [257, 129])
@pytest.mark.parametrize("d", [160, 20, 16])
def test_k5_f32_needs_3xtf32(causal, s, d):
    """Why the f32 kernel splits every operand: on its schedule (key tiles
    of F32_TILE[1], k8 steps, a truncating accumulator), 3xTF32 holds the
    f32 gate that the card holds it to (2e-5 * max(1, max|ref|) against
    flash_attention_ref) and one TF32 rounding of each operand breaks it;
    O chained in the mma accumulator across the key sweep, as the kernel
    keeps it, holds it as well as a per-tile promoted sum.  Grouped heads
    (4 q / 2 kv); D 20 is zero-filled to 24."""
    rng = np.random.RandomState(s + d)
    q, k, v = ((rng.randn(1, n, s, d) * 0.5).astype(np.float32)
               for n in (4, 2, 2))
    ref = FA.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy()
    tol = FLASH_TOL * max(1.0, np.abs(ref).max())
    share = {name: np.abs(_k5_f32_schedule(q, k, v, causal, **kw)
                          - ref).max() / tol
             for name, kw in (("3xtf32", {}),
                              ("promoted", {"promote_o": True}),
                              ("1xtf32", {"passes": 1}))}
    print(f"share of the f32 gate: 3xTF32 {share['3xtf32']:.4f} (O "
          f"promoted per tile {share['promoted']:.4f}), 1xTF32 "
          f"{share['1xtf32']:.2f}")
    assert share["3xtf32"] <= 0.05 and share["promoted"] <= 0.05, share
    assert share["1xtf32"] > 1.0, share


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _bshd(b, s, h, d, seed, hkv=None, sk=None):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, s, h, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, sk or s, hkv or h, d) * 0.3).astype(np.float32)
    v = (rng.randn(b, sk or s, hkv or h, d) * 0.3).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,window,q_offset,kv_len,sq,sk", [
    (True, None, 0, None, 40, 40),
    (True, None, 24, None, 16, 40),
    (True, 12, 0, None, 40, 40),
    (True, None, 0, 29, 40, 40),
    (False, None, 0, 33, 20, 40),
    (True, 9, 17, 35, 8, 40),
    (False, 5, 3, None, 12, 27)])
def test_blockwise_scan_matches_reference(monkeypatch, causal, window,
                                          q_offset, kv_len, sq, sk):
    monkeypatch.setattr(L, "_in_k5_contract", lambda *a: False)
    q, k, v = _bshd(2, sq, 4, 16, seed=sq + sk, hkv=2, sk=sk)
    ref = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, q_offset=q_offset,
                                 kv_len=kv_len, block=16)
    out = L.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                window=window, q_offset=q_offset,
                                kv_len=kv_len, block=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_blockwise_dispatch_depends_on_arguments_alone(monkeypatch):
    """Inside K5's contract (causal, no window, q_offset 0, all keys
    valid, Sq == Sk) blockwise_attention calls K5 (on the CPU its plain
    version); outside it, it runs the scan."""
    calls = []
    real = L.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(L, "flash_attention", spy)
    q, k, v = _bshd(2, 70, 4, 16, seed=1, hkv=2)
    ref = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=None,
                                 q_offset=0, block=16)
    out = L.blockwise_attention(_t(q), _t(k), _t(v), causal=True,
                                window=None, q_offset=0, block=16)
    assert calls == [(2, 4, 70, 16)]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    for kw in (dict(window=8, q_offset=0), dict(window=None, q_offset=3),
               dict(window=None, q_offset=0, kv_len=60)):
        L.blockwise_attention(_t(q), _t(k), _t(v), causal=True, block=16,
                              **kw)
    L.blockwise_attention(_t(q), _t(k), _t(v), causal=False, window=None,
                          q_offset=0, block=16)
    assert len(calls) == 1


def test_rms_norm_and_rope_match_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 4, 16).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    ref = JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    out = L.rms_norm({"scale": _t(scale)}, _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    pos = np.arange(3000, 3009)
    jc, js = JL.rope_tables(jnp.asarray(pos), 16, 1e4)
    tc, ts = L.rope_tables(_t(pos), 16, 1e4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    ref = JL.apply_rope(jnp.asarray(x), jc, js)
    out = L.apply_rope(_t(x), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _attn_params(seed, d_model=64, h=4, hkv=2, hd=16, bias=False):
    rng = np.random.RandomState(seed)
    p = {"wq": rng.randn(d_model, h * hd), "wk": rng.randn(d_model, hkv * hd),
         "wv": rng.randn(d_model, hkv * hd), "wo": rng.randn(h * hd, d_model)}
    p = {k: (w / np.sqrt(w.shape[0])).astype(np.float32)
         for k, w in p.items()}
    if bias:
        p.update(bq=0.1 * rng.randn(h * hd), bk=0.1 * rng.randn(hkv * hd),
                 bv=0.1 * rng.randn(hkv * hd))
        p = {k: w.astype(np.float32) for k, w in p.items()}
    return p


def _cache_np(cache):
    return {k: np.asarray(cache[k]) if not isinstance(cache[k], torch.Tensor)
            else cache[k].numpy() for k in ("k", "v", "kpos")}


@pytest.mark.parametrize("s,w,window,bias", [
    (24, 32, None, False), (32, 32, 8, True), (64, 32, None, False),
    (2056, 2064, None, False), (2056, 2064, 300, True)])
def test_attention_cached_prefill_matches_reference(s, w, window, bias):
    """S <= 2048 (quadratic), S > 2048 (blockwise: K5's contract on the
    CPU without a window, the scan with one), S > W (last W kept)."""
    p = _attn_params(s + w, bias=bias)
    rng = np.random.RandomState(s)
    x = rng.randn(2, s, 64).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=1e4,
              window=window, attn_block=16)
    jcache = {"k": jnp.zeros((2, w, 2, 16)), "v": jnp.zeros((2, w, 2, 16)),
              "kpos": jnp.full((w,), -1, jnp.int32)}
    ref, jnew = JL.attention_cached({k: jnp.asarray(a) for k, a in p.items()},
                                    jnp.asarray(x), jcache, 0, **kw)
    tcache = {"k": torch.zeros(2, w, 2, 16), "v": torch.zeros(2, w, 2, 16),
              "kpos": torch.full((w,), -1, dtype=torch.int32)}
    out, tnew = L.attention_cached({k: _t(a) for k, a in p.items()}, _t(x),
                                   tcache, 0, **kw)
    assert tnew is tcache                      # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * max(1, np.abs(ref).max()))
    jn, tn = _cache_np(jnew), _cache_np(tnew)
    np.testing.assert_array_equal(tn["kpos"], jn["kpos"])
    np.testing.assert_allclose(tn["k"], jn["k"], atol=1e-5)
    np.testing.assert_allclose(tn["v"], jn["v"], atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_cached_ring_decode_matches_reference(window):
    """Prefill 8 tokens into a ring of 8 slots, then 11 decode steps that
    wrap around it."""
    p = _attn_params(7)
    pj = {k: jnp.asarray(a) for k, a in p.items()}
    pt = {k: _t(a) for k, a in p.items()}
    rng = np.random.RandomState(8)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=1e4, window=window,
              attn_block=16)
    w = 8
    jcache = {"k": jnp.zeros((2, w, 2, 16)), "v": jnp.zeros((2, w, 2, 16)),
              "kpos": jnp.full((w,), -1, jnp.int32)}
    tcache = {"k": torch.zeros(2, w, 2, 16), "v": torch.zeros(2, w, 2, 16),
              "kpos": torch.full((w,), -1, dtype=torch.int32)}
    x = rng.randn(2, 8, 64).astype(np.float32)
    _, jcache = JL.attention_cached(pj, jnp.asarray(x), jcache, 0, **kw)
    _, tcache = L.attention_cached(pt, _t(x), tcache, 0, **kw)
    for pos in range(8, 19):
        x = rng.randn(2, 1, 64).astype(np.float32)
        ref, jcache = JL.attention_cached(pj, jnp.asarray(x), jcache, pos,
                                          **kw)
        out, tcache = L.attention_cached(pt, _t(x), tcache, pos, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tcache["kpos"].numpy(),
                                      np.asarray(jcache["kpos"]))


# ---------------------------------------------------------------------------
# the LM and its server
# ---------------------------------------------------------------------------

def _gate(out, ref):
    ref = np.asarray(ref)
    d = np.abs(_np(out) - ref).max()
    assert d <= LOGIT_TOL * max(1.0, np.abs(ref).max()), d


@pytest.mark.parametrize("s,max_len", [(12, 32), (64, 32), (2056, 2064)])
def test_lm_prefill_and_decode_match_reference(reduced, s, max_len):
    """Reduced StableLM-2-12B (2 layers, 4 q / 2 kv heads): prefill (S >
    2048 attends through K5's contract on the CPU; S = 2 W keeps the last
    W positions), then 3 greedy decode steps fed the reference's
    tokens."""
    cfg, jlm, jp, tcfg, tp = reduced
    lm = build_lm(tcfg, device="cpu")
    toks = np.random.RandomState(s).randint(0, cfg.vocab_size, (2, s))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(2, max_len)
    jl, jc = jlm.prefill(jp, {"inputs": jnp.asarray(toks)}, jc)
    tc = lm.init_cache(2, max_len)
    with torch.no_grad():
        tl, tc = lm.prefill(tp, {"inputs": _t(toks)}, tc)
    _gate(tl, jl)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
        jl, jc = jlm.decode_step(jp, {"inputs": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            tl, tc = lm.decode_step(tp, {"inputs": _t(tok)}, tc)
        _gate(tl, jl)
        assert tc["pos"] == int(jc["pos"])
        np.testing.assert_array_equal(tc["slots"][0]["kpos"].numpy(),
                                      np.asarray(jc["slots"][0]["kpos"]))


def test_cache_and_param_counts_match_reference(reduced):
    cfg, jlm, jp, tcfg, tp = reduced
    lm = build_lm(tcfg, device="cpu")
    jc, tc = jlm.init_cache(3, 24), lm.init_cache(3, 24)
    for k in ("k", "v", "kpos"):
        assert tuple(tc["slots"][0][k].shape) == jc["slots"][0][k].shape
    np.testing.assert_array_equal(tc["slots"][0]["kpos"].numpy(),
                                  np.asarray(jc["slots"][0]["kpos"]))
    assert lm.param_counts(tp) == jlm.param_counts(jp)
    own = lm.init(torch.Generator().manual_seed(0))
    assert lm.param_counts(own) == jlm.param_counts(jp)
    shapes = jax.tree.map(lambda a: a.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    assert own["slots"][0]["ln1"]["scale"].dtype == torch.float32


def test_lm_params_from_numpy_refuses_wrong_trees(reduced):
    cfg, jlm, jp, tcfg, tp = reduced
    npp = jax.tree.map(np.asarray, jp)
    bad = jax.tree.map(lambda a: a, npp)
    bad["slots"][0]["attn"]["wk"] = bad["slots"][0]["attn"]["wk"][..., :8]
    with pytest.raises(ValueError, match="wk"):
        lm_params_from_numpy(bad, tcfg, "cpu")
    bad = dict(npp)
    del bad["head"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(bad, tcfg, "cpu")
    bad = dict(npp, embed=npp["embed"].astype(np.int32))
    with pytest.raises(TypeError, match="embed"):
        lm_params_from_numpy(bad, tcfg, "cpu")
    unknown = dataclasses.replace(tcfg, pattern=("a", "z"))
    with pytest.raises(NotImplementedError, match="mixer kinds"):
        lm_params_from_numpy(npp, unknown, "cpu")


@pytest.mark.parametrize("case", ["three_prompts", "mixed_lengths",
                                  "blockwise_prompts"])
def test_serve_matches_reference(reduced, case):
    """tests/test_launch.py's two serving cases, and a group of 2,064-token
    prompts (prefill through the blockwise branch; max_len 2080 so that
    the reference keeps the prompt in its cache)."""
    cfg, jlm, jp, tcfg, tp = reduced
    kw = dict(max_new=4, slots=2, max_len=32)
    if case == "three_prompts":
        prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
    elif case == "mixed_lengths":
        prompts = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13]]
    else:
        prompts = serve_mod.random_prompts(cfg.vocab_size, 3, 2064, seed=4)
        kw["max_len"] = 2080
    ref, _ = j_serve(cfg, prompts, **kw)
    out, stats = serve(tcfg, prompts, params=tp, device="cpu", **kw)
    assert out == ref
    lengths = [len(p) for p in prompts]
    groups = sum(-(-lengths.count(n) // 2) for n in set(lengths))
    assert len(stats["prefill_ms"]) == groups
    assert len(stats["decode_ms"]) == stats["decode_steps"]


def test_serve_main_on_the_cpu(capsys):
    results = serve_mod.main(["--arch", "stablelm-12b", "--reduced",
                              "--device", "cpu", "--requests", "5",
                              "--max-new", "3"])
    assert sorted(results) == list(range(5))
    vocab = get("stablelm-12b").reduced().vocab_size
    assert all(len(t) == 3 and all(0 <= x < vocab for x in t)
               for t in results.values())
    assert "served 5 requests" in capsys.readouterr().out
