"""The port's Qwen1.5-32B, InternLM2-20B and Yi-34B against the JAX
package, on the CPU.

The reduced configs (2 layers, 4 q heads of 16; Qwen 4 kv heads with
the q/k/v bias, InternLM2 and Yi 2 kv heads), the reference's
``LM.init`` weights carried over with ``lm_params_from_numpy``, Qwen's
``bq`` / ``bk`` / ``bv`` first given random values (both packages
initialise them to zero, which would hide the bias path):

* ``forward_train`` logits within ``1e-4 * max(1, max|ref|)``, ``loss``
  within 1e-6 relative, grads within 1e-4 of each leaf's max;
* ``prefill`` (12 tokens, and 2,064 past K5's 2,048 threshold: its
  contract's CPU oracle here, the reference's scan) then 3
  ``decode_step``s fed the reference's tokens: logits, ``pos``,
  ``kpos`` and the K/V caches;
* ``serve`` token for token;
* the full configs' parameter shapes and counts, from shapes alone.

Torch runs on one CPU thread (``one_torch_thread``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.data import SyntheticTokenPipeline as JTokens
from repro.launch.serve import serve as j_serve
from repro.models.lm import build_lm as j_build_lm

from _torch_hybrid import (LOSS_RTOL, _flat, _logit_gate, _np, _numpy_tree,
                           _t, one_torch_thread)  # noqa: F401 (autouse)

from repro_torch.configs import get
from repro_torch.convert import _lm_shapes, lm_params_from_numpy
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import layers as L
from repro_torch.models.lm import build_lm

ARCHS = {"qwen": "qwen1.5-32b", "internlm2": "internlm2-20b",
         "yi": "yi-34b"}
GRAD_TOL = 1e-4         # of each leaf's max|ref|
_PAIRS = {}


def _pair(case):
    """(reference config, reference LM, its numpy params, port config,
    port LM, port params) of the reduced arch, built once per process;
    Qwen's q/k/v biases drawn N(0, 0.1^2) from a numpy seed."""
    if case not in _PAIRS:
        name = ARCHS[case]
        cfg, tcfg = jget(name).reduced(), get(name).reduced()
        jlm = j_build_lm(cfg)
        jp = _numpy_tree(jlm.init(jax.random.PRNGKey(0)))
        attn = jp["slots"][0]["attn"]
        assert sorted(attn) == (["bk", "bq", "bv", "wk", "wo", "wq", "wv"]
                                if cfg.qkv_bias else
                                ["wk", "wo", "wq", "wv"])
        rng = np.random.RandomState(11)
        for b in ("bq", "bk", "bv"):
            if b in attn:
                assert not attn[b].any()
                attn[b] = (rng.randn(*attn[b].shape) * 0.1).astype(
                    np.float32)
        tp = lm_params_from_numpy(jp, tcfg, "cpu")
        _PAIRS[case] = (cfg, jlm, jp, tcfg, build_lm(tcfg, device="cpu"),
                        tp)
    return _PAIRS[case]


@pytest.mark.parametrize("case", list(ARCHS))
def test_dense_decoder_logits_loss_and_grads_match_reference(case):
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    jb = JTokens(cfg.vocab_size, 20, 3, seed=5).batch(1)
    tb = {k: _t(np.asarray(v)) for k, v in jb.items()}
    ref = jax.jit(jlm.forward_train)(jp, jb)
    with torch.no_grad():
        out = lm.forward_train(tp, tb)
    _logit_gate(out, ref)
    jloss, jg = jax.jit(jax.value_and_grad(jlm.loss))(jp, jb)
    tloss, tg = value_and_grad(lm, tp, tb)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    g, w = _flat(tg), _flat(_numpy_tree(jg))
    assert sorted(g) == sorted(w)
    errs = {k: float(np.abs(_np(g[k]) - w[k]).max()
                     / max(np.abs(w[k]).max(), 1e-30)) for k in w}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    if cfg.qkv_bias:
        assert all(bool(g[f"slots/0/attn/{b}"].any())
                   for b in ("bq", "bk", "bv"))


@pytest.mark.parametrize("s,max_len", [(12, 32), (2064, 2080)])
@pytest.mark.parametrize("case", list(ARCHS))
def test_dense_decoder_prefill_and_decode_match_reference(case, s, max_len,
                                                         monkeypatch):
    """Past 2,048 tokens each layer's prefill calls ``flash_attention``
    once (K5 on the card), decode never."""
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    calls = []
    real = L.flash_attention

    def counted(*a, **kw):
        calls.append(tuple(a[1].shape))
        return real(*a, **kw)
    monkeypatch.setattr(L, "flash_attention", counted)
    toks = np.random.RandomState(s).randint(0, cfg.vocab_size, (2, s))
    toks = toks.astype(np.int32)
    jc, tc = jlm.init_cache(2, max_len), lm.init_cache(2, max_len)
    jl, jc = jax.jit(jlm.prefill)(jp, {"inputs": jnp.asarray(toks)}, jc)
    with torch.no_grad():
        tl, tc = lm.prefill(tp, {"inputs": _t(toks)}, tc)
    jdecode = jax.jit(jlm.decode_step)
    for step in range(4):
        _logit_gate(tl, jl)
        assert tc["pos"] == int(jc["pos"]) == s + step
        for k in ("k", "v"):
            ref = np.asarray(jc["slots"][0][k], np.float32)
            np.testing.assert_allclose(
                _np(tc["slots"][0][k]), ref, rtol=0,
                atol=1e-4 * max(1.0, float(np.abs(ref).max())),
                err_msg=f"{k} after call {step}")
        np.testing.assert_array_equal(tc["slots"][0]["kpos"].numpy(),
                                      np.asarray(jc["slots"][0]["kpos"]))
        if step == 3:
            break
        tok = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
        jl, jc = jdecode(jp, {"inputs": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            tl, tc = lm.decode_step(tp, {"inputs": _t(tok)}, tc)
    assert calls == ([(2, cfg.n_kv_heads, s, cfg.hd)] * cfg.n_layers
                     if s > 2048 else [])


@pytest.mark.parametrize("case", list(ARCHS))
def test_dense_decoder_serve_matches_reference(case):
    """``serve`` on mixed prompt lengths, token for token against the
    reference's ``serve``, which draws its own weights at
    ``PRNGKey(0)``: the port serves the same draw, zero biases and
    all."""
    cfg = jget(ARCHS[case]).reduced()
    tcfg = get(ARCHS[case]).reduced()
    jp = _numpy_tree(j_build_lm(cfg).init(jax.random.PRNGKey(0)))
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13], [4, 5, 6]]
    kw = dict(max_new=4, slots=2, max_len=32)
    ref, _ = j_serve(cfg, prompts, **kw)
    out, stats = serve(tcfg, prompts, params=lm_params_from_numpy(
        jp, tcfg, "cpu"), device="cpu", **kw)
    assert out == ref
    assert len(stats["prefill_ms"]) == 2


@pytest.mark.parametrize("case", list(ARCHS))
def test_full_dense_decoders_have_the_reference_shapes(case):
    """The full configs build (no weights drawn); their parameter shapes
    and (total, active) counts are the reference's, from shapes alone
    (``jax.eval_shape`` and meta tensors); the head groupings K5 meets
    on the card: Qwen 40 / 40, InternLM2 48 / 8, Yi 56 / 8 (7 q heads
    a kv head)."""
    cfg, tcfg = jget(ARCHS[case]), get(ARCHS[case])
    lm = build_lm(tcfg, device="cpu")
    assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.hd) == {
        "qwen": (1, 128), "internlm2": (6, 128), "yi": (7, 128)}[case]
    jlm = j_build_lm(cfg)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda t: torch.empty(t, device="meta"),
                        _lm_shapes(tcfg),
                        is_leaf=lambda t: isinstance(t, tuple))
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == \
        jax.tree.map(lambda a: tuple(a.shape), shapes)
    assert lm.param_counts(tree) == jlm.param_counts(shapes)
