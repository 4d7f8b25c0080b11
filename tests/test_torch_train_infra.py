"""The port's training infrastructure against the JAX package, on the CPU.

Mirrors ``tests/test_train_infra.py`` and ``tests/test_elastic.py`` case
by case, with the same numpy-seeded inputs through both packages:

* ``CheckpointManager``: round trip, retention and latest, crash
  atomicity; the in-place snapshot (save, update in place, write);
  a failed write raised at ``wait``; checkpoints written by either
  package restored by the other (a DCGAN ``{"g", "d"}`` tree, a bf16
  leaf, an ``OptState``); a tree saved from a Cout-sharded mesh of two
  gloo ranks restored unsharded, on that mesh and at dp 2;
* ``SyntheticTokenPipeline`` bit for bit, host sharding;
  ``clip_by_global_norm`` and ``cosine_warmup_schedule`` to 1e-6;
  AdamW with a bf16 master copy; ``opt_state_from_numpy``;
* quantisation and error feedback against the reference's;
  ``compressed_psum`` on two gloo ranks;
* reduced StableLM-2-12B: ``loss`` and its grads against
  ``jax.value_and_grad(lm.loss)`` (loss 1e-5 relative, each grad leaf
  1e-4 of its max), three ``make_train_step`` steps against the
  reference's (params 1e-5 of ``max(1, max|ref|)``), ``microbatch=2``
  against the whole batch (1e-5), the loss descending, resume bit for
  bit (``make_train_step`` and ``launch.train.main``), and a resume
  across the packages;
* attention and the LM's grads past 2,048 tokens with K5 patched to
  raise (training never reaches it; serving still does);
* ``train_gen.main`` on the CPU, whose checkpoint the JAX generator
  restores and runs.

The xlstm-350m case of the reference's loss-descends test runs in
``tests/test_torch_hybrid_launch.py`` (through ``launch.train.main``).
"""

import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get as jget
from repro.data import SyntheticTokenPipeline as JTokens
from repro.distributed import compress as jcompress
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import layers as JL
from repro.models.generative import DCGANDiscriminator as JDisc
from repro.models.generative import GenerativeModel as JGen
from repro.models.lm import build_lm as j_build_lm
from repro.optim import adamw as jadamw

import _torch_spmd as W
from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.configs import get
from repro_torch.convert import (lm_params_from_numpy, opt_state_from_numpy,
                                 tree_from_numpy)
from repro_torch.data import SyntheticTokenPipeline, make_pipeline
from repro_torch.distributed import Mesh
from repro_torch.distributed.compress import (
    compressed_psum, dequantize, init_error_feedback,
    make_pod_compressed_allreduce, quantize,
    quantize_grads_with_error_feedback)
from repro_torch.launch import train as train_mod
from repro_torch.launch import train_gen
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import (effective_seq, make_train_step,
                                      value_and_grad)
from repro_torch.models import layers as L
from repro_torch.models.lm import build_lm
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_warmup_schedule)
from repro_torch.optim.adamw import _leaves

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # of each leaf's max|ref|
PARAM_TOL = 1e-5          # of max(1, max|ref|)
SPAWN_S = 240


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _flat(tree):
    """``{path: leaf}`` of nested dicts, lists and NamedTuples/dataclasses
    (the checkpoint's key order)."""
    return {k: v for k, v in manager_mod._flatten(tree).items()
            if not k.endswith("#none")}


def _assert_trees(got, want, rtol=0.0, atol=0.0, rel_max=None):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = _np(g[k]), _np(w[k])
        assert a.shape == b.shape, k
        if rel_max is not None:
            tol = rel_max * max(1.0, float(np.abs(b).max()))
            assert np.abs(a - b).max() <= tol, (k, np.abs(a - b).max(), tol)
        elif rtol == atol == 0.0:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=k)


def _assert_adam_close(got, want, grads, lr: float):
    """Params after ``len(grads)`` AdamW steps against the reference's:
    within ``PARAM_TOL * max(1, max|ref|)`` wherever the reference's
    gradient was determined at every step (above ``GRAD_TOL`` of its
    leaf's max, the gradient gate).  AdamW divides each element's
    moment by its own magnitude, so an element whose gradient sits at
    the sums' rounding level takes an update of arbitrary size within
    its bound: those are held to ``|d| <= 2 * lr * steps`` and must be
    under 1% of the elements.  ``grads``: the reference's grad trees,
    one per step."""
    g, w = _flat(got), _flat(want)
    gs = [_flat(_numpy_tree(t)) for t in grads]
    assert sorted(g) == sorted(w)
    loose = total = 0
    for k in w:
        a, b = _np(g[k]), _np(w[k])
        free = np.zeros(b.shape, bool)
        for t in gs:
            ref = np.abs(np.asarray(t[k], np.float32))
            free |= (ref > 0) & (ref <= GRAD_TOL * ref.max())
        d = np.abs(a - b)
        tol = PARAM_TOL * max(1.0, float(np.abs(b).max()))
        assert d[~free].max(initial=0.0) <= tol, (k, d[~free].max(), tol)
        assert d[free].max(initial=0.0) <= 2 * lr * len(gs), k
        loose += int(free.sum())
        total += free.size
    assert loose <= 0.01 * total, (loose, total)


def _jtree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a), tree)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# checkpointing / fault tolerance
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nest": {"b": torch.ones(4, dtype=torch.bfloat16) * 1.5},
            "lst": [torch.zeros(2), torch.full((3,), 7.0)],
            "i": torch.arange(3, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, tree, blocking=True)
    step, out = mgr.restore(tree)
    assert step == 10
    assert torch.equal(out["a"], tree["a"])
    assert out["nest"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nest"]["b"], tree["nest"]["b"])
    assert torch.equal(out["lst"][1], tree["lst"][1])
    assert out["i"].dtype == torch.int32
    manifest = json.load(open(tmp_path / "step_0000000010" / "manifest.json"))
    assert manifest["dtypes"] == {"a": "float32", "nest/b": "bfloat16",
                                  "lst/0": "float32", "lst/1": "float32",
                                  "i": "int32"}
    assert manifest["shapes"]["a"] == [2, 3]


def test_checkpoint_retention_and_latest(tmp_path):
    tree = {"a": torch.zeros(2)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.full((2,), float(s))}, blocking=True)
    assert mgr.steps() == [3, 4]
    step, out = mgr.restore(tree)
    assert step == 4 and float(out["a"][0]) == 4.0
    step, out = mgr.restore(tree, step=3)
    assert step == 3 and float(out["a"][0]) == 3.0


def test_checkpoint_crash_atomicity(tmp_path):
    """A half-written (uncommitted) dir must be ignored on restore."""
    tree = {"a": torch.ones(2)}
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree, blocking=True)
    os.makedirs(tmp_path / "step_0000000002")
    os.makedirs(tmp_path / "step_0000000003.tmp")
    step, _ = mgr.restore(tree)
    assert step == 1
    assert restore_latest(str(tmp_path / "none"), tree) == (0, None)


def test_save_snapshots_before_an_in_place_update(tmp_path, monkeypatch):
    """The writer thread is held until the tree has been updated in
    place by AdamW: what it writes must still be the values at save
    time (the port's update mutates the tensors the tree holds)."""
    params = {"w": torch.arange(8, dtype=torch.float32).reshape(2, 4)}
    opt = adamw_init(params)
    at_save = {"w": params["w"].clone()}
    updated = threading.Event()
    real_savez = np.savez

    def held_savez(*a, **kw):
        assert updated.wait(30)
        return real_savez(*a, **kw)

    monkeypatch.setattr(manager_mod.np, "savez", held_savez)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params, "opt": opt})
    adamw_update(params, {"w": torch.ones(2, 4)}, opt, lr=0.5)
    assert not torch.equal(params["w"], at_save["w"]) and opt.step == 1
    updated.set()
    mgr.wait()
    step, out = mgr.restore({"params": params, "opt": opt})
    assert step == 1
    assert torch.equal(out["params"]["w"], at_save["w"])
    assert out["opt"].step == 0
    assert torch.equal(out["opt"].mu["w"], torch.zeros(2, 4))


def test_failed_write_is_raised_at_wait(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(manager_mod.np, "savez", broken)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.steps() == []
    mgr.wait()                          # raised once, then cleared


def _small_gan_numpy():
    """A trained-looking small DCGAN ``{"g", "d"}`` tree and a bf16 leaf,
    from the JAX package's inits, plus its AdamW state after one step."""
    gen = JGen(train_gen.small_spec(), deconv_impl="sd")

    class SmallD(JDisc):
        CHANNELS = (3, 16, 32, 64)

    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    tree = {"g": gen.init(kg), "d": SmallD((16, 16)).init(kd)}
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), tree)
    opt = jadamw.adamw_init(tree)
    tree, opt = jadamw.adamw_update(tree, grads, opt, lr=1e-3)
    half = {"w16": jnp.asarray(np.linspace(-2, 3, 12, dtype=np.float32)
                               .reshape(3, 4), jnp.bfloat16)}
    hopt = jadamw.adamw_init(half)
    half, hopt = jadamw.adamw_update(half, {"w16": jnp.full(
        (3, 4), 0.5, jnp.bfloat16)}, hopt, lr=1e-2)
    return {"gan": tree, "opt": opt, "half": half, "hopt": hopt}


def _port_template(ref):
    """The port's tree of the same structure, holding other values."""
    gan = jax.tree.map(lambda a: torch.zeros(a.shape), ref["gan"])
    half = {"w16": torch.zeros(3, 4, dtype=torch.bfloat16)}
    return {"gan": gan, "opt": adamw_init(gan), "half": half,
            "hopt": adamw_init(half)}


def _assert_same_as_reference(out, ref):
    _assert_trees(out["gan"], _numpy_tree(ref["gan"]))
    assert out["half"]["w16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["half"]["w16"].float().numpy(),
        np.asarray(ref["half"]["w16"], np.float32))
    for name in ("opt", "hopt"):
        o, r = out[name], ref[name]
        assert isinstance(o, OptState) and o.step == int(r.step) == 1
        _assert_trees(o.mu, _numpy_tree(r.mu))
        _assert_trees(o.nu, _numpy_tree(r.nu))
        assert (o.master is None) == (r.master is None)
    assert out["hopt"].master["w16"].dtype == torch.float32
    _assert_trees(out["hopt"].master, _numpy_tree(ref["hopt"].master))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    ref = _small_gan_numpy()
    JManager(str(tmp_path)).save(7, ref, blocking=True)
    step, out = CheckpointManager(str(tmp_path)).restore(_port_template(ref))
    assert step == 7
    _assert_same_as_reference(out, ref)


def test_port_checkpoint_restores_in_jax(tmp_path):
    ref = _small_gan_numpy()
    port = {"gan": tree_from_numpy(_numpy_tree(ref["gan"]), "cpu"),
            "opt": opt_state_from_numpy(_numpy_tree(ref["opt"]), "cpu"),
            "half": tree_from_numpy(_numpy_tree(ref["half"]), "cpu"),
            "hopt": opt_state_from_numpy(_numpy_tree(ref["hopt"]), "cpu")}
    CheckpointManager(str(tmp_path)).save(7, port, blocking=True)
    template = jax.tree.map(jnp.zeros_like, ref)
    step, out = JManager(str(tmp_path)).restore(template)
    assert step == 7
    assert out["half"]["w16"].dtype == jnp.bfloat16
    assert out["opt"].step.dtype == jnp.int32 and int(out["opt"].step) == 1
    assert out["opt"].master is None
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_opt_state_from_numpy_keeps_the_lm_shapes():
    cfg = jget("stablelm-12b").reduced()
    jp = j_build_lm(cfg).init(jax.random.PRNGKey(0))
    js = jadamw.adamw_init(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp))
    tcfg = get("stablelm-12b").reduced()
    ts = opt_state_from_numpy(
        _numpy_tree(js), "cpu",
        convert=lambda t: lm_params_from_numpy(t, tcfg, "cpu"))
    assert ts.step == 0 and isinstance(ts.step, int)
    assert isinstance(ts.mu["slots"], list)
    _assert_trees(ts.master, _numpy_tree(js.master))
    assert ts.mu["embed"].dtype == torch.float32


def test_sharded_save_restores_unsharded_and_on_other_meshes(tmp_path):
    """Elastic restore: a tree saved from a Cout-sharded dp1 x mp2 mesh of
    two gloo ranks restores whole, onto that mesh and at dp 2, equal to
    ``place_params`` of the whole tree (reference
    ``tests/test_elastic.py``)."""
    out = spawn(W.ckpt_worker, 2, backend="gloo", args=(str(tmp_path),),
                timeout_s=SPAWN_S)
    assert out[0]["sharded_leaves"], "nothing was sharded"
    for r, res in enumerate(out):
        assert res["steps"] == [5] and res["step"] == 5
        _assert_trees(res["restored"], res["whole"])
        for k in ("mp2", "dp2"):
            _assert_trees(res[f"restored_{k}"], res[f"placed_{k}"])
    # rank 1's mp2 block of a sharded filter is the whole filter's second
    # half: the file holds the gathered array
    leaf = out[0]["sharded_leaves"][0]
    layer, name = leaf.split("/")
    whole = out[0]["whole"][layer][name]
    half = whole.shape[-1] // 2
    np.testing.assert_array_equal(out[1]["restored_mp2"][layer][name],
                                  whole[..., half:])
    # and the JAX package restores the same file whole
    spec = W.train_spec()
    jtemplate = {"g": {l.name: {n: jnp.zeros(a.shape)
                                for n, a in out[0]["whole"][l.name].items()}
                       for l in spec.layers}}
    step, jout = JManager(str(tmp_path)).restore(jtemplate)
    _assert_trees(jout["g"], out[0]["whole"])


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,procs,extra", [
    (0, 1, None), (5, 2, None), (3, 1, {"frame_embeds": (4, 6)})])
def test_tokens_equal_the_reference(seed, procs, extra):
    for proc in range(procs):
        kw = dict(vocab_size=97, seq_len=9, global_batch=4, seed=seed,
                  n_procs=procs, proc_index=proc, extra=extra)
        jp, tp = JTokens(**kw), make_pipeline("tokens", **kw)
        assert isinstance(tp, SyntheticTokenPipeline)
        for step in (0, 7, 123):
            jb, tb = jp.batch(step), tp.batch(step)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert tb[k].dtype == (torch.int32 if k in ("inputs",
                                                            "targets")
                                       else torch.float32)
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))


def test_data_deterministic_and_distinct():
    p = SyntheticTokenPipeline(vocab_size=100, seq_len=8, global_batch=4)
    b1, b2, b3 = p.batch(7), p.batch(7), p.batch(8)
    assert torch.equal(b1["inputs"], b2["inputs"])
    assert not torch.equal(b1["inputs"], b3["inputs"])
    assert torch.equal(b1["targets"][:, :-1], b1["inputs"][:, 1:])
    first = next(iter(p))
    assert torch.equal(first["inputs"], p.batch(0)["inputs"])


def test_data_host_sharding_partitions():
    h0, h1 = (SyntheticTokenPipeline(vocab_size=50, seq_len=4,
                                     global_batch=8, n_procs=2,
                                     proc_index=i) for i in (0, 1))
    assert h0.local_batch == h1.local_batch == 4
    assert h0.batch(0)["inputs"].shape == (4, 4)
    assert not torch.equal(h0.batch(0)["inputs"], h1.batch(0)["inputs"])


def test_effective_seq():
    from repro_torch.configs import SHAPES
    cell = SHAPES["train_4k"]
    assert effective_seq(get("stablelm-12b"), cell) == 4096
    assert effective_seq(get("whisper-small"), cell) == 448


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_clip_matches_reference():
    rng = np.random.RandomState(4)
    for scale in (100.0, 1e-3):
        g = {"a": (rng.randn(10) * scale).astype(np.float32),
             "b": {"c": (rng.randn(3, 4) * scale).astype(np.float32)},
             "l": [(rng.randn(5) * scale).astype(np.float32)]}
        jc, jn = jadamw.clip_by_global_norm(_jtree(g), 1.0)
        tc, tn = clip_by_global_norm(tree_from_numpy(g, "cpu"), 1.0)
        assert tn.dim() == 0
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees(tc, _numpy_tree(jc), rtol=1e-6, atol=1e-6)
    clipped, gn = clip_by_global_norm({"a": torch.full((10,), 100.0)}, 1.0)
    assert float(gn) > 100
    assert abs(float(torch.sqrt(torch.sum(clipped["a"] ** 2))) - 1) < 1e-5


@pytest.mark.parametrize("base,warmup,total", [(1e-3, 10, 100),
                                               (3e-4, 2, 6), (0.1, 0, 5)])
def test_cosine_warmup_schedule_matches_reference(base, warmup, total):
    j, t = jadamw.cosine_warmup_schedule(base, warmup, total), \
        cosine_warmup_schedule(base, warmup, total)
    for s in range(0, total + 4):
        want = float(j(jnp.asarray(s)))
        assert isinstance(t(s), float)
        assert abs(t(s) - want) <= 1e-6 * max(abs(want), 1e-30) + 1e-12, s
        assert t(torch.tensor(s)) == t(s)
    if warmup == 10:
        assert t(5) < 1e-3 and t(10) == pytest.approx(1e-3, rel=1e-5)
        assert t(100) < 2e-4


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        adamw_update(params, {"w": 2 * params["w"]}, opt, lr=0.05,
                     weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2
    assert opt.step == 200


def test_adamw_bf16_master_copy():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt.master is not None
    g = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    p2, opt2 = adamw_update(params, g, opt, lr=1e-4)
    assert p2["w"].dtype == torch.bfloat16
    assert opt2.master["w"].dtype == torch.float32
    # the master accumulates updates too small for bf16 params to resolve
    assert float((opt2.master["w"] - 1.0).abs().max()) > 0
    assert torch.equal(p2["w"], torch.ones(4, dtype=torch.bfloat16))


@pytest.mark.parametrize("master,state", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_adamw_dtypes_and_schedule_match_reference(master, state):
    rng = np.random.RandomState(6)
    p0 = {"a": rng.randn(3, 4).astype(np.float32),
          "s": [{"w": rng.randn(5).astype(np.float32)}]}
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                          p0) for _ in range(3)]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p0)
    js = jadamw.adamw_init(jp, master_dtype=jdt[master],
                           state_dtype=jdt[state])
    tp = tree_from_numpy(_numpy_tree(jp), "cpu")
    ts = adamw_init(tp, master_dtype=master, state_dtype=state)
    assert ts.mu["a"].dtype == state and ts.master["a"].dtype == master
    jsched = jadamw.cosine_warmup_schedule(1e-2, 2, 3)
    tsched = cosine_warmup_schedule(1e-2, 2, 3)
    for g in grads:
        jp, js = jadamw.adamw_update(jp, _jtree(g), js, lr=jsched)
        adamw_update(tp, tree_from_numpy(g, "cpu"), ts, lr=tsched)
    tol = 1e-2 if state == torch.bfloat16 else 1e-6
    _assert_trees(ts.master, _numpy_tree(js.master), rtol=tol, atol=tol)
    _assert_trees(tp, _numpy_tree(jp), rtol=1e-2, atol=1e-2)
    assert ts.step == int(js.step) == 3


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_quantize_matches_reference_and_bounds_error():
    x = np.random.RandomState(0).randn(128).astype(np.float32) * 3
    q, s = quantize(torch.from_numpy(x))
    jq, js = jcompress.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = np.abs(dequantize(q, s).numpy() - x).max()
    assert err <= float(s) * 0.5 + 1e-6


def test_error_feedback_matches_reference_and_preserves_sum():
    rng = np.random.RandomState(0)
    g_true = (rng.randn(64) * 1e-3).astype(np.float32)
    grads = {"w": torch.from_numpy(g_true), "l": [torch.ones(3)]}
    jgrads = {"w": jnp.asarray(g_true), "l": [jnp.ones(3)]}
    ef, jef = init_error_feedback(grads), jcompress.init_error_feedback(
        jgrads)
    assert ef["w"].dtype == torch.float32 and isinstance(ef["l"], list)
    acc_q = np.zeros(64)
    for _ in range(50):
        dq, ef = quantize_grads_with_error_feedback(grads, ef)
        jdq, jef = jcompress.quantize_grads_with_error_feedback(jgrads, jef)
        np.testing.assert_allclose(dq["w"].numpy(), np.asarray(jdq["w"]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(ef["w"].numpy(), np.asarray(jef["w"]),
                                   rtol=1e-5, atol=1e-9)
        acc_q += dq["w"].numpy()
    acc_true = g_true.astype(np.float64) * 50
    assert np.abs(acc_q - acc_true).max() < np.abs(acc_true).max() * 0.05


def test_compressed_psum_single_device():
    f = make_pod_compressed_allreduce(Mesh(1, 1), (None,), axis="data")
    x = torch.tensor([1.0, -2.0, 3.0])
    np.testing.assert_allclose(f(x).numpy(), x.numpy(), atol=0.05)
    with pytest.raises(RuntimeError, match="spmd"):
        compressed_psum(x, "data")
    with pytest.raises(ValueError):
        make_pod_compressed_allreduce(Mesh(1, 1), (None,), axis="pod")


def test_compressed_psum_on_two_gloo_ranks():
    """Each rank's int8 ``q * scale`` summed over the data axis: the
    reference's quantiser per rank and its f32 psum (a + b)."""
    out = spawn(W.psum_worker, 2, backend="gloo", timeout_s=SPAWN_S)
    xs = W.psum_inputs()
    parts = [np.asarray(jcompress.dequantize(*jcompress.quantize(
        jnp.asarray(x)))) for x in xs]
    want = (parts[0] + parts[1]).astype(np.float32)
    for r in out:
        np.testing.assert_array_equal(r["out"], want)
    exact = xs[0] + xs[1]
    assert np.abs(want - exact).max() <= 0.5 * (
        np.abs(xs[0]).max() + np.abs(xs[1]).max()) / 127 + 1e-6


# ---------------------------------------------------------------------------
# the dense LM's training half
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_pair():
    cfg = jget("stablelm-12b").reduced()
    jlm = j_build_lm(cfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    tcfg = get("stablelm-12b").reduced()
    tlm = build_lm(tcfg, device="cpu")
    return cfg, jlm, jp, tcfg, tlm


def _tparams(jp, tcfg):
    return lm_params_from_numpy(_numpy_tree(jp), tcfg, "cpu")


def _tbatch(jb):
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _grad_errs(tg, jg):
    out = {}
    for k, ref in _flat(_numpy_tree(jg)).items():
        got = _np(_flat(tg)[k])
        out[k] = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    return out


@pytest.mark.parametrize("seq", [16, 40])
def test_loss_and_grads_match_reference(lm_pair, seq):
    cfg, jlm, jp, tcfg, tlm = lm_pair
    jb = JTokens(cfg.vocab_size, seq, 4, seed=2).batch(3)
    jloss, jg = jax.value_and_grad(jlm.loss)(jp, jb)
    tp = _tparams(jp, tcfg)
    tloss, tg = value_and_grad(tlm, tp, _tbatch(jb))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    errs = _grad_errs(tg, jg)
    assert max(errs.values()) <= GRAD_TOL, errs
    assert not any(t.requires_grad for _, t in _leaves(tp))


def test_three_train_steps_match_reference(lm_pair):
    cfg, jlm, jp, tcfg, tlm = lm_pair
    pipe = JTokens(cfg.vocab_size, 16, 4, seed=0)
    jstep = jax.jit(j_make_train_step(jlm, base_lr=1e-3, warmup=1, total=6))
    tstep = make_train_step(tlm, base_lr=1e-3, warmup=1, total=6)
    js, tp = jadamw.adamw_init(jp), _tparams(jp, tcfg)
    ts = adamw_init(tp)
    jpp, jgrads = jp, []
    for s in range(3):
        jgrads.append(jax.grad(jlm.loss)(jpp, pipe.batch(s)))
        jpp, js, jm = jstep(jpp, js, pipe.batch(s))
        tp, ts, tm = tstep(tp, ts, _tbatch(pipe.batch(s)))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]),
                                                   rel=1e-4)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    _assert_adam_close(tp, _numpy_tree(jpp), jgrads, lr=1e-3)
    _assert_trees(ts.nu, _numpy_tree(js.nu), rtol=1e-4, atol=1e-9)
    assert ts.step == int(js.step) == 3


def test_microbatch_matches_whole_batch(lm_pair):
    cfg, jlm, jp, tcfg, tlm = lm_pair
    pipe = SyntheticTokenPipeline(cfg.vocab_size, 16, 4, seed=1)
    runs = {}
    for mb in (0, 2):
        step = make_train_step(tlm, base_lr=1e-3, warmup=1, total=4,
                               microbatch=mb)
        tp = _tparams(jp, tcfg)
        opt = adamw_init(tp)
        losses, grads = [], []
        for s in range(2):
            grads.append(value_and_grad(tlm, tp, pipe.batch(s))[1])
            tp, opt, m = step(tp, opt, pipe.batch(s))
            losses.append(float(m["loss"]))
        runs[mb] = (tp, losses, grads)
    np.testing.assert_allclose(runs[2][1], runs[0][1], rtol=1e-5)
    _assert_adam_close(runs[2][0], runs[0][0], runs[0][2], lr=1e-3)


def test_loss_descends(lm_pair):
    cfg, _, _, tcfg, tlm = lm_pair
    pipe = SyntheticTokenPipeline(vocab_size=tcfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=1)
    step = make_train_step(tlm, base_lr=3e-3, warmup=5, total=40)
    params = tlm.init(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    losses = []
    for s in range(40):
        params, opt, m = step(params, opt, pipe.batch(s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::8]


def test_restart_resume_matches_uninterrupted(lm_pair, tmp_path):
    """Train 6 steps straight == train 3, 'crash', resume 3 (bitwise)."""
    cfg, _, _, tcfg, tlm = lm_pair
    pipe = SyntheticTokenPipeline(vocab_size=tcfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=0)
    step_fn = make_train_step(tlm, base_lr=1e-3, warmup=1, total=6)

    def fresh():
        p = tlm.init(torch.Generator().manual_seed(0))
        return p, adamw_init(p)

    def run(params, opt, lo, hi):
        for s in range(lo, hi):
            params, opt, _ = step_fn(params, opt, pipe.batch(s))
        return params, opt

    pA, _ = run(*fresh(), 0, 6)
    pB, oB = run(*fresh(), 0, 3)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(3, {"params": pB, "opt": oB}, blocking=True)
    p0, o0 = fresh()
    step, restored = restore_latest(str(tmp_path), {"params": p0,
                                                    "opt": o0})
    assert step == 3 and restored["opt"].step == 3
    pC, _ = run(restored["params"], restored["opt"], 3, 6)
    _assert_trees(pC, pA)


def test_train_main_resumes_bitwise(tmp_path):
    """``launch.train.main`` with ``--resume auto``: the step-3
    checkpoint of a 6-step run, alone in a fresh ``--out`` (a job
    preempted after it), resumes to the straight run's params bit for
    bit; ``history.json`` holds the steps each call ran."""
    base = ["--arch", "stablelm-12b", "--reduced", "--steps", "6",
            "--ckpt-every", "3", "--batch", "4", "--seq", "16",
            "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    straight = train_mod.main(base + ["--out", str(a)])
    assert sorted(os.listdir(a / "ckpt")) == ["step_0000000003",
                                              "step_0000000006"]
    os.makedirs(b / "ckpt")
    shutil.copytree(a / "ckpt" / "step_0000000003",
                    b / "ckpt" / "step_0000000003")
    resumed = train_mod.main(base + ["--out", str(b)])
    _assert_trees(resumed["params"], straight["params"])
    assert [h["step"] for h in resumed["history"]] == [4, 5, 6]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in straight["history"][3:]]
    hist = json.load(open(b / "history.json"))
    assert [h["step"] for h in hist] == [4, 5, 6]
    fresh = train_mod.main(base + ["--out", str(b), "--resume", "none",
                                   "--steps", "1"])
    assert [h["step"] for h in fresh["history"]] == [1]


def test_train_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal path, which needs a machine "
                    "without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "stablelm-12b", "--reduced", "--steps",
                        "1", "--out", str(tmp_path)])


def test_resume_across_the_packages(lm_pair, tmp_path):
    """3 reference steps saved by the JAX manager, restored by the port
    (``restore_latest``) and trained 3 more, against the reference's 6
    straight (params 1e-5 of max(1, max|ref|))."""
    cfg, jlm, jp, tcfg, tlm = lm_pair
    pipe = JTokens(cfg.vocab_size, 16, 4, seed=0)
    jstep = jax.jit(j_make_train_step(jlm, base_lr=1e-3, warmup=1, total=6))
    tstep = make_train_step(tlm, base_lr=1e-3, warmup=1, total=6)
    jpp, js, jgrads = jp, jadamw.adamw_init(jp), []
    for s in range(6):
        if s >= 3:
            jgrads.append(jax.grad(jlm.loss)(jpp, pipe.batch(s)))
        jpp, js, _ = jstep(jpp, js, pipe.batch(s))
        if s == 2:
            JManager(str(tmp_path)).save(3, {"params": jpp, "opt": js},
                                         blocking=True)
    template = {"params": tlm.init(torch.Generator().manual_seed(5))}
    template["opt"] = adamw_init(template["params"])
    step, got = restore_latest(str(tmp_path), template)
    assert step == 3 and got["opt"].step == 3
    tp, ts = got["params"], got["opt"]
    for s in range(3, 6):
        tp, ts, _ = tstep(tp, ts, _tbatch(pipe.batch(s)))
    _assert_adam_close(tp, _numpy_tree(jpp), jgrads, lr=1e-3)


# ---------------------------------------------------------------------------
# past 2,048 tokens: training never reaches K5
# ---------------------------------------------------------------------------

def _no_k5(*a, **kw):
    raise AssertionError("K5 has no backward: training must not reach it")


def test_attention_grads_past_2048_skip_k5(monkeypatch):
    rng = np.random.RandomState(7)
    b, s, d, h, hkv, hd = 1, 2100, 32, 2, 1, 16
    p = {"wq": rng.randn(d, h * hd), "wk": rng.randn(d, hkv * hd),
         "wv": rng.randn(d, hkv * hd), "wo": rng.randn(h * hd, d),
         "bq": rng.randn(h * hd), "bk": rng.randn(hkv * hd),
         "bv": rng.randn(hkv * hd)}
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    x = (rng.randn(b, s, d) * 0.5).astype(np.float32)
    cot = rng.randn(b, s, d).astype(np.float32)
    kw = dict(n_heads=h, n_kv=hkv, head_dim=hd, rope_theta=1e4,
              attn_block=256)

    def jloss(p_, x_):
        out, _ = JL.attention(p_, x_, **kw)
        return jnp.sum(out * cot)
    jg = jax.grad(jloss, argnums=(0, 1))(_jtree(p), jnp.asarray(x))

    real = L.flash_attention
    monkeypatch.setattr(L, "flash_attention", _no_k5)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = L.attention(tp, tx, **kw)
    loss = torch.sum(out * torch.from_numpy(cot))
    grads = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)] + [tx])
    errs = {k: np.abs(g.numpy() - np.asarray(jg[0][k])).max()
            / np.abs(np.asarray(jg[0][k])).max()
            for k, g in zip(sorted(tp), grads)}
    errs["x"] = (np.abs(grads[-1].numpy() - np.asarray(jg[1])).max()
                 / np.abs(np.asarray(jg[1])).max())
    assert max(errs.values()) <= GRAD_TOL, errs

    # with no gradient asked, the same call is K5's (serving)
    calls = []
    monkeypatch.setattr(L, "flash_attention",
                        lambda q, *a, **k: calls.append(q.shape)
                        or real(q, *a, **k))
    with torch.no_grad():
        served, _ = L.attention(tp, tx, **kw)
    assert calls == [(b, h, s, hd)]
    np.testing.assert_allclose(served.numpy(), out.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_lm_grads_past_2048_match_reference_without_k5(lm_pair,
                                                       monkeypatch):
    cfg, jlm, jp, tcfg, tlm = lm_pair
    monkeypatch.setattr(L, "flash_attention", _no_k5)
    jb = JTokens(cfg.vocab_size, 2100, 1, seed=4).batch(0)
    jloss, jg = jax.value_and_grad(jlm.loss)(jp, jb)
    tloss, tg = value_and_grad(tlm, _tparams(jp, tcfg), _tbatch(jb))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    errs = _grad_errs(tg, jg)
    assert max(errs.values()) <= GRAD_TOL, errs


# ---------------------------------------------------------------------------
# the GAN trainer's checkpoints
# ---------------------------------------------------------------------------

def test_train_gen_checkpoint_restores_in_the_jax_generator(tmp_path):
    d_hist, g_hist = train_gen.main(["--small", "--steps", "2", "--out",
                                     str(tmp_path), "--device", "cpu"])
    assert len(g_hist) == 2
    ckpt = str(tmp_path / "ckpt")
    jgen = JGen(train_gen.small_spec(), deconv_impl="sd")

    class SmallD(JDisc):
        CHANNELS = (3, 16, 32, 64)

    kg, kd = jax.random.split(jax.random.PRNGKey(1))
    jtemplate = {"g": jgen.init(kg), "d": SmallD((16, 16)).init(kd)}
    step, jout = JManager(ckpt).restore(jtemplate)
    assert step == 2 and JManager(ckpt).steps() == [2]
    gen, disc = train_gen.make_gan(True, "sd", "cpu")
    ptemplate = {"g": gen.init(torch.Generator().manual_seed(3)),
                 "d": disc.init(torch.Generator().manual_seed(4))}
    _, pout = CheckpointManager(ckpt).restore(ptemplate)
    _assert_trees(pout, _numpy_tree(jout))
    # the trained generator, not the template: not its seed-0 init
    init0 = gen.init(torch.Generator().manual_seed(0))
    assert not torch.equal(pout["g"]["d1"]["w"], init0["d1"]["w"])
    z = np.random.RandomState(0).randn(3, 32).astype(np.float32)
    jy = np.asarray(jgen.apply(jout["g"], jnp.asarray(z)))
    with torch.no_grad():
        ty = gen.apply(pout["g"], torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
