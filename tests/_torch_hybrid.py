"""Helpers shared by ``tests/test_torch_ssm.py``,
``tests/test_torch_hybrid.py`` and ``tests/test_torch_hybrid_launch.py``:
the reduced xLSTM-350M and Jamba-1.5-Large (and two-repeat variants)
built in both packages, the reference's weights carried into the port
with ``lm_params_from_numpy``, the logits gate, and an autouse fixture
(imported into each file) that keeps torch on one CPU thread."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.data import SyntheticTokenPipeline as JTokens
from repro.models.lm import build_lm as j_build_lm

from repro_torch.checkpoint import manager as manager_mod
from repro_torch.configs import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm import build_lm

LOGIT_TOL = 1e-4        # relative to max(1, max|ref|)
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-4         # of each leaf's max|ref|
ARCHS = {"xlstm": "xlstm-350m", "jamba": "jamba-1.5-large-398b"}
# two repeats of a two-slot pattern (4 layers): every leaf and cache
# stacked over R = 2 and sliced per repeat, as the full configs' (the
# reduced configs have R = 1); short, so that few mLSTM layers amplify
# rounding.  Jamba's: Mamba + MLP, then attention + MoE (moe_every 2)
REPEATS2 = {"xlstm_r2": ("xlstm-350m", ("x", "s")),
            "jamba_r2": ("jamba-1.5-large-398b", ("m", "a"))}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one CPU thread while a test runs: the recurrent blocks
    issue thousands of tiny ops, whose worker threads otherwise spin
    against the other test processes' (a 40-step xLSTM run took 213 s
    beside five busy processes on 8 threads, 21 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {k: v for k, v in manager_mod._flatten(tree).items()
            if not k.endswith("#none")}


@functools.lru_cache(maxsize=None)
def _pair(case):
    name, pattern = REPEATS2.get(case, (ARCHS.get(case), None))
    cfg, tcfg = jget(name).reduced(), get(name).reduced()
    if pattern is not None:
        cfg, tcfg = (dataclasses.replace(c, pattern=pattern, n_layers=4)
                     for c in (cfg, tcfg))
    jlm = j_build_lm(cfg)
    jp = _numpy_tree(jlm.init(jax.random.PRNGKey(0)))
    tp = lm_params_from_numpy(jp, tcfg, "cpu")
    return cfg, jlm, jp, tcfg, build_lm(tcfg, device="cpu"), tp


@functools.lru_cache(maxsize=None)
def _batch():
    return JTokens(512, 24, 3, seed=5).batch(1)


def _logit_gate(out, ref, spread=0.0):
    """``out`` within ``max(LOGIT_TOL * max(1, max|ref|), 4 * spread)``
    of ``ref``."""
    ref = np.asarray(ref)
    d = np.abs(_np(out) - ref).max()
    tol = max(LOGIT_TOL * max(1.0, np.abs(ref).max()), 4 * spread)
    assert d <= tol, (d, tol)
