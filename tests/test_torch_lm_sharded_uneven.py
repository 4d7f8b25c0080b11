"""The port's sharded LM where the model axis does not divide the heads,
the kv heads or Whisper's encoder positions, against the one-process
port and against the JAX package sharded on forced host devices, on the
CPU.

The reference's ``constrain`` degrades such a dim to replicated, and its
cache specs replicate a cache dim the model axis does not divide; the
port runs them so (``models/layers.py`` ``attention_tp``, ``qkv_tp``;
``models/ssm.py``'s mLSTM; ``models/lm.py``'s cross K/V).  The cases
(``tests/_torch_lm_shard.py`` ``UNEVEN``, each on its mesh of
``UNEVEN_MESH``): StableLM at 6 heads on dp1 x mp4 and at 6 q / 3 kv
heads on dp1 x mp2 (these two were refusals before), the reduced StableLM
on dp1 x mp4 (1 q head and half a kv head a rank), Whisper at 30 encoder
positions on dp1 x mp4 (a refusal before), xLSTM's mLSTM at 2 heads on
dp1 x mp4.  The overrides of the StableLM kv case add 6 q heads: its 4
q heads could not share 3 kv heads in either package.  Each runs in
spawned gloo ranks (``uneven_rank_main``): prefill of 4 prompts, 3
greedy decode steps, the loss and its grads, one AdamW train step; the
reference runs the same inputs jitted with its shardings in one
subprocess on 4 forced host devices (``REF_CODE`` on the table), started
first.  Gates: those of ``tests/test_torch_lm_sharded_recurrent.py``
(logits and loss 1e-5, grads 1e-4 of each leaf's max, tokens equal,
params by the AdamW rule; each at least four times the one-process
port's own move under a one-ulp move of every param).  Also: K5 on each
rank's heads in a 2,064-token prefill of the reduced StableLM on mp 4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_lm_shard as H
from _torch_hybrid import one_torch_thread  # noqa: F401 (autouse)
from test_torch_lm_sharded_recurrent import _assert_close, _case, _spread

from repro_torch.configs import get
from repro_torch.launch.mesh import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = list(H.UNEVEN)
MESHES = sorted(set(H.UNEVEN_MESH.values()))
SPAWN_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's sharded port run, the reference's runs (one process,
    every mesh), the one-process port's runs and each case's spread."""
    tmp = tmp_path_factory.mktemp("lm_shard_uneven")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    path = str(tmp / "ref.npz")
    code = H.REF_CODE.format(tests=os.path.join(REPO, "tests"), path=path,
                             meshes=MESHES, table="UNEVEN")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        port = {m: spawn(H.uneven_rank_main, m[0] * m[1], backend="gloo",
                         args=m, timeout_s=SPAWN_S) for m in MESHES}
        one = {c: H.flat(H.run_case(c)) for c in CASES}
        spread = {c: _spread(c, one[c]) for c in CASES}
        out, err = proc.communicate(timeout=SPAWN_S)
        assert proc.returncode == 0 and "REF_OK" in out, err[-3000:]
        with np.load(path) as f:
            ref = {k: f[k] for k in f.files}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"port": port, "one": one, "ref": ref, "spread": spread}


def _port(runs, case: str) -> dict:
    return _case(runs["port"][H.UNEVEN_MESH[case]][0], case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_the_one_process_port(runs, case):
    _assert_close(_port(runs, case), runs["one"][case],
                  runs["spread"][case], f"{H.UNEVEN_MESH[case]} {case}")


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_the_reference_sharded(runs, case):
    dp, mp = H.UNEVEN_MESH[case]
    pre = f"{dp}x{mp}/{case}/"
    want = {k[len(pre):]: v for k, v in runs["ref"].items()
            if k.startswith(pre)}
    _assert_close(_port(runs, case), want, runs["spread"][case],
                  f"{(dp, mp)} {case} vs the reference")


def test_k5_runs_on_each_ranks_heads(runs):
    """A 2,064-token prefill of the reduced StableLM on mp 4: every rank
    launches K5 once a layer on its 1 q head and the 1 kv head it reads,
    and the logits equal the one-process port's."""
    cfg = H.config("stablelm_mp4", get)
    for res in runs["port"][H.UNEVEN_MESH["stablelm_mp4"]]:
        assert [tuple(c) for c in res["k5_calls"]] == \
            [(1, 1)] * cfg.n_layers, res["k5_calls"]
    import torch

    from repro_torch.convert import _lm_shapes, lm_params_from_numpy
    from repro_torch.models.lm import build_lm
    lm = build_lm(cfg, device="cpu")
    full = lm_params_from_numpy(H.draw(_lm_shapes(cfg)), cfg, "cpu")
    with torch.no_grad():
        want, _ = lm.prefill(full, {"inputs": torch.from_numpy(
            H.tokens(cfg, 2, H.LONG, 4))}, lm.init_cache(2, H.LONG + 16))
    got = runs["port"][H.UNEVEN_MESH["stablelm_mp4"]][0]["k5_logits"]
    want = want.numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
def test_replicated_heads_add_no_collective_axis(runs, case):
    """The replicated heads and positions still talk over the model axis
    alone (the meshes have no data axis)."""
    got = runs["port"][H.UNEVEN_MESH[case]][0][f"{case}/collectives"]
    assert {k.split("/")[1] for k, n in got.items() if n} == {"model"}
