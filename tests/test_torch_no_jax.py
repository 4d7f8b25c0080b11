"""The port stands alone: no JAX, no JAX package.

A fresh interpreter with ``jax`` and ``repro`` made unimportable imports
``repro_torch``, serves the CPU dryrun (on the default and on the
winograd backend, and in int8 on the torch and the fused backend; on
``fused`` the 3-D ``voxgan-dryrun`` cell runs the depth-folded lowering on
K2's int8 pair and the 1-D ``wavegan-dryrun`` cell K1 int8 as an H=1
launch; calibrated and chained, ``--calib``, with its cache in a
temporary directory), takes two small GAN training steps on
the CPU (checkpointed into a temporary directory), trains the reduced
StableLM-2-12B two steps through ``launch/train.py`` with a checkpoint
after each (``checkpoint/``) and imports ``distributed/compress.py``,
serves the reduced StableLM-2-12B through the LM server
(``launch/serve.py``, whose K5 wrapper ``kernels/flash_attn.py`` and LM
``models/lm.py`` import too), then the reduced xLSTM-350M and
Jamba-1.5-Large (``models/ssm.py``), and imports ``chip_smoke`` (without
running it); and without
CUDA the port's default device raises instead of falling back to the
CPU.  A second interpreter, with the same two blocked, imports the
executor registry, the wrong baselines and ``sd.compat``, runs every
registered impl once on the CPU and ``examples/quickstart_torch.py
--device cpu``.  A third spawns four gloo ranks on the CPU
(``repro_torch.launch.mesh.spawn``) that block the same two before
anything else and run the scale-out: ``serve_gen --dryrun --dp 2 --mp 2``
on the fused backend (the sharded engine, plans and model), a sharded
train step (``train_gen.make_sharded_train_step``, the sharded
``sd.conv_transpose`` and its backward) and ``sd.execute_spmd``; then
four more, as dp2 x mp2, the sharded LM (the reduced DBRX's prefill,
decode, grads and train step, and one prefill and one decode step of
the reduced Jamba's Mamba, attention and MoE slots,
``tests/_torch_lm_shard.py``) and the full DBRX's param and batch specs
from the meta device (``launch/steps.abstract_params``,
``input_specs``).  A fourth runs the dry-run (``launch/dryrun.py``,
``launch/hlo_analysis.py``) on a single- and a two-pod cell and
``examples/train_dcgan_torch.py --small --steps 2`` on the CPU, with
the same two blocked.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
from repro_torch.launch import serve_gen
results, stats = serve_gen.main(["--dryrun", "--device", "cpu"])
assert stats["served"] == 8, stats
results, stats = serve_gen.main(["--dryrun", "--device", "cpu",
                                 "--backend", "winograd"])
assert stats["served"] == 6, stats
results, stats = serve_gen.main(["--dryrun", "--device", "cpu",
                                 "--dtype", "int8"])
assert stats["served"] == 8, stats
assert "int8" in stats["compile_cache"][0], stats
results, stats = serve_gen.main(["--dryrun", "--device", "cpu",
                                 "--backend", "fused", "--dtype", "int8"])
assert stats["served"] == 8, stats
results, stats = serve_gen.main(["--dryrun", "--device", "cpu",
                                 "--backend", "fused", "--dtype", "int8",
                                 "--calib", "4"])
assert stats["served"] == 8, stats
from repro_torch.launch import train_gen
d_hist, g_hist = train_gen.main(["--steps", "2", "--small", "--device",
                                 "cpu", "--deconv-impl", "sd_kernel",
                                 "--out", {gan_out!r}])
assert len(g_hist) == 2, g_hist
from repro_torch.launch import train
from repro_torch.checkpoint import CheckpointManager
import repro_torch.distributed.compress
out = train.main(["--arch", "stablelm-12b", "--reduced", "--steps", "2",
                  "--ckpt-every", "1", "--batch", "2", "--seq", "8",
                  "--device", "cpu", "--out", {lm_out!r}])
assert [h["step"] for h in out["history"]] == [1, 2], out["history"]
assert CheckpointManager({lm_out!r} + "/ckpt").steps() == [1, 2]
import repro_torch.kernels.flash_attn
import repro_torch.models.lm
from repro_torch.launch import serve
lm_results = serve.main(["--arch", "stablelm-12b", "--reduced", "--device",
                         "cpu", "--requests", "4"])
assert sorted(lm_results) == [0, 1, 2, 3], lm_results
import repro_torch.models.ssm
for arch in ("xlstm-350m", "jamba-1.5-large-398b"):
    lm_results = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "4", "--max-new", "4"])
    assert sorted(lm_results) == [0, 1, 2, 3], (arch, lm_results)
sys.path.insert(0, {repo!r})
import chip_smoke
assert callable(chip_smoke.main)
bad = sorted(m for m in sys.modules
             if (m == "jax" or m.startswith("jax.") or m == "repro"
                 or m.startswith("repro.")) and sys.modules[m] is not None)
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_runs_with_jax_unimportable(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TORCH_SD_CALIB_CACHE=str(tmp_path / "sd_calib.json"))
    code = CODE.format(repo=REPO, gan_out=str(tmp_path / "dcgan"),
                       lm_out=str(tmp_path / "lm"))
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert (tmp_path / "sd_calib.json").exists()


REGISTRY_CODE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import runpy
import torch
from repro_torch.core import registry, wrong_baselines
from repro_torch.sd import compat
x, w = torch.randn(1, 5, 6, 3), torch.randn(5, 5, 3, 2)
ref = registry.resolve("native")(x, w, 2, 2)
for name in registry.names():
    y = registry.resolve(name)(x, w, 2, 2)
    assert y.shape == ref.shape and bool(torch.isfinite(y).all()), name
    print("ran", name)
sys.argv = ["quickstart_torch.py", "--device", "cpu"]
runpy.run_path({quickstart!r}, run_name="__main__")
bad = sorted(m for m in sys.modules
             if (m == "jax" or m.startswith("jax.") or m == "repro"
                 or m.startswith("repro.")) and sys.modules[m] is not None)
assert not bad, bad
print("NO_JAX_OK")
"""


def test_registry_and_quickstart_run_with_jax_unimportable():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = REGISTRY_CODE.format(quickstart=os.path.join(
        REPO, "examples", "quickstart_torch.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("ran ") == 10, out.stdout
    assert "SD output == native: True" in out.stdout
    assert "NO_JAX_OK" in out.stdout


SPMD_CODE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {tests!r})
import _torch_spmd
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import spawn
out = spawn(_torch_spmd.blocked_worker, 4, backend="gloo", timeout_s=240)
for r in out:
    assert r["served"] == 8 and r["shed"] == 0, r
    assert r["y"] == (4, 10, 12, 8) and r["loss"] == r["loss"], r
    assert not r["bad"], r
import _torch_lm_shard
out = spawn(_torch_lm_shard.blocked_worker, 4, backend="gloo", timeout_s=240)
for r in out:
    assert r["loss"] == r["loss"] and not r["bad"], r
    assert r["embed"] == ("model", "data") and r["inputs"] == ("data", None)
    assert len(r["jamba"]) == 4 and r["jamba_finite"], r
    assert r["jamba"] == out[0]["jamba"], r
bad = sorted(m for m in sys.modules
             if (m == "jax" or m.startswith("jax.") or m == "repro"
                 or m.startswith("repro.")) and sys.modules[m] is not None)
assert not bad, bad
print("NO_JAX_OK")
"""


def test_scale_out_runs_with_jax_unimportable():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = SPMD_CODE.format(tests=os.path.join(REPO, "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout


DRYRUN_CODE = """
import json, os, runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
from repro_torch.launch import dryrun, hlo_analysis
dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
             "--multi-pod", "both", "--out", {out!r}])
for tag in ("sp", "mp"):
    with open(os.path.join({out!r},
                           f"whisper-small__decode_32k__{{tag}}.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok", rec
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective"), rec
sys.argv = ["train_dcgan_torch.py", "--small", "--steps", "2", "--device",
            "cpu", "--out", {gan_out!r}]
d_hist, g_hist = runpy.run_path({example!r}, run_name="__main__")["main"](
    sys.argv[1:])
assert len(g_hist) == 2 and all(x == x for x in g_hist), g_hist
from repro_torch.checkpoint import CheckpointManager
assert CheckpointManager({gan_out!r} + "/ckpt").steps() == [2]
bad = sorted(m for m in sys.modules
             if (m == "jax" or m.startswith("jax.") or m == "repro"
                 or m.startswith("repro.")) and sys.modules[m] is not None)
assert not bad, bad
print("NO_JAX_OK")
"""


def test_dryrun_and_dcgan_example_run_with_jax_unimportable(tmp_path):
    """``launch/dryrun.py`` (with ``launch/hlo_analysis.py``) traces a
    single- and a two-pod Whisper decode cell, and
    ``examples/train_dcgan_torch.py --small --steps 2`` trains on the
    CPU and checkpoints, with ``jax`` and ``repro`` unimportable."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = DRYRUN_CODE.format(
        out=str(tmp_path / "dry"), gan_out=str(tmp_path / "dcgan"),
        example=os.path.join(REPO, "examples", "train_dcgan_torch.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout


def test_sources_import_nothing_of_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import repro(\.|$| )"
                     r"|from repro(\.| ))")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "examples", "quickstart_torch.py"),
             os.path.join(REPO, "examples", "train_dcgan_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(open(f), 1) if pat.match(line)]
    assert not hits


def test_default_device_raises_without_cuda():
    from repro_torch.device import default_device
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal path, which needs a machine "
                    "without CUDA")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text(open(os.path.join(REPO,
                                                "chip_smoke.py")).read())
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, cwd=cwd,
                             timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
