"""The port stands alone: no JAX, no JAX package.

A fresh interpreter with ``jax`` and ``repro`` made unimportable imports
``repro_torch``, serves the CPU dryrun (on the default and on the
winograd backend, and in int8 on the torch and the fused backend; on
``fused`` the 3-D ``voxgan-dryrun`` cell runs the depth-folded lowering on
K2's int8 pair and the 1-D ``wavegan-dryrun`` cell K1 int8 as an H=1
launch; calibrated and chained, ``--calib``, with its cache in a
temporary directory), takes two small GAN training steps on
the CPU, serves the reduced StableLM-2-12B through the LM server
(``launch/serve.py``, whose K5 wrapper ``kernels/flash_attn.py`` and LM
``models/lm.py`` import too) and imports ``chip_smoke`` (without running
it); and without
CUDA the port's default device raises instead of falling back to the
CPU.
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
                                 "cpu", "--deconv-impl", "sd_kernel"])
assert len(g_hist) == 2, g_hist
import repro_torch.kernels.flash_attn
import repro_torch.models.lm
from repro_torch.launch import serve
lm_results = serve.main(["--arch", "stablelm-12b", "--reduced", "--device",
                         "cpu", "--requests", "4"])
assert sorted(lm_results) == [0, 1, 2, 3], lm_results
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
    out = subprocess.run([sys.executable, "-c", CODE.format(repo=REPO)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert (tmp_path / "sd_calib.json").exists()


def test_sources_import_nothing_of_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import repro(\.|$| )"
                     r"|from repro(\.| ))")
    files = [os.path.join(REPO, "chip_smoke.py")]
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
