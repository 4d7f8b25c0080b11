"""Shared fixtures.  The one thing tests cannot do in-process is grow
the device count — jax fixes it at backend init — so multi-device
coverage (tests/test_shard.py, the ci.sh shard gates) runs snippets in
a subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count``.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def multi_device_run():
    """Run a python snippet on ``ndev`` simulated CPU devices; returns
    stdout, asserts exit 0 (stderr tail included in the failure)."""
    def run(code: str, ndev: int = 2, timeout: int = 480) -> str:
        env = dict(
            os.environ,
            PYTHONPATH=(os.path.join(REPO, "src") + os.pathsep +
                        os.environ.get("PYTHONPATH", "")),
            XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                       f" --xla_force_host_platform_device_count={ndev}"))
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True,
            text=True, env=env, cwd=REPO, timeout=timeout)
        assert out.returncode == 0, (
            f"multi-device subprocess failed (ndev={ndev}):\n"
            f"--- stdout ---\n{out.stdout[-2000:]}\n"
            f"--- stderr ---\n{out.stderr[-4000:]}")
        return out.stdout
    return run


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips with the "
        "reason where there is none")
