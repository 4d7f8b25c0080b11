"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface, is compiled for
``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` under the
repository root at first use (keyed by a hash of the source, of every
``csrc/*.cuh`` header and of the flags, so an edited source or header
rebuilds), and is loaded with ``ctypes``.
Nothing here runs at import time.  :func:`build` starts one ``nvcc`` per
source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signature of each library's C entry point (c_void_p for every
# pointer and the stream, c_int for every int, c_longlong for every
# 64-bit stride, c_float for every float).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
SIGNATURES = {
    "sd_fused": ("sd_fused_launch", [_P] * 5 + [_I] * 21 + [_P]),
    "sd_fused_int8": ("sd_fused_int8_launch", [_P] * 5 + [_I] * 24 + [_P]),
    "sd_conv": ("sd_conv_launch", [_P] * 4 + [_I] * 15 + [_P]),
    "sd_conv_int8": ("sd_conv_int8_launch", [_P] * 3 + [_I] * 17 + [_P]),
    "sd_filter_grad": ("sd_filter_grad_launch", [_P] * 4 + [_I] * 13 + [_P]),
    "sd_wino": ("sd_wino_launch", [_P] * 5 + [_I] * 27 + [_P]),
    "flash_attn": ("flash_attn_launch",
                   [_P] * 4 + [_I] * 8 + [_L] * 12 + [_F, _P]),
}


@dataclass
class Built:
    """A loaded kernel library and what building it reported."""
    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float          # nvcc wall time (0.0 when the .so was cached)
    ptxas: str              # nvcc's -Xptxas -v report (registers, smem)

    @property
    def fn(self):
        return getattr(self.lib, SIGNATURES[self.name][0])


_LOADED: Dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _load(name: str, path: Path, seconds: float, ptxas: str) -> Built:
    lib = ctypes.CDLL(str(path))
    sym, argtypes = SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return Built(name, path, lib, seconds, ptxas)


def build(names: Iterable[str]) -> Dict[str, Built]:
    """Build (in parallel) and load every named source not loaded yet;
    raises with nvcc's output when one fails."""
    names = [n for n in dict.fromkeys(names) if n not in _LOADED]
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if name not in SIGNATURES:
            raise KeyError(f"unknown kernel source {name!r}")
        out = _target(name)
        if out.exists():
            _LOADED[name] = _load(name, out, 0.0, "")
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (rc {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        _LOADED[name] = _load(name, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: _LOADED[n] for n in names}


def load(name: str) -> Built:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    if name not in _LOADED:
        build([name])
    return _LOADED[name]
