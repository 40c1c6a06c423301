"""Build and load the package's hand-written CUDA kernels.

The sources under csrc/ are compiled at first use by nvcc into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded with ctypes.
The library lands in build/kernels/<hash>/ at the repository root, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads as is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SOURCES = (_PKG / "csrc" / "impact_resonator.cu",)
_BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
BUILD_SECONDS = 0.0  # wall time of the build this process did (0 when it loaded a cached one)
BUILD_LOG = ""  # nvcc's output for that build (ptxas register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH) — the CUDA "
                       "kernels are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libmesheditor_kernels.so"


def _build(out: Path) -> None:
    global BUILD_SECONDS, BUILD_LOG
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_out), *map(str, _SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp_out, out)  # atomic: a concurrent loader sees all or nothing
    (out.parent / "build.log").write_text(BUILD_LOG)
    BUILD_SECONDS = time.perf_counter() - t0


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises when nvcc is missing or fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.impact_resonator.argtypes = [ptr] * 11 + [i32] * 4 + [ptr]
    lib.impact_resonator.restype = i32
    lib.impact_resonator_partials.argtypes = [i32, i32]
    lib.impact_resonator_partials.restype = i32
    _LIB = lib
    return lib
