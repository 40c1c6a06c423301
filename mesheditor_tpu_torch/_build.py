"""Build and load the package's native code: the hand-written CUDA kernels and the
Delaunay tet mesher.

The sources under csrc/ are compiled at first use by nvcc, one process per source, all
started together, then linked into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds) and loaded with ctypes. The library lands in
build/kernels/<hash>/ at the repository root, keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads as is.

The tet mesher (native/tetmesher.cpp, read only) is compiled the same way by the host C++
compiler into build/native/<hash>/: nothing is written beside the source, and the
checked-in native/libtetmesher.so, built on some other machine, is never loaded.
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
_SOURCES = tuple(_PKG / "csrc" / name for name in (
    "impact_resonator.cu", "coupled_resonator.cu", "strike_precompute.cu"))
_BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_MESHER_SOURCE = _PKG.parent / "native" / "tetmesher.cpp"
_MESHER_ROOT = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")  # native/Makefile's flags

_LIB = None
_MESHER = None
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        logs = [(src.name, proc.communicate()[0], proc.returncode)
                for src, proc in zip(_SOURCES, procs)]
        BUILD_LOG = "".join(f"== {name}\n{log}" for name, log, _rc in logs)
        failed = [f"{name} ({rc})" for name, _log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{BUILD_LOG}")
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp_out), *map(str, objs)],
                              capture_output=True, text=True)
        BUILD_LOG += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{BUILD_LOG}")
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
    lib.coupled_resonator.argtypes = [ptr] * 19 + [i32] * 6 + [ptr]
    lib.coupled_resonator.restype = i32
    lib.coupled_resonator_plan.argtypes = [i32, i32, i32, ptr]
    lib.coupled_resonator_plan.restype = i32
    lib.strike_precompute.argtypes = [ptr] * 13 + [i32] * 7 + [ctypes.c_float, ptr]
    lib.strike_precompute.restype = i32
    _LIB = lib
    return lib


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH) — the tet mesher "
                       "is built from native/tetmesher.cpp at first use")


def mesher_path(source: Path = _MESHER_SOURCE) -> Path:
    """Where the library for `source` lives: keyed by the source, the flags and the
    compiler's version, so a build/ directory carried to a machine with another compiler
    is not picked up there."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256()
    h.update(source.read_bytes())
    h.update(" ".join((cxx, version, *CXX_FLAGS)).encode())
    return _MESHER_ROOT / h.hexdigest()[:16] / "libtetmesher.so"


def build_tetmesher(source: Path = _MESHER_SOURCE) -> Path:
    """The mesher library for `source`, compiled unless its build is already there. Raises
    with the compiler's output when the source is missing or does not compile."""
    if not source.exists():
        raise RuntimeError(f"tet mesher source not found: {source}")
    out = mesher_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp_out), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {source.name} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_out, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load_tetmesher() -> ctypes.CDLL:
    """The tet mesher library, built on first use. Raises when it cannot be built or
    loaded; a caller must not take that for a surface the mesher could not mesh."""
    global _MESHER
    if _MESHER is not None:
        return _MESHER
    lib = ctypes.CDLL(str(build_tetmesher()))
    u64, f64 = ctypes.c_uint64, ctypes.c_double
    pd, pu32, pu64 = (ctypes.POINTER(t) for t in (f64, ctypes.c_uint32, u64))
    lib.tetmesh_delaunay.restype = ctypes.c_int
    lib.tetmesh_delaunay.argtypes = [pd, u64, pu32, u64, f64, f64, pd, pu32, pu64, pd, pu64, pd]
    _MESHER = lib
    return lib
