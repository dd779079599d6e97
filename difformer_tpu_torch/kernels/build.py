"""Build the port's CUDA sources into one shared library and load it.

The sources in ``difformer_tpu_torch/csrc/*.cu`` have a plain C interface:
``nvcc`` compiles them for Hopper (``sm_90a``) into a shared library under
``difformer_tpu_torch/_build/`` (listed in ``.gitignore``), and ``ctypes``
loads it. The build happens at first use, so the first kernel call of a
process compiles; later calls, and later processes with the same sources,
reuse the library (its name carries a hash of the sources and flags).
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_STRIDES = [_I64] * 9
# argtypes of every C entry point (see csrc/sigmoid_attention.cu)
SIGNATURES = {
    "sigattn_fwd": [_I, _I, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I]
    + _STRIDES + [_P],
    "sigattn_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I]
    + _STRIDES + [_P],
    "sigattn_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I]
    + _STRIDES + [_P],
}

_library = None
build_info: dict = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc was not found on PATH or under $CUDA_HOME; the CUDA toolkit is "
        "needed to build the port's kernels")


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libdifformer_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists.

    Records the wall time and the compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) in :data:`build_info`."""
    target = library_path()
    if target.exists():
        build_info.update(path=str(target), seconds=0.0, cached=True, log="")
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent build sees whole files
    build_info.update(path=str(target), seconds=seconds, cached=False,
                      log=proc.stdout + proc.stderr)
    return target


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it at first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library
