"""Build the port's CUDA sources into shared libraries and load them.

Each source in ``difformer_tpu_torch/csrc/*.cu`` has a plain C interface:
``nvcc`` compiles it for Hopper (``sm_90a``) into a shared library of its
own under ``difformer_tpu_torch/_build/`` (listed in ``.gitignore``), one
``nvcc`` process for each source, all started together, and ``ctypes``
loads them. The build happens at first use, so the first kernel call of a
process compiles; later calls, and later processes with the same sources,
reuse the libraries (each name carries a hash of its source, the headers
and the flags). Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import types
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
# argtypes of every C entry point, by source
SIGNATURES = {
    "sigmoid_attention.cu": {
        "sigattn_fwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I,
                        _I, _I, _I, _I] + _STRIDES + [_P],
        "sigattn_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I,
                       _I, _I, _I] + _STRIDES + [_P],
        "sigattn_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                        _I, _I, _I, _I, _I] + _STRIDES + [_P],
    },
    "spmm.cu": {
        "csr_spmm": [_P, _P, _P, _P, _P, _I64, _I64, _I, _P, _P, _P, _P,
                     _I64, _I64, _P, _P],
    },
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
    return sorted(SOURCE_DIR.glob("*.cu"))


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [source, *sorted(SOURCE_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose library of the same hash is missing, one
    ``nvcc`` each, all at once; returns {source name: library path}.

    Records the wall time of the build and the compiler's report
    (registers, shared memory, spills from ``-Xptxas -v``) in
    :data:`build_info`."""
    targets = {src.name: library_path(src) for src in _sources()}
    missing = [src for src in _sources() if not targets[src.name].exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    logs = []
    try:
        for src in missing:
            tmp = targets[src.name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs.append((src, cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for src, cmd, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{out}\n{err}")
            # atomic: a concurrent build sees whole files
            os.replace(tmp, targets[src.name])
            logs.append(out + err)
    finally:
        for _, _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    build_info.update(paths=[str(p) for p in targets.values()],
                      seconds=time.perf_counter() - t0, cached=not missing,
                      log="".join(logs))
    return targets


def load_library() -> types.SimpleNamespace:
    """Every C entry point of the kernel libraries, as attributes, building
    them at first use."""
    global _library
    if _library is None:
        entries = {}
        for name, path in build().items():
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                entries[fn_name] = fn
        _library = types.SimpleNamespace(**entries)
    return _library
