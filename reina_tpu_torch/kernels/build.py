"""Build and bind the CUDA kernels in ``csrc/``.

nvcc compiles every ``csrc/*.cu`` into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/reina_tpu_torch/libreina_kernels_<hash>.so csrc/*.cu

The library lands in ``build/reina_tpu_torch/`` at the repository root,
named by a hash of the sources, and is built at first use. It is loaded
with ctypes: every pointer and the stream are ``c_void_p``, and each C
entry point returns ``cudaGetLastError()`` after its launches, on which
:func:`check` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reina_tpu_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points and their argument types (see the .cu files)
_SIGNATURES = {
    "reina_ledger_scan": [_P] * 8 + [_P, _P, _L, _L, _I, _P],
    "reina_concat_prefix": [_P, _P, _P, _P, _L, _I, _I, _P],
    "reina_onehot_sum": [_P, _P, _P, _P, _L, _I, _I, _P],
}

_lib = None
build_seconds = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libreina_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp)] + [str(p) for p in _sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
