"""Build and bind the CUDA kernels in ``csrc/``.

nvcc compiles each ``csrc/*.cu`` into an object, one process per source,
all started together, and links them into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), for
sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu     # each source
    nvcc -shared -o build/reina_tpu_torch/libreina_kernels_<hash>.so *.o

The library lands in ``build/reina_tpu_torch/`` at the repository root,
named by a hash of the sources, and is built at first use. It is loaded
with ctypes: every pointer and the stream are ``c_void_p``, and each C
entry point returns ``cudaGetLastError()`` after its launches, on which
:func:`check` raises. Every kernel entry point but the draw's, the
samplers' also takes an optional array of CUDA events
that it records around each launch. ``daygraph.cu`` also has the entry
points that assemble, launch and free a day graph (``reina_dg_*``, each
returning its cudaError_t).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reina_tpu_torch"

# nvcc's flags for every object: Hopper only, C++17, position-independent
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
_Q = ctypes.c_ulonglong
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
# a pick's arguments (csrc/daygraph.cu: reina_fold_set)
_PICK = [_P, _IP, _I, _I, _I] * 2 + [_P, _P, _I, _I, _P, _P, _P]

# C entry points and their argument types (see the .cu files)
_SIGNATURES = {
    "reina_ledger_grants": [_P] * 9 + [_L, _L, _P, _I, _P, _P],
    "reina_concat_prefix": [_P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P],
    "reina_onehot_sum": [_P, _I, _P, _P, _P, _L, _I, _P, _P],
    "reina_fn_onehot_output_masks": [_P] * 12 + [_L] + [_I] * 5 + [_P, _P],
    "reina_bihistogram": [_P] * 3 + [_I] + [_P] * 3 + [_L, _I, _I, _P, _P],
    "reina_post": [_P, _P, _I, _P, _L, _P, _P],
    "reina_ledger_fold_slab": [_P] * 7 + [_L, _L, _L, _P, _I, _P, _P],
    "reina_ledger_emit_slab": [_P] * 10 + [_L, _L, _L, _P, _I, _I, _I, _P,
                                           _P],
    "reina_prefix_row_totals": [_P] * 5 + [_L] + [_I] * 5 + [_P, _P],
    "reina_prefix_emit_slab": [_P] * 8 + [_L] + [_I] * 5 + [_P] * 4,
    "reina_draw": [_P, _L, _L, _U, _U, _P, _I, _F, _F, _P],
    "reina_gamma_fixed": [_P, _L, _I, _P, _P, _I, _P, _P, _P],
    "reina_binomial_fixed": [_P, _P, _P, _L, _P, _P, _I, _P, _P],
    "reina_fold_bytes": [],
    "reina_fold_set": [_P, _I, _I] + _PICK,
    "reina_max_pick": [_P, _L, _P, _P, _P, _P],
    "reina_dg_create": [_PP],
    "reina_dg_child": [_P, _P, _P, _PP],
    "reina_dg_handle": [_P, ctypes.POINTER(_Q)],
    "reina_dg_memcpy": [_P, _P, _P, _P, _L, _PP],
    "reina_dg_cond": [_P, _P, _Q, _I, _I, _PP, _PP],
    "reina_dg_instantiate": [_P, _PP],
    "reina_dg_launch": [_P, _P],
    "reina_dg_destroy": [_P, _P],
    "reina_dg_node_types": [_P, _IP],
    "reina_stop_alloc": [_PP, _PP],
    "reina_stop_free": [_P],
    "reina_dg_gate": [_P, _P, _P, _PP, _PP],
    "reina_dg_capture_leaf": [_P, _PP, _IP],
    "reina_dg_split": [_P, _PP, _I, _PP, _IP],
    "reina_error_string": [_I],
}
# entry points that return other than a cudaError_t
_RESTYPES = {"reina_error_string": ctypes.c_char_p}

_lib = None
_lib_lock = threading.Lock()
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
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = tmp.with_name(f"{src.stem}.{os.getpid()}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name} ({proc.returncode}):\n{err}")
    if not errors:
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                           + [str(o) for o in objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            errors.append(f"link ({r.returncode}):\n{r.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built at first call; threads that call
    at once wait for one build)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = so
    return _lib


def build_variant(file: str, entry: str, name: str, cuts=()):
    """A timing-only variant of ``csrc/<file>``: each ``(old, new)`` of
    ``cuts`` replaced in its source (``old`` must be there), compiled
    alone into ``build/reina_tpu_torch/parts/<name>.so``. Returns its C
    entry point ``entry``, bound as :func:`lib` binds it."""
    src = (CSRC / file).read_text()
    for old, new in cuts:
        if old not in src:
            raise RuntimeError(f"{file} no longer has {old!r}")
        src = src.replace(old, new)
    out = BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    r = subprocess.run([nvcc_path(), *_NVCC_FLAGS, "-shared", "-I", str(CSRC),
                        "-o", str(so), str(cu)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = _SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def event_handles(events):
    """None, or the handles of recorded ``torch.cuda.Event``s as the C
    array an entry point records them into (its ``void* const*``)."""
    if events is None:
        return None
    return (_P * len(events))(*(e.cuda_event for e in events))


def pointers(tensors):
    """The data pointers of ``tensors`` as the C array an entry point
    takes (its ``const void* const*``)."""
    return (_P * len(tensors))(*(t.data_ptr() for t in tensors))


def stream_of(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
