"""ctypes bindings for the native shared-memory KV store (port of
reina_tpu/runtime/shm.py).

The library is built at first use from the repository's
``cpp/shmcache/shmcache.cpp`` with ``cpp/Makefile``'s flags, into the
port's own ``build/reina_tpu_torch/shmcache/`` (the Makefile's target
lies in the JAX package's tree):

    g++ -O2 -fPIC -std=c++17 -Wall -Wextra -shared \\
        -o build/reina_tpu_torch/shmcache/libshmcache.so \\
        cpp/shmcache/shmcache.cpp -lpthread -lrt
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "cpp" / "shmcache" / "shmcache.cpp"
_LIB_PATH = _REPO / "build" / "reina_tpu_torch" / "shmcache" / "libshmcache.so"
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]


def _ensure_built() -> str:
    if not _LIB_PATH.exists():
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_CXXFLAGS, "-shared",
                        "-o", str(tmp), str(_SRC), "-lpthread", "-lrt"],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    return str(_LIB_PATH)


_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_ensure_built())
            lib.shmcache_open.restype = ctypes.c_void_p
            lib.shmcache_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.shmcache_set.restype = ctypes.c_int
            lib.shmcache_set.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint32, ctypes.c_double]
            lib.shmcache_get.restype = ctypes.c_int64
            lib.shmcache_get.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint64]
            lib.shmcache_delete.restype = ctypes.c_int
            lib.shmcache_delete.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
            lib.shmcache_close.argtypes = [ctypes.c_void_p]
            lib.shmcache_unlink.argtypes = [ctypes.c_char_p]
            _lib = lib
    return _lib


class ShmKV:
    """A named, process-shared KV segment with per-key TTLs."""

    def __init__(self, name: str, capacity: int = 256 << 20):
        self._lib = _load()
        self._name = name.encode()
        self._h = self._lib.shmcache_open(self._name, capacity)
        if not self._h:
            raise OSError(f"shmcache_open({name!r}) failed")

    def set(self, key: bytes, value: bytes, ttl: float = 0.0) -> None:
        rc = self._lib.shmcache_set(self._h, key, len(key), value,
                                    len(value), ttl)
        if rc != 0:
            raise OSError(f"shmcache_set failed: {rc}")

    def get(self, key: bytes) -> Optional[bytes]:
        buf_size = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(buf_size)
            n = self._lib.shmcache_get(self._h, key, len(key), buf, buf_size)
            if n == 0:
                return None
            if n < 0:
                buf_size = -n
                continue
            return buf.raw[:n]

    def delete(self, key: bytes) -> None:
        self._lib.shmcache_delete(self._h, key, len(key))

    def close(self) -> None:
        if self._h:
            self._lib.shmcache_close(self._h)
            self._h = None

    @staticmethod
    def unlink(name: str) -> None:
        _load().shmcache_unlink(name.encode())
