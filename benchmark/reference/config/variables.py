"""The benchmark reference's frozen copy of reina_tpu_torch/config/variables.py.

Layered simulation-variable store (reference: variables.py).

Layers, lowest priority first:
  1. packaged defaults (``defaults.json``)
  2. a deployment override set selected with ``VARIABLE_OVERRIDE_SET``
     (``override_sets.json``; e.g. ``turku``)
  3. per-session overrides (a ``VariableStore`` instance — the
     framework equivalent of the reference's Flask-session layer)
  4. programmatic overrides guarded by ``allow_set_variable()``

Unlike the reference, sessions are plain objects instead of Flask
globals, so the engine and services can hold independent stores. The
module-level functions keep the reference's API for familiarity.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Dict, Iterator, Optional

_CONFIG_DIR = os.path.dirname(__file__)

with open(os.path.join(_CONFIG_DIR, "defaults.json"), "r", encoding="utf8") as _f:
    VARIABLE_DEFAULTS: Dict[str, Any] = json.load(_f)

with open(os.path.join(_CONFIG_DIR, "override_sets.json"), "r", encoding="utf8") as _f:
    VARIABLE_OVERRIDE_SETS: Dict[str, Dict[str, Any]] = json.load(_f)

_override_set = os.getenv("VARIABLE_OVERRIDE_SET")
if _override_set:
    if _override_set not in VARIABLE_OVERRIDE_SETS:
        raise KeyError(f"unknown VARIABLE_OVERRIDE_SET: {_override_set}")
    VARIABLE_DEFAULTS.update(VARIABLE_OVERRIDE_SETS[_override_set])

# Hash of the effective defaults; sessions created against other
# defaults invalidate themselves (reference variables.py:446,475).
DEFAULT_VARIABLE_HASH = hashlib.md5(
    json.dumps(VARIABLE_DEFAULTS, sort_keys=True).encode("utf8")).hexdigest()


class VariableStore:
    """A mutable override layer on top of the packaged defaults."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._overrides: Dict[str, Any] = dict(overrides or {})
        self.default_hash = DEFAULT_VARIABLE_HASH

    def get(self, name: str) -> Any:
        if self.default_hash != DEFAULT_VARIABLE_HASH:
            self.reset()
        if name in self._overrides:
            out = self._overrides[name]
        else:
            out = VARIABLE_DEFAULTS[name]
        if isinstance(out, (list, dict)):
            return deepcopy(out)
        return out

    def set(self, name: str, value: Any) -> None:
        if name not in VARIABLE_DEFAULTS:
            raise KeyError(f"unknown variable: {name}")
        default = VARIABLE_DEFAULTS[name]
        if not isinstance(value, type(default)) and not (
                isinstance(default, float) and isinstance(value, int)):
            raise TypeError(
                f"variable {name} expects {type(default).__name__}, "
                f"got {type(value).__name__}")
        if value == default:
            self._overrides.pop(name, None)
        else:
            self._overrides[name] = value

    def reset(self, name: Optional[str] = None) -> None:
        if name is None:
            self._overrides.clear()
            self.default_hash = DEFAULT_VARIABLE_HASH
        else:
            self._overrides.pop(name, None)

    def overrides(self) -> Dict[str, Any]:
        return deepcopy(self._overrides)

    def copy_all(self) -> Dict[str, Any]:
        """Fully resolved variable dict (reference copy_variables())."""
        return {name: self.get(name) for name in VARIABLE_DEFAULTS}

    def copy(self) -> "VariableStore":
        return VariableStore(self.overrides())


# ---------------------------------------------------------------------------
# Module-level convenience API (reference-compatible).

_local = threading.local()
_global_store = VariableStore()
_allow_set = False


def _active_store() -> VariableStore:
    return getattr(_local, "store", None) or _global_store


@contextmanager
def session_store(store: Optional[VariableStore] = None) -> Iterator[VariableStore]:
    """Bind a per-session store for the current thread (the analog of a
    Flask request context in the reference)."""
    prev = getattr(_local, "store", None)
    _local.store = store if store is not None else VariableStore()
    try:
        yield _local.store
    finally:
        _local.store = prev


def get_variable(name: str, var_store: Optional[Dict[str, Any]] = None) -> Any:
    if var_store is not None:
        out = var_store.get(name)
        if out is not None:
            return deepcopy(out) if isinstance(out, (list, dict)) else out
        out = VARIABLE_DEFAULTS[name]
        return deepcopy(out) if isinstance(out, (list, dict)) else out
    return _active_store().get(name)


def set_variable(name: str, value: Any) -> None:
    store = getattr(_local, "store", None)
    if store is None and not _allow_set:
        raise RuntimeError(
            "set_variable outside a session requires allow_set_variable()")
    _active_store().set(name, value)


def reset_variable(name: str) -> None:
    _active_store().reset(name)


def reset_variables() -> None:
    _active_store().reset()


def get_session_variables() -> Dict[str, Any]:
    return _active_store().overrides()


def copy_variables() -> Dict[str, Any]:
    return _active_store().copy_all()


@contextmanager
def allow_set_variable() -> Iterator[None]:
    global _allow_set
    old = _allow_set
    _allow_set = True
    try:
        yield
    finally:
        _allow_set = old
