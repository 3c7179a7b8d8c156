"""Dependency-aware memoization (reference: calc/utils.py ``@calcfunc``;
a copy of reina_tpu/utils/memoize.py with two additions, ``key_args``
and ``resolved_variables``).

A decorated function declares the simulation variables, other calcfuncs
and files it depends on; the cache key is a hash of the resolved
variable values, the transitive function bytecode and file mtimes, so
edits to code, config or data invalidate results automatically — the
same run-identity scheme the reference uses to dedupe simulation runs
across workers (calc/utils.py:24-72).
"""
from __future__ import annotations

import functools
import hashlib
import inspect
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..config import variables as var_mod

CACHE_TTL_S = 3600


class _CacheEntry:
    __slots__ = ("value", "expires")

    def __init__(self, value: Any, ttl: float):
        self.value = value
        self.expires = time.monotonic() + ttl


_cache: Dict[str, _CacheEntry] = {}


def clear_cache() -> None:
    _cache.clear()


def _collect(func: Callable, attr: str) -> List[Any]:
    out = list(getattr(func, attr, []) or [])
    for dep in getattr(func, "_calcfunc_funcs", []) or []:
        out.extend(_collect(dep, attr))
    return out


def generate_cache_key(func: Callable, var_store: Optional[dict] = None) -> str:
    """Deterministic run identity: name + md5(variables) + md5(code+files)."""
    var_names = sorted(set(_collect(func, "_calcfunc_variables")))
    var_values = {
        name: var_mod.get_variable(name, var_store=var_store)
        for name in var_names
    }
    var_hash = hashlib.md5(
        json.dumps(var_values, sort_keys=True).encode("utf8")).hexdigest()

    h = hashlib.md5()
    seen = set()

    def add_code(f: Callable) -> None:
        if f in seen:
            return
        seen.add(f)
        target = inspect.unwrap(f)
        h.update(target.__code__.co_code)
        for dep in getattr(f, "_calcfunc_funcs", []) or []:
            add_code(dep)

    add_code(func)
    for path in sorted(set(_collect(func, "_calcfunc_filedeps"))):
        try:
            h.update(str(os.path.getmtime(path)).encode("ascii"))
        except OSError:
            h.update(b"missing")
    return f"{func.__name__}-{var_hash}-{h.hexdigest()}"


def resolved_variables(func: Callable,
                       var_store: Optional[dict] = None) -> Dict[str, Any]:
    """The {name: value} dict a calcfunc receives as ``variables``: its
    declared variables and those of its dependencies, resolved from
    ``var_store`` (a plain dict of overrides) or the active store."""
    return {name: var_mod.get_variable(name, var_store=var_store)
            for name in sorted(set(_collect(func, "_calcfunc_variables")))}


def calcfunc(variables: Optional[List[str]] = None,
             funcs: Optional[List[Callable]] = None,
             filedeps: Optional[List[str]] = None,
             key_args: Sequence[str] = ()):
    """Decorator. The wrapped function may accept a ``variables`` kwarg,
    which receives the resolved {name: value} dict. The call kwargs
    named in ``key_args`` (e.g. the device a run is placed on) join the
    cache key, with the function's defaults for those not given.

    Extra call kwargs: ``skip_cache``, ``only_if_in_cache``,
    ``variable_store`` (a plain dict of overrides)."""
    var_names = variables or []

    def decorator(func: Callable):
        sig = inspect.signature(func)
        accepts_vars = "variables" in sig.parameters

        @functools.wraps(func)
        def wrapper(*args, skip_cache: bool = False,
                    only_if_in_cache: bool = False,
                    variable_store: Optional[dict] = None, **kwargs):
            key = generate_cache_key(wrapper, var_store=variable_store)
            for name in key_args:
                val = kwargs.get(name, sig.parameters[name].default)
                key += f"-{name}={val}"
            if not skip_cache:
                ent = _cache.get(key)
                if ent is not None and ent.expires > time.monotonic():
                    return ent.value
            if only_if_in_cache:
                return None
            if accepts_vars:
                kwargs["variables"] = resolved_variables(wrapper,
                                                         variable_store)
            ret = func(*args, **kwargs)
            _cache[key] = _CacheEntry(ret, CACHE_TTL_S)
            return ret

        wrapper._calcfunc_variables = var_names
        wrapper._calcfunc_funcs = funcs or []
        wrapper._calcfunc_filedeps = filedeps or []
        return wrapper

    return decorator
