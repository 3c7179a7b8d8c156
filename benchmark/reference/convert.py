"""The benchmark reference's frozen copy of reina_tpu_torch/convert.py.

Numpy values → the port's tensors on a device.

Used by ``build_run`` for its own host compile, and by the tests to
carry a JAX ``CompiledRun``'s parameters and state over (they pass
``np.asarray`` of each JAX leaf; this module never imports jax). Dtypes
are kept (bool, int8, int16, int32, float32). Two layouts differ from
the JAX package:

  * ``ModelArrays`` has no ``age_onehot_hi``/``age_onehot_lo``: the
    port's ``expand_by_age`` is a gather (extra fields are ignored);
  * ``DayCarry.bkt_dst`` gets one spare slot past its N·64 entries, the
    drop target of the day step's bucket scatters; ``day`` becomes a
    host int and ``weekly_leftover`` stays a host float32 array.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.schedule import Schedules
from .core.state import AgentState, DayCarry
from .core.step import ModelArrays


def tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order="C", copy=True)).to(device)


def _fields(src) -> Mapping[str, Any]:
    return src if isinstance(src, Mapping) else src._asdict()


def model_arrays(src, device) -> ModelArrays:
    f = _fields(src)
    return ModelArrays(**{k: tensor(f[k], device)
                          for k in ModelArrays._fields})


def schedules(src, device) -> Schedules:
    f = _fields(src)
    return Schedules(**{k: tensor(f[k], device) for k in Schedules._fields})


def agent_state(src, device) -> AgentState:
    f = _fields(src)
    return AgentState(**{k: tensor(f[k], device)
                         for k in AgentState._fields})


def day_carry(src, device) -> DayCarry:
    f = dict(_fields(src))
    n = np.asarray(f["bkt_fill"]).shape[0]
    out = {k: tensor(f[k], device) for k in DayCarry._fields
           if k not in ("day", "weekly_leftover", "bkt_dst")}
    out["day"] = int(np.asarray(f["day"]))
    out["weekly_leftover"] = np.asarray(f["weekly_leftover"], np.float32)
    out["bkt_dst"] = tensor(np.concatenate(
        [np.asarray(f["bkt_dst"], np.int32), np.array([n], np.int32)]),
        device)
    return DayCarry(**out)


def to_numpy(nt) -> dict:
    """A NamedTuple of tensors/host values as a dict of numpy arrays."""
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in nt._asdict().items()}
