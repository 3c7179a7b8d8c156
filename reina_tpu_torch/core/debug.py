"""Engine debugging helpers (port of reina_tpu/core/debug.py; reference:
main.pyx person_str/dump_state, 179-206 and 2020-2045).

Each function takes the port's ``AgentState`` with tensors on any
device (or numpy arrays) and moves it to numpy once; the strings are
the JAX package's, character for character.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import constants as C
from .state import AgentState
from ..convert import to_numpy


def _numpy_state(state: AgentState) -> AgentState:
    return AgentState(**to_numpy(state))


def person_str(state: AgentState, idx: int, today: Optional[int] = None) -> str:
    """Human-readable one-line dump of one agent."""
    age = int(state.age[idx])
    st = C.STATE_TO_STR[int(state.state[idx])]
    sev = C.SEVERITY_TO_STR[int(state.severity[idx])]
    doi = int(state.day_of_infection[idx])
    parts = [f"#{idx}: {age} years"]
    if state.variant[idx]:
        parts.append(f"[variant {int(state.variant[idx])}]")
    if doi >= 0:
        ago = f" ({today - doi} days ago)" if today is not None else ""
        parts.append(f"infection on day {doi}{ago}")
    parts.append(st)
    parts.append(sev)
    parts.append(f"days left {int(state.days_left[idx])}")
    if state.queued[idx]:
        parts.append("queued for testing")
    parts.append(f"detected {int(state.was_detected[idx])}")
    parts.append(f"others infected {int(state.n_infected[idx])}")
    if state.infector[idx] >= 0:
        parts.append(f"infector #{int(state.infector[idx])}")
    return ", ".join(parts)


def dump_state(state: AgentState, today: Optional[int] = None,
               states: Optional[List[int]] = None,
               limit_per_state: int = 50) -> str:
    """Dump all agents in the in-flight disease states."""
    state = _numpy_state(state)
    states = states if states is not None else [
        C.INCUBATION, C.ILLNESS, C.HOSPITALIZED, C.IN_ICU]
    out = []
    for st in states:
        idxs = np.flatnonzero((state.state == st) & state.active)
        out.append(f"{C.STATE_TO_STR[st]}: {len(idxs)} agents")
        for idx in idxs[:limit_per_state]:
            out.append("  " + person_str(state, int(idx), today))
        if len(idxs) > limit_per_state:
            out.append(f"  … and {len(idxs) - limit_per_state} more")
        out.append("=" * 78)
    return "\n".join(out)


def infection_tree(state: AgentState, root: int, max_depth: int = 3,
                   max_children: int = 8) -> str:
    """Who-infected-whom tree rooted at an agent (the reference kept
    explicit infectee lists; this inverts the infector back-edges)."""
    state = _numpy_state(state)
    children: dict = {}
    for t, s in enumerate(state.infector):
        if s >= 0:
            children.setdefault(int(s), []).append(t)

    lines: List[str] = []

    def rec(idx: int, depth: int):
        lines.append("  " * depth + person_str(state, idx))
        if depth >= max_depth:
            return
        kids = children.get(idx, [])
        for k in kids[:max_children]:
            rec(k, depth + 1)
        if len(kids) > max_children:
            lines.append("  " * (depth + 1)
                         + f"… and {len(kids) - max_children} more")

    rec(root, 0)
    return "\n".join(lines)
