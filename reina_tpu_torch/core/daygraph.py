"""The day as one CUDA graph with its tier picks on the device, and the
pick kernel (reina_tpu_torch/kernels/csrc/daygraph.cu) with its twin.

A pick (``step.Pick``, one or two of them before each conditional span of
``step.day_program``) reads its counts where the span before it left them
and takes the JAX package's searchsorted into the tier ceilings, clamped
to the last branch (``step.tier_branch`` on the host). On the card the
pick kernel sets the conditional node that follows it; in both forms it
writes the branch into row ``counter`` of the run's picks table, adds one
to the branch's tally and ORs the overflow bits into the carry's problem
bits, as the reference sets them on the device.

:class:`DayGraph` assembles a host key's day from the spans' captured
graphs: a span the schedule fixes is a child-graph node; a pick is a
kernel node followed by a conditional node: an if for the tracing cond,
a switch over the tiers of a tiered span whose branch bodies are that
span's captures at each tier. One launch runs the day.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import step as S
from .. import kernels

# node types a conditional body may hold (cudaGraphNodeType): kernel,
# memcpy, memset, child graph, empty, conditional
_BODY_NODES = {0: "kernel", 1: "memcpy", 2: "memset", 4: "graph",
               5: "empty", 13: "conditional"}
_IF, _SWITCH = 0, 1
# the most tier ceilings a pick's count has (csrc/daygraph.cu)
MAX_ENDS = 24


class GraphError(RuntimeError):
    """A span's capture, a day graph's assembly or a launch failed."""


def pick_twin(counts, picks, table, counter, col: int, tally, problem):
    """The pick kernel on tensors: ``counts`` the 0-d int32 count of each
    ``step.Pick`` of ``picks``; writes the branch into
    ``table[counter, col]``, adds one to ``tally[branch]``, ORs the
    overflow bits into ``problem`` (0-d int32), all in place. Returns
    the branch (0-d int64)."""
    dev = table.device
    branch = torch.zeros((), dtype=torch.int64, device=dev)
    for x, p in zip(counts, picks):
        if p.bit:
            problem.bitwise_or_(torch.where(x > p.cap, p.bit, 0).to(
                problem.dtype))
        y = x if p.cap is None else torch.clamp_max(x, p.cap)
        ends = torch.tensor(p.ends, dtype=torch.int32, device=dev)
        b = torch.searchsorted(ends, y.reshape(1), side="left")[0]
        branch = branch * len(p.ends) + torch.clamp_max(b, len(p.ends) - 1)
    i = counter.view(1)
    table.index_put_((i, torch.full_like(i, col)),
                     branch.to(table.dtype).reshape(1))
    tally.index_put_((branch.reshape(1),),
                     torch.ones(1, dtype=tally.dtype, device=dev),
                     accumulate=True)
    return branch


def _pick_args(counts, picks, table, counter, col, tally, problem):
    if not 1 <= len(picks) <= 2 or len(counts) != len(picks):
        raise ValueError("a pick reads one or two counts")
    args = []
    for k in range(2):
        if k < len(picks):
            x, p = counts[k], picks[k]
            if len(p.ends) > MAX_ENDS:
                raise ValueError(f"count {p.src}: {len(p.ends)} tiers, the "
                                 f"pick kernel takes at most {MAX_ENDS}")
            if x.dtype != torch.int32 or x.numel() != 1:
                raise ValueError(f"count {p.src}: {x.dtype} {tuple(x.shape)}"
                                 ", want one int32")
            args += [x.data_ptr(), (ctypes.c_int * len(p.ends))(*p.ends),
                     len(p.ends), -1 if p.cap is None else p.cap, p.bit]
        else:
            args += [None, None, 0, -1, 0]
    for t, dt in ((table, torch.int32), (counter, torch.int64),
                  (tally, torch.int32), (problem, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"pick: {t.dtype} {tuple(t.shape)}, want a "
                             f"contiguous {dt}")
    return args + [table.data_ptr(), counter.data_ptr(), table.shape[1], col,
                   tally.data_ptr(), problem.data_ptr()]


def pick(counts, picks, table, counter, col: int, tally, problem):
    """One pick outside a graph: the kernel on CUDA tensors (no
    conditional to set; the check against the twin), the twin on the
    CPU. Returns the branch as the twin does, or None from the kernel."""
    if table.device.type != "cuda":
        return pick_twin(counts, picks, table, counter, col, tally, problem)
    from ..kernels import build
    args = _pick_args(counts, picks, table, counter, col, tally, problem)
    build.check(build.lib().reina_pick(*args, build.stream_of(table)),
                "reina_pick")
    kernels.launched("daygraph.pick")
    return None


def _check(err: int, what: str) -> None:
    if err != 0:
        from ..kernels import build
        msg = build.lib().reina_error_string(err).decode()
        raise GraphError(f"{what}: CUDA error {err} ({msg})")


def check_body_nodes(graph: int, what: str) -> None:
    """Raise unless every node of the captured ``graph`` is of a type a
    conditional body may hold."""
    from ..kernels import build
    counts = (ctypes.c_int * 32)()
    _check(build.lib().reina_dg_node_types(graph, counts), what)
    bad = {t: n for t, n in enumerate(counts) if n and t not in _BODY_NODES}
    if bad:
        raise GraphError(f"{what}: nodes of types {bad} (cudaGraphNodeType), "
                         "which a conditional body cannot hold")


class DayGraph:
    """A host key's day (``step.day_program``) as one instantiated CUDA
    graph over the captured spans of ``gs`` (a graphs.GraphSet)."""

    def __init__(self, hkey: tuple, nodes, gs):
        from ..kernels import build
        self.graph = self.exec = None
        self.lib = build.lib()
        self.hkey = hkey
        # launches of the spans every launch runs (the branches' come
        # from the tallies)
        self.fixed = Counter()
        g = ctypes.c_void_p()
        _check(self.lib.reina_dg_create(ctypes.byref(g)), self._what("create"))
        self.graph = g
        self._add(g, nodes, gs)
        ex = ctypes.c_void_p()
        _check(self.lib.reina_dg_instantiate(g, ctypes.byref(ex)),
               self._what("instantiate"))
        self.exec = ex

    def _what(self, step: str) -> str:
        return f"day graph {self.hkey}: {step}"

    def _child(self, graph, dep, entry, what):
        node = ctypes.c_void_p()
        _check(self.lib.reina_dg_child(graph, dep, entry.run.raw_cuda_graph(),
                                       ctypes.byref(node)), self._what(what))
        return node

    def _add(self, graph, nodes, gs) -> None:
        dep = None
        for node in nodes:
            if isinstance(node, S.Span):
                entry = gs.entry(self.hkey, node.name, node.key)
                dep = self._child(graph, dep, entry, f"span {node.name}")
                self.fixed.update(entry.tally)
                continue
            col, slot, n = gs.layout[node.name]
            h = ctypes.c_ulonglong()
            _check(self.lib.reina_dg_handle(graph, ctypes.byref(h)),
                   self._what(f"handle of {node.name}"))
            counts = [gs.count(p) for p in node.picks]
            args = _pick_args(counts, node.picks, gs.picks, gs.counter, col,
                              gs.tally[slot:slot + n], gs.carry["problem"])
            pnode = ctypes.c_void_p()
            _check(self.lib.reina_dg_pick(graph, dep, *args, h,
                                          ctypes.byref(pnode)),
                   self._what(f"pick of {node.name}"))
            size = 1 if isinstance(node, S.If) else n
            bodies = (ctypes.c_void_p * size)()
            dep = ctypes.c_void_p()
            _check(self.lib.reina_dg_cond(
                graph, pnode, h, _IF if isinstance(node, S.If) else _SWITCH,
                size, ctypes.byref(dep), bodies),
                self._what(f"conditional {node.name}"))
            if isinstance(node, S.If):
                self._add(bodies[0], node.body, gs)
            else:
                for b, key in enumerate(node.keys()):
                    self._child(bodies[b], None,
                                gs.entry(self.hkey, node.name, key),
                                f"branch {node.name} {key}")

    def launch(self, stream: int) -> None:
        _check(self.lib.reina_dg_launch(self.exec, stream),
               self._what("launch"))

    def __del__(self):
        if self.graph is not None or self.exec is not None:
            self.lib.reina_dg_destroy(self.graph, self.exec)
