"""The day as one CUDA graph with its tier picks on the device, each made
by the kernel that produces its count, and the picks' twin.

A pick (``step.Pick``, one or two of them before each conditional node
of ``step.day_program``) takes the JAX package's searchsorted of its
counts into the tier ceilings, clamped to the last branch
(``step.tier_branch`` on the host). On the card it is made inside the
launch that produces its count (``FOLDS``, fixed pick by pick; a
:class:`Fold` is the graph runner's site for one count): the prefix
kernel that counts today's infections makes the slot pick, the one that
compacts the drained agents the tracing cond and T1's switch, the
frontier's T3's, and the reduce-and-pick ``ops/compact.py:count_max``
T2's and T4's from the members' bucket fills (csrc/pick.cuh,
csrc/prefix.cu, csrc/daygraph.cu). In both forms a pick sets the
conditional node that follows its span, writes the branch into row
``counter`` of the run's picks table, adds one to the branch's tally and
ORs the overflow bits into the carry's problem bits, as the reference
sets them on the device. The plain version of each fused entry is its
producer's twin followed by :func:`pick_twin`.

On a rank of an agent-sharded run (parallel/mesh.py) the counts are
global and the producers run after the collectives that make them so:
the sharded prefix's emit (``ops/fusedmap.py:sharded_prefix_count``,
csrc/prefix.cu) writes n_new, n_d and n_f after its all-gather of the
row totals and makes their picks (``SHARDED_FOLD_ENTRY``); the tracing
cond reads ct_cases, the all-reduced sum, in the n_d fold; the
reduce-and-pick takes T2's and T4's maxima over the members' fills that
the lookups' all-reduce replicated. Every rank makes the same picks,
so the ranks' day graphs take the same branches and the collectives
captured in them stay matched.

:class:`DayGraph` assembles a host key's day from the spans' captured
graphs: a memcpy node that fills the graph set's handle table with this
graph's conditional handles (a producing kernel is captured before the
day graphs exist and serves each of them, so it reads its handle there),
then each span a child-graph node and each pick's conditional node after
the span whose kernel set it: an if for the tracing cond, a switch over
the tiers of a tiered span whose branch bodies are that span's captures
at each tier. One launch runs the day.

On a graphed shard of the agent axis each span is gated: its capture is
split after each of its collectives (:func:`split`), and each piece
after the first is a child graph inside an if node that a one-thread
kernel sets from the graph set's stop word (csrc/daygraph.cu: the
gates). Once the host has set the word (parallel/mesh.py:give_up,
before it aborts the group), nothing after a collective runs: not the
rest of the span whose collective the abort ended, nor anything past
the first collective of a later span or of a day queued behind it. A
span's first piece reads only static buffers that no aborted collective
wrote, so it runs ungated.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import step as S

# node types a conditional body may hold (cudaGraphNodeType): kernel,
# memcpy, memset, child graph, empty, conditional
_BODY_NODES = {0: "kernel", 1: "memcpy", 2: "memset", 4: "graph",
               5: "empty", 13: "conditional"}
_IF, _SWITCH = 0, 1
# the most tier ceilings a pick's count has (csrc/pick.cuh)
MAX_ENDS = 24
# the conditionals whose picks each count's producer makes, in order; a
# fold that starts with an If makes the rest only where it takes its
# body. Every conditional of a tracing day's program is in one fold.
FOLDS = {"n_new": ("C",), "n_d": ("T", "T1"), "fill_max": ("T2",),
         "n_f": ("T3",), "fill2_max": ("T4",)}


# the launch count of each fold's producer when it makes its picks, on
# one card and on a shard of the agent axis (the sharded prefix's emit)
FOLD_ENTRY = {name: "daygraph.max_pick" if name.startswith("fill")
              else "fused_concat_prefix.pick" for name in FOLDS}
SHARDED_FOLD_ENTRY = {name: entry.replace("fused_concat_prefix",
                                          "concat_prefix_sharded")
                      for name, entry in FOLD_ENTRY.items()}


def fold_launches(picks, sharded: bool = False) -> Counter:
    """The launches of the fused entries that a graphed run's rows of
    picks imply: one of each fold's producer a day its first pick was
    made (warm-ups, which make no pick, aside); ``sharded``: of a rank of
    the agent axis."""
    entry = SHARDED_FOLD_ENTRY if sharded else FOLD_ENTRY
    rows = [list(r) for r in picks]
    out = Counter({k: 0 for k in entry.values()})
    for name, cols in FOLDS.items():
        col = S.PICK_COLS.index(cols[0])
        out[entry[name]] += sum(1 for r in rows if r[col] >= 0)
    return out


class GraphError(RuntimeError):
    """A span's capture, a day graph's assembly or a launch failed."""


def pick_twin(counts, picks, table, counter, col: int, tally, problem):
    """The pick on tensors: ``counts`` the 0-d int32 count of each
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


def fold_nodes(cfg, name: str):
    """The conditional nodes of a tracing day's program whose picks
    count ``name``'s producer makes (``FOLDS``), in order."""
    nodes = {n.name: n for n in S.conditionals(
        S.day_program(cfg, True, False, False))}
    return [nodes[c] for c in FOLDS[name]]


class Fold:
    """A count's fold site (``kernels.fold_site``): where its producer
    writes the count and the tier picks it makes in the same launch.

    ``nodes``: the conditionals whose picks it makes, in order (an If
    first: the rest only where the If takes its body); ``cols``,
    ``tallies``: each one's picks-table column and branch tally (a
    view); ``table``, ``counter``, ``problem``: the picks table, the day
    counter and the problem bits; ``lookup(pick)``: the tensor of a count
    that the producer does not hand over (a handoff buffer); ``handles``:
    the device table of conditional handles, a slot a picks-table column
    (None: no conditional to set); ``out``: where the count goes (None:
    a tensor of the producer's); ``armed``: False in a warm-up, which
    makes no pick."""

    def __init__(self, nodes, cols, tallies, table, counter, problem,
                 lookup=None, handles=None, out=None, armed=True):
        self.nodes, self.cols, self.tallies = nodes, cols, tallies
        self.table, self.counter, self.problem = table, counter, problem
        self.lookup, self.handles = lookup, handles
        self.out, self.armed = out, armed
        self.gate = isinstance(nodes[0], S.If)

    def _counts(self, node, counts):
        return [counts[p.src] if p.src in counts else self.lookup(p)
                for p in node.picks]

    def args(self, counts):
        """The kernel's Fold (csrc/pick.cuh) in host memory: ``counts``
        {name: 0-d int32 on the device} the counts the producer hands
        over (its own among them)."""
        from ..kernels import build
        lib = build.lib()
        buf = ctypes.create_string_buffer(lib.reina_fold_bytes())
        for i, (node, col, tally) in enumerate(zip(self.nodes, self.cols,
                                                   self.tallies)):
            args = _pick_args(self._counts(node, counts), node.picks,
                              self.table, self.counter, col, tally,
                              self.problem)
            handle = (None if self.handles is None
                      else self.handles[col:].data_ptr())
            _check(lib.reina_fold_set(buf, i, int(self.gate), *args, handle),
                   f"fold of {node.name}")
        return buf

    def twin(self, counts) -> None:
        """The picks on tensors, in order (:func:`pick_twin`)."""
        for i, (node, col, tally) in enumerate(zip(self.nodes, self.cols,
                                                   self.tallies)):
            b = pick_twin(self._counts(node, counts), node.picks, self.table,
                          self.counter, col, tally, self.problem)
            if i == 0 and self.gate and int(b) == 0:
                return


def _pick_args(counts, picks, table, counter, col, tally, problem):
    if not 1 <= len(picks) <= 2 or len(counts) != len(picks):
        raise ValueError("a pick reads one or two counts")
    args = []
    for k in range(2):
        if k < len(picks):
            x, p = counts[k], picks[k]
            if len(p.ends) > MAX_ENDS:
                raise ValueError(f"count {p.src}: {len(p.ends)} tiers, the "
                                 f"pick takes at most {MAX_ENDS}")
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


def _check(err: int, what: str) -> None:
    if err != 0:
        from ..kernels import build
        msg = build.lib().reina_error_string(err).decode()
        raise GraphError(f"{what}: CUDA error {err} ({msg})")


def split(graph: int, guards, what: str) -> tuple:
    """The pieces of a captured span ``graph`` (new graphs, in order), cut
    after each guard node (the node that ends a captured collective,
    ``kernels.guard_point``); the caller destroys them."""
    from ..kernels import build
    arr = (ctypes.c_void_p * max(len(guards), 1))(*guards)
    out = (ctypes.c_void_p * (len(guards) + 1))()
    n = ctypes.c_int()
    _check(build.lib().reina_dg_split(graph, arr, len(guards), out,
                                      ctypes.byref(n)), what)
    return tuple(out[i] for i in range(n.value))


def destroy_graphs(graphs) -> None:
    """Destroy graphs made by :func:`split`."""
    from ..kernels import build
    for g in graphs:
        build.lib().reina_dg_destroy(g, None)


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
        # launches and collectives of the spans every launch runs (the
        # branches' come from the tallies)
        self.fixed = Counter()
        # this graph's conditional handles, a slot a picks-table column,
        # which its head copies into the set's table
        handles = [0] * len(S.PICK_COLS)
        self.handles = torch.zeros(len(S.PICK_COLS), dtype=torch.int64,
                                   device=gs.device)
        g = ctypes.c_void_p()
        _check(self.lib.reina_dg_create(ctypes.byref(g)), self._what("create"))
        self.graph = g
        head = ctypes.c_void_p()
        _check(self.lib.reina_dg_memcpy(
            g, None, gs.handles.data_ptr(), self.handles.data_ptr(),
            8 * len(handles), ctypes.byref(head)), self._what("handle table"))
        self._add(g, head, nodes, gs, handles)
        self.handles.copy_(torch.tensor(handles, dtype=torch.int64))
        ex = ctypes.c_void_p()
        _check(self.lib.reina_dg_instantiate(g, ctypes.byref(ex)),
               self._what("instantiate"))
        self.exec = ex

    def _what(self, step: str) -> str:
        return f"day graph {self.hkey}: {step}"

    def _child(self, graph, dep, child, what):
        node = ctypes.c_void_p()
        _check(self.lib.reina_dg_child(graph, dep, child, ctypes.byref(node)),
               self._what(what))
        return node

    def _span(self, graph, dep, entry, stop, what):
        """A captured span after ``dep`` in ``graph``: one child-graph
        node, or on a gated set (``entry.pieces``) its first piece a
        child graph and each later piece, which starts after a captured
        collective, a child graph in the body of a gate on the stop word
        at ``stop``. The first piece needs no gate: a span reads only the
        set's static buffers, which no aborted collective writes, so
        what it runs before its first collective is sound."""
        if not entry.pieces:
            return self._child(graph, dep, entry.run.raw_cuda_graph(), what)
        dep = self._child(graph, dep, entry.pieces[0], f"{what}: piece 0")
        for i, piece in enumerate(entry.pieces[1:], 1):
            node, body = ctypes.c_void_p(), ctypes.c_void_p()
            _check(self.lib.reina_dg_gate(graph, dep, stop, ctypes.byref(node),
                                          ctypes.byref(body)),
                   self._what(f"{what}: gate {i}"))
            self._child(body, None, piece, f"{what}: piece {i}")
            dep = node
        return dep

    def _add(self, graph, dep, nodes, gs, handles) -> None:
        for node in nodes:
            if isinstance(node, S.Span):
                entry = gs.entry(self.hkey, node.name, node.key)
                dep = self._span(graph, dep, entry, gs.stop_dev,
                                 f"span {node.name}")
                self.fixed.update(entry.tally)
                continue
            # the span before set this node's condition (FOLDS)
            col, slot, n = gs.layout[node.name]
            h = ctypes.c_ulonglong()
            _check(self.lib.reina_dg_handle(graph, ctypes.byref(h)),
                   self._what(f"handle of {node.name}"))
            handles[col] = h.value
            size = 1 if isinstance(node, S.If) else n
            bodies = (ctypes.c_void_p * size)()
            cond = ctypes.c_void_p()
            _check(self.lib.reina_dg_cond(
                graph, dep, h, _IF if isinstance(node, S.If) else _SWITCH,
                size, ctypes.byref(cond), bodies),
                self._what(f"conditional {node.name}"))
            dep = cond
            if isinstance(node, S.If):
                self._add(bodies[0], None, node.body, gs, handles)
            else:
                for b, key in enumerate(node.keys()):
                    self._span(bodies[b], None,
                               gs.entry(self.hkey, node.name, key),
                               gs.stop_dev, f"branch {node.name} {key}")

    def launch(self, stream: int) -> None:
        _check(self.lib.reina_dg_launch(self.exec, stream),
               self._what("launch"))

    def close(self) -> None:
        """Destroy the instantiated graph and its graph now."""
        if self.graph is not None or self.exec is not None:
            self.lib.reina_dg_destroy(self.graph, self.exec)
        self.graph = self.exec = None

    def __del__(self):
        self.close()
