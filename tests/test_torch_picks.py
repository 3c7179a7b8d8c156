"""The day graph's tier picks folded into the kernels that produce their
counts (core/daygraph.py: FOLDS, Fold; ops/fusedmap.py:prefix_count,
ops/compact.py:count_max), on the CPU.

On a card each pick is made inside the launch of its count's producer:
the prefix kernel makes the slot pick, the tracing cond with T1's
switch and T3's; the reduce-and-pick makes T2's and T4's. On the CPU the
fused entry is its producer's twin followed by the picks' twin, made by
the same Fold inside the producer's call. Checks, all exact:
  * each fused entry's CPU form against the separate producer (the
    prefix twin's last value, or the maximum) and a separate pick twin a
    node, at every branch of every pick and past each cap, with the
    second pick of the tracing fold made only where the cond takes its
    body, the overflow bits set exactly where a count exceeds its cap,
    and each branch equal to the host's ``tier_branch``;
  * every conditional of a tracing day's program is in one fold, which
    its producer's count opens;
  * outside the graph runner (the plain step) a count is torch's maximum
    or the prefix twin's last value, with no pick.
The graph runner's CPU model of untraced and tracing days, whose picks
now come from the producers' folds, is held to the plain step's host
picks, tallies and problem bits in tests/test_torch_graphs.py.
"""
import pytest
import torch

from reina_tpu_torch.core import daygraph
from reina_tpu_torch.core import step as S
from reina_tpu_torch.kernels import checks
from reina_tpu_torch.ops import compact, fusedmap

# agents of a prefix case: above the member cap + 1 (65,537), a
# multiple of 1024
N = 66560
I32 = torch.int32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _separate(name, counts, producer_out):
    """The separate producer's count and one pick twin a node of the
    fold, into fresh tables: (count, picks row, tallies, problem)."""
    cfg = S.EngineConfig()
    nodes = daygraph.fold_nodes(cfg, name)
    table = torch.full((4, len(S.PICK_COLS)), -1, dtype=I32)
    tallies = [torch.zeros(2 if isinstance(n, S.If) else len(n.keys()),
                           dtype=I32) for n in nodes]
    problem = torch.full((), 4, dtype=I32)
    counter = torch.tensor(2)
    count = producer_out
    have = {k: torch.tensor(v, dtype=I32) for k, v in counts.items()}
    have[name] = count
    for i, (node, tally) in enumerate(zip(nodes, tallies)):
        b = daygraph.pick_twin([have[p.src] for p in node.picks], node.picks,
                               table, counter, S.PICK_COLS.index(node.name),
                               tally, problem)
        flat = 0
        for p in node.picks:
            flat = flat * len(p.ends) + S.tier_branch(p, int(have[p.src]))
        assert int(b) == flat, (name, node.name, counts)
        if isinstance(node, S.If) and flat == 0:
            break
    return count, table[2], tallies, problem


@pytest.mark.parametrize("name", list(daygraph.FOLDS))
def test_fused_entry_equals_separate_producer_and_pick(name):
    cfg = S.EngineConfig()
    cases = [c for f, c in checks.fold_cases(cfg, N) if f == name]
    nodes = daygraph.fold_nodes(cfg, name)
    seen = {node.name: set() for node in nodes}
    over = {node.name: 0 for node in nodes}
    for i, counts in enumerate(cases):
        n = checks.FILL_MEMBERS if name.startswith("fill") else N
        fused, _ = checks._fold_pair(name, counts, n, "cpu", seed=i)
        got = fused()
        # the separate producer: the prefix twin's last value, or the max
        if name.startswith("fill"):
            want_count = got[0]   # the fills were made to peak at it
            assert int(got[0]) == counts[name]
            row, tallies, problem = got[1], got[2:-1], got[-1]
        else:
            cum, cnt = got[0], got[1]
            w = torch.zeros(n)
            g = torch.Generator().manual_seed(i)
            w[torch.randperm(n, generator=g)[:counts[name]]] = 1.0
            want_cum = fusedmap.concat_prefix_twin(w, None, 1)
            assert torch.equal(cum, want_cum)
            want_count = want_cum[-1].to(I32)
            assert cnt.dtype == I32 and int(cnt) == counts[name]
            row, tallies, problem = got[2], got[3:-1], got[-1]
        _, w_row, w_tallies, w_problem = _separate(name, counts, want_count)
        assert torch.equal(row, w_row), (name, counts)
        for a, b in zip(tallies, w_tallies):
            assert torch.equal(a, b), (name, counts)
        assert torch.equal(problem, w_problem), (name, counts)
        bits = 4
        for node in nodes:
            col = S.PICK_COLS.index(node.name)
            if int(row[col]) >= 0:
                seen[node.name].add(int(row[col]))
                for p in node.picks:
                    x = counts[p.src] if p.src in counts else None
                    if p.bit and x > p.cap:
                        bits |= p.bit
                        over[node.name] += 1
        assert int(problem) == bits, (name, counts)
    for node in nodes:
        n_br = 2 if isinstance(node, S.If) else len(node.keys())
        assert seen[node.name] == set(range(n_br)), node.name
        if any(p.bit for p in node.picks):
            assert over[node.name] > 0, node.name


def test_every_conditional_is_in_one_fold():
    cfg = S.EngineConfig()
    names = [n.name for n in S.conditionals(
        S.day_program(cfg, True, False, False))]
    folded = [c for cols in daygraph.FOLDS.values() for c in cols]
    assert sorted(folded) == sorted(names) == sorted(S.PICK_COLS)
    for name, cols in daygraph.FOLDS.items():
        nodes = daygraph.fold_nodes(cfg, name)
        # the producer's count is what the fold's last node reads last
        assert nodes[-1].picks[-1].src == name
        # only a fold that opens with an If makes more than one pick
        assert len(nodes) == 1 or isinstance(nodes[0], S.If)


def test_count_max_without_a_site_is_the_max():
    """Outside the graph runner (the plain step) a count's maximum is
    torch's, and its prefix count the prefix twin's last value."""
    x = torch.tensor([3, 9, 2], dtype=I32)
    assert int(compact.count_max(x, "fill_max")) == 9
    w = torch.zeros(2048)
    w[[5, 700, 2047]] = 1.0
    cum, cnt = fusedmap.prefix_count(w, "n_new")
    assert int(cnt) == 3 and cnt.dtype == I32
    assert torch.equal(cum, fusedmap.concat_prefix_twin(w, None, 1))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["n_new", "n_d", "n_f"])
def test_sharded_emit_fold_equals_one_card(name, k):
    """The sharded prefix's emit with its count and picks
    (fusedmap.sharded_prefix_count under a fold site, its CPU form) on k
    slabs, each with tables of its own as each rank has: the slabs'
    prefixes put together, and on every slab the count, the picks row,
    the tallies and the problem bits, equal the one-card fused entry's
    twin (the prefix twin, then the picks' twin) at every branch of
    every pick of the fold and past each cap."""
    cfg = S.EngineConfig()
    for i, (f, counts) in enumerate(checks.fold_cases(cfg, N)):
        if f != name:
            continue
        got = checks._sharded_fold_pair(name, counts, N, "cpu", k,
                                        seed=i)[0]()
        want = checks._fold_pair(name, counts, N, "cpu", seed=i)[1]()
        assert torch.equal(got[0], want[0]), (name, counts)
        per = len(want) - 1
        assert len(got) == 1 + k * per
        for j in range(k):
            for a, b in zip(got[1 + j * per:1 + (j + 1) * per], want[1:]):
                assert a.dtype == b.dtype and torch.equal(a, b), (
                    name, counts, j)
