"""The port's SIR model and debug dumps against the JAX package's, and
the new entry points' refusal to run without a card.

Checks and tolerances:
  * SIR: ``simulate_sir`` and ``sweep_r0`` on the CPU agree with the
    JAX package's within 1e-5 relative (both float32 RK4; XLA:CPU may
    contract a multiply-add, so equality is not expected; 2.1e-6 seen),
    on tests/test_sir.py's cases and a 4-point sweep.
  * debug: ``person_str``, ``dump_state`` and ``infection_tree`` give
    the JAX package's strings exactly, for a port state after 6
    synthetic days, wrapped as numpy in each package's AgentState; the
    port's functions also take the state's tensors directly.
No JAX engine program is compiled here.
"""
import numpy as np
import pytest
import torch

from reina_tpu.core import debug as jdebug
from reina_tpu.core.state import AgentState as JAgentState
from reina_tpu.models.sir import simulate_sir as jax_simulate_sir
from reina_tpu.models.sir import sweep_r0 as jax_sweep_r0

from reina_tpu_torch.core import debug
from reina_tpu_torch.core.state import AgentState
from reina_tpu_torch.models.sir import simulate_sir, sweep_r0

SIR_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU runs here are thousands of tiny ops a day, which torch's
    intra-op threads only slow down, most of all on a busy host."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("r0,days", [(2.5, 200), (0.8, 100)])
def test_sir_matches_jax(r0, days):
    ys = simulate_sir(1e6, 100.0, r0, 7.0, days, device="cpu")
    assert ys.dtype == torch.float32 and ys.shape == (days, 3)
    ys = ys.numpy()
    np.testing.assert_allclose(
        ys, np.asarray(jax_simulate_sir(1e6, 100.0, r0, 7.0, days)),
        rtol=SIR_RTOL, atol=0)
    np.testing.assert_array_equal(ys[0], [1e6 - 100.0, 100.0, 0.0])


def test_sir_conserves_population():
    ys = simulate_sir(1e6, 100.0, 2.5, 7.0, 200, device="cpu").numpy()
    np.testing.assert_allclose(ys.sum(axis=1), 1e6, rtol=1e-5)
    assert ys[-1, 2] > 0.5e6     # most recovered
    assert ys[-1, 1] < 1000      # infections died down
    assert ys[-1, 2] < 1e6


def test_sir_r0_below_one_no_epidemic():
    ys = simulate_sir(1e6, 100.0, 0.8, 7.0, 100, device="cpu").numpy()
    assert ys[:, 1].max() <= 100.0 + 1e-6
    assert ys[-1, 2] < 1000


def test_sweep_r0_matches_jax():
    grid = [0.8, 1.5, 2.5, 4.0]
    ys = sweep_r0(1e6, 100.0, grid, 7.0, 150, device="cpu").numpy()
    assert ys.shape == (4, 150, 3)
    np.testing.assert_allclose(
        ys, np.asarray(jax_sweep_r0(1e6, 100.0, grid, 7.0, 150)),
        rtol=SIR_RTOL, atol=0)
    assert (np.diff(ys[:, -1, 2]) > 0).all()   # higher R0, larger final size
    for g, r0 in enumerate(grid):              # a grid row is its own run
        np.testing.assert_array_equal(
            ys[g], simulate_sir(1e6, 100.0, r0, 7.0, 150,
                                device="cpu").numpy())


@pytest.fixture(scope="module")
def six_days():
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.testing import build_synthetic_run
    run = build_synthetic_run("cpu", n_agents=3000, days=7, seed=2,
                              interventions=[["import-infections",
                                              "2020-02-19", 60]])
    _, state, _, _ = run_days(run)
    return state


def _numpy(state):
    return {k: v.numpy() for k, v in state._asdict().items()}


def test_debug_strings_match_jax(six_days):
    port = AgentState(**_numpy(six_days))
    ref = JAgentState(**_numpy(six_days))
    infected = np.flatnonzero(port.day_of_infection >= 0)
    assert len(infected) > 20
    picks = list(infected[:12]) + [0, 1, len(port.age) - 1]
    for idx in picks:
        for today in (None, 6):
            s = debug.person_str(port, int(idx), today)
            assert s == jdebug.person_str(ref, int(idx), today)
            assert s == debug.person_str(six_days, int(idx), today)
    for kw in ({"today": 6}, {"limit_per_state": 3},
               {"states": [1, 5, 6], "limit_per_state": 2}):
        s = debug.dump_state(port, **kw)
        assert s == jdebug.dump_state(ref, **kw)
        assert s == debug.dump_state(six_days, **kw)
    assert "INCUBATION" in s or "RECOVERED" in s
    roots = np.unique(port.infector[port.infector >= 0])
    assert len(roots)
    for root in roots[:5]:
        for kw in ({}, {"max_depth": 1, "max_children": 1}):
            s = debug.infection_tree(port, int(root), **kw)
            assert s == jdebug.infection_tree(ref, int(root), **kw)
            assert s == debug.infection_tree(six_days, int(root), **kw)
            assert f"#{root}:" in s


def test_entry_points_need_a_card(tmp_path):
    """Without a card every new entry point raises unless asked for the
    CPU: nothing carries on on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from reina_tpu_torch import cli, mc_spread
    from reina_tpu_torch.calibration import calibrate, sweep_grid
    from reina_tpu_torch.ensemble import run_monte_carlo
    from reina_tpu_torch.testing import synthetic_variables
    v = synthetic_variables(days=3)
    grid = {"infectiousness_multiplier": [0.5]}
    calls = [
        lambda: simulate_sir(1e6, 100.0, 2.5, 7.0, 5),
        lambda: sweep_r0(1e6, 100.0, [2.5], 7.0, 5),
        lambda: run_monte_carlo(n_runs=1),
        lambda: sweep_grid(v, grid),
        lambda: calibrate(v, grid),
        lambda: cli.main(["monte-carlo", "--runs", "1"]),
        lambda: cli.main(["calibrate", "--grid",
                          '{"infectiousness_multiplier": [0.5]}']),
        lambda: mc_spread.main(["--seeds", "2", "--out",
                                str(tmp_path / "spread.json")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
