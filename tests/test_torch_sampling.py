"""The port's parameter explorer (reina_tpu_torch/sampling.py, the CLI's
``sample``) against the JAX package's, on the CPU.

The JAX package's draws compile eagerly, and tests/test_sampling.py:1-8
sets out why such compiles go in a fresh interpreter: one child (``python
tests/test_torch_sampling.py OUT``, launched by the fixture below)
computes every reference distribution, and the tests read its report.

Cases: the 8 kinds at ages 30 and 80, with the web UI's severities for
the three severity-dependent periods (illness and hospitalization
SEVERE, ICU CRITICAL), the default variables (seed 0). Tolerances:
  * ``infectiousness`` and ``symptom_severity``: exact (the same curve;
    the same uniform bits through the same float32 chain).
  * the normal- and gamma-based kinds: at most 20 of the 10,000 draws
    change bin, counted as half the L1 distance of the two count
    vectors (the least number of moved draws that explains it). The
    uniform bits are equal; ``exp``/``log``/``sqrt`` differ by ulps
    between XLA:CPU and torch (ROADMAP.md, queue 3).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KINDS = [
    ("infectiousness", None),
    ("contacts_per_day", None),
    ("symptom_severity", None),
    ("incubation_period", None),
    ("illness_period", "SEVERE"),
    ("hospitalization_period", "SEVERE"),
    ("icu_period", "CRITICAL"),
    ("onset_to_removed_period", None),
]
AGES = (30, 80)
EXACT = {"infectiousness", "symptom_severity"}
MAX_MOVED = 20

# the gamma fixture (VERDICT.md:272-278), computed by hand from (mu, cv):
# kappa = 1 / cv^2, theta = cv^2 * mu
KAPPA_INC = 1.3520822065981613     # incubation, cv 0.86
THETA_INC = 3.77196                # 0.86^2 * 5.1
KAPPA_O2R = 4.938271604938271      # onset to removed, cv 0.45
THETA_O2R = 4.2525                 # 0.45^2 * 21 (recovery)


def _child(out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from reina_tpu.config.variables import VARIABLE_DEFAULTS
    from reina_tpu.sampling import sample_distribution

    variables = dict(VARIABLE_DEFAULTS)
    report = {}
    for what, severity in KINDS:
        for age in AGES:
            s = sample_distribution(what, age, severity, variables)
            report[f"{what}/{age}"] = {
                "categories": [str(c) for c in s.index],
                "counts": [float(v) for v in s.values]}
    with open(out_path, "w") as f:
        json.dump(report, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_sampling") / "report.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                       cwd=_REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, (
        f"reference child failed (rc={r.returncode}):\n"
        f"{r.stdout[-3000:]}\n{r.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def variables():
    from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
    return dict(VARIABLE_DEFAULTS)


@pytest.mark.parametrize("age", AGES)
@pytest.mark.parametrize("what,severity", KINDS)
def test_explorer_matches_reference(reference, variables, what, severity,
                                    age):
    from reina_tpu_torch.sampling import sample_distribution
    cats, counts = sample_distribution(what, age, severity, variables, "cpu")
    ref = reference[f"{what}/{age}"]
    if what in EXACT:
        assert [str(c) for c in cats] == ref["categories"]
        assert [float(v) for v in counts] == ref["counts"]
        return
    assert counts.sum() == 10000
    got = dict(zip((str(c) for c in cats), counts.tolist()))
    want = dict(zip(ref["categories"], ref["counts"]))
    keys = set(got) | set(want)
    moved = sum(abs(got.get(k, 0) - want.get(k, 0)) for k in keys) / 2
    print(f"{what} age {age}: {moved:g} of 10,000 draws changed bin")
    assert moved <= MAX_MOVED, (what, age, moved)
    # the categories come out sorted, as value_counts().sort_index()
    assert list(cats) == sorted(cats)


def test_gamma_fixture(variables):
    """The (mu, cv) → (kappa, theta) conversion, computed by hand, holds
    the explorer's incubation and onset-to-removed draws and the day
    step's shape constants."""
    from reina_tpu_torch.core import constants as C
    from reina_tpu_torch.ops import prng
    from reina_tpu_torch.ops.random import gamma_fixed
    from reina_tpu_torch.sampling import sample_distribution

    assert 1.0 / (C.INCUBATION_CV ** 2) == KAPPA_INC
    assert 1.0 / (C.ONSET_TO_REMOVED_CV ** 2) == KAPPA_O2R
    assert variables["mean_incubation_duration"] == 5.1
    assert variables["mean_duration_from_onset_to_recovery"] == 21
    key = prng.PRNGKey(variables["random_seed"])
    for what, kappa, theta in (("incubation_period", KAPPA_INC, THETA_INC),
                               ("onset_to_removed_period", KAPPA_O2R,
                                THETA_O2R)):
        g = gamma_fixed(key, kappa, (10000,), "cpu").numpy()
        want = np.unique(np.floor(g * theta + 0.5).astype(np.int64),
                         return_counts=True)
        got = sample_distribution(what, 30, None, variables, "cpu")
        np.testing.assert_array_equal(got[0], want[0], err_msg=what)
        np.testing.assert_array_equal(got[1], want[1], err_msg=what)
    cats, counts = sample_distribution("incubation_period", 30, None,
                                       variables, "cpu")
    assert abs((cats * counts).sum() / counts.sum() - 5.1) <= 0.18


def test_cli_sample_prints_shares(capsys):
    from reina_tpu_torch import cli
    assert cli.main(["sample", "--what", "symptom_severity", "--age", "80",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    shares = {ln.strip(" (),").split(",")[0]: float(ln.strip(" (),")
                                                     .split(",")[1])
              for ln in lines}
    assert set(shares) == {"ASYMPTOMATIC", "MILD", "SEVERE", "CRITICAL",
                           "FATAL"}
    assert abs(sum(shares.values()) - 1) < 1e-3


def test_unknown_kind_and_missing_card(variables):
    import torch

    from reina_tpu_torch.sampling import sample_distribution
    with pytest.raises(ValueError, match="unknown sample type"):
        sample_distribution("nope", 30, None, variables, "cpu")
    if not torch.cuda.is_available():
        for what in ("symptom_severity", "infectiousness"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                sample_distribution(what, 30, None, variables)


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    _child(sys.argv[1])
