"""Engine enums and constants (reference: cythonsim/main.pyx:33-129)."""
from __future__ import annotations

# Person disease states (main.pyx:41-48)
SUSCEPTIBLE = 0
INCUBATION = 1
ILLNESS = 2
HOSPITALIZED = 3
IN_ICU = 4
RECOVERED = 5
DEAD = 6

STATE_TO_STR = {
    SUSCEPTIBLE: "SUSCEPTIBLE",
    INCUBATION: "INCUBATION",
    ILLNESS: "ILLNESS",
    HOSPITALIZED: "HOSPITALIZED",
    IN_ICU: "IN_ICU",
    RECOVERED: "RECOVERED",
    DEAD: "DEAD",
}

# Symptom severities (main.pyx:33-38)
ASYMPTOMATIC = 0
MILD = 1
SEVERE = 2
CRITICAL = 3
FATAL = 4

SEVERITY_TO_STR = {
    ASYMPTOMATIC: "ASYMPTOMATIC",
    MILD: "MILD",
    SEVERE: "SEVERE",
    CRITICAL: "CRITICAL",
    FATAL: "FATAL",
}
STR_TO_SEVERITY = {v: k for k, v in SEVERITY_TO_STR.items()}

# Contact places (main.pyx:64-74)
PLACES = ("home", "work", "school", "transport", "leisure", "other")
NR_PLACES = len(PLACES)
PLACE_TO_IDX = {p: i for i, p in enumerate(PLACES)}
PLACE_ALL = -1  # scope marker for "all places"

# Testing modes (main.pyx:441-445; enum order preserved)
TESTING_NO_TESTING = 0
TESTING_ALL_WITH_SYMPTOMS_CT = 1
TESTING_ALL_WITH_SYMPTOMS = 2
TESTING_ONLY_SEVERE_SYMPTOMS = 3

# Simulation problem codes (main.pyx:51-61), carried as a bitmask so
# several problems can be reported from one vectorized day.
PROBLEM_NONE = 0
PROBLEM_INFECTION_BUFFER_OVERFLOW = 1 << 0   # ≙ TOO_MANY_INFECTEES-family caps
PROBLEM_IMPORT_BUFFER_OVERFLOW = 1 << 1
PROBLEM_CONTACT_PROBABILITY = 1 << 2
PROBLEM_HOSPITAL_ACCOUNTING = 1 << 3
PROBLEM_WRONG_STATE = 1 << 4
PROBLEM_TRACING_BUFFER_OVERFLOW = 1 << 5
PROBLEM_TOO_MANY_INFECTEES = 1 << 6    # per-source infectee-bucket
#                                        overflow (reference MAX_INFECTEES
#                                        guard, main.pyx:128,219-220)

PROBLEM_TO_STR = {
    PROBLEM_INFECTION_BUFFER_OVERFLOW: "New-infection buffer overflow",
    PROBLEM_IMPORT_BUFFER_OVERFLOW: "Import buffer overflow",
    PROBLEM_CONTACT_PROBABILITY: "Contact probability failure",
    PROBLEM_HOSPITAL_ACCOUNTING: "Hospital accounting failure",
    PROBLEM_WRONG_STATE: "Wrong state",
    PROBLEM_TRACING_BUFFER_OVERFLOW: "Contact-tracing buffer overflow",
    PROBLEM_TOO_MANY_INFECTEES: "Too many infectees",
}

# Infectiousness over time relative to symptom onset, days -10..+10.
# Public data: Luca et al., "The timing of COVID-19 transmission"
# (https://doi.org/10.1101/2020.09.04.20188516); reference main.pyx:660-682.
INFECTIOUSNESS_OVER_TIME = (
    0.00183, 0.00280, 0.00446, 0.00742, 0.01291, 0.02350, 0.04419,
    0.08247, 0.14018, 0.19032, 0.18539, 0.13091, 0.07538, 0.04018,
    0.02144, 0.01185, 0.00686, 0.00415, 0.00262, 0.00172, 0.00117,
)
IOT_OFFSET = 10       # iot index = day_relative_to_onset + IOT_OFFSET
IOT_LEN = len(INFECTIOUSNESS_OVER_TIME)

# Contact-count model (main.pyx:128-129,1306-1320)
MAX_CONTACTS = 128
DEFAULT_CONTACT_LIMIT = 100
SYMPTOMATIC_CONTACT_FACTOR = 0.5
SYMPTOMATIC_CONTACT_LIMIT = 5
CONTACT_LOGNORMAL_SIGMA = 0.5

# Duration distributions (main.pyx:977-1001)
INCUBATION_CV = 0.86
ONSET_TO_REMOVED_CV = 0.45

# Vaccine efficacy model (main.pyx:1051-1055)
VACCINE_EFFICACY = 0.90
VACCINE_DELAY_DAYS = 14


class SimulationFailed(Exception):
    """Raised when the engine reports a problem code (main.pyx:124)."""
