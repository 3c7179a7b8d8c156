"""Compartmental SIR comparison model (port of reina_tpu/models/sir.py;
reference: calc/sir.py).

The same RK4 integrator as the JAX package, in float32 (the JAX package
runs without x64), on tensors of an explicit device: ``cuda`` unless the
caller asks for the CPU. ``sweep_r0`` integrates a grid of R0 values as
a leading axis of one (G, 3) state. The reference's driving variables
(``r0``, ``initial_infected``, ``infectious_days``) had rotted out of
its defaults (calc/sir.py:24 vs variables.py); they are explicit
arguments here.
"""
from __future__ import annotations

import torch

from ..simulation import resolve_device


def _integrate(population, initial_infected, r0, infectious_days,
               days: int, steps_per_day: int, device) -> torch.Tensor:
    """RK4 over a (G, 3) state, one row per value of ``r0`` (G,);
    returns (G, days, 3) with row 0 the initial state."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    n = torch.as_tensor(population, **f32)
    i0 = torch.as_tensor(initial_infected, **f32)
    gamma = 1.0 / torch.as_tensor(infectious_days, **f32)
    beta = (torch.as_tensor(r0, **f32) * gamma)[:, None]
    dt = 1.0 / steps_per_day

    def deriv(y):
        s, i = y[:, 0:1], y[:, 1:2]
        inf = beta * s * i / n
        rec = gamma * i
        return torch.cat([-inf, inf - rec, rec], dim=1)

    y = torch.stack([n - i0, i0, torch.zeros((), **f32)]).expand(
        beta.shape[0], 3).contiguous()
    rows = [y]
    for _ in range(days - 1):
        for _ in range(steps_per_day):
            k1 = deriv(y)
            k2 = deriv(y + dt / 2 * k1)
            k3 = deriv(y + dt / 2 * k2)
            k4 = deriv(y + dt * k3)
            y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        rows.append(y)
    return torch.stack(rows, dim=1)


def simulate_sir(population, initial_infected, r0, infectious_days,
                 days: int, steps_per_day: int = 4,
                 device="cuda") -> torch.Tensor:
    """Integrate S/I/R; returns a (days, 3) tensor of compartment
    counts, row 0 the initial state.

    dS = -beta·S·I/N ; dI = beta·S·I/N - gamma·I ; dR = gamma·I
    with gamma = 1/infectious_days, beta = R0·gamma.
    """
    return _integrate(population, initial_infected, [r0], infectious_days,
                      days, steps_per_day, device)[0]


def sweep_r0(population, initial_infected, r0_grid, infectious_days,
             days: int, steps_per_day: int = 4,
             device="cuda") -> torch.Tensor:
    """An R0 grid as one integration over a (G, 3) state; returns
    (G, days, 3)."""
    return _integrate(population, initial_infected, list(r0_grid),
                      infectious_days, days, steps_per_day, device)
