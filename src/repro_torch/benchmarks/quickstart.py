"""Quickstart: the paper's checkpoint time/energy model in five minutes.

The time-optimal (AlgoT) and energy-optimal (AlgoE) checkpoint periods of
an Exascale-like platform, the predicted trade-off, and both checked
against the discrete-event Monte-Carlo simulator: the counterpart of the
reference's ``examples/quickstart.py``.
"""
from __future__ import annotations

import copy

import numpy as np

from ..core import (EXASCALE_POWER_RHO55, CheckpointParams, energy_final,
                    evaluate, simulate, t_daly, t_opt_energy, t_opt_time,
                    t_young, time_final)


def run(rng: np.random.Generator, device="cuda") -> list:
    """The report's lines.  Each MC check replays ``rng`` from its state
    at the call, as the reference reseeds each one
    (``np.random.default_rng(0)`` gives its numbers)."""
    ck = CheckpointParams(C=10.0, R=10.0, D=1.0, mu=300.0, omega=0.5)
    pw = EXASCALE_POWER_RHO55          # P_static=10, P_cal=10, P_io=100
    lines = [f"platform: mu={ck.mu} min, C={ck.C}, R={ck.R}, D={ck.D}, "
             f"omega={ck.omega}; rho={pw.rho}",
             f"Young  period: {t_young(ck):7.2f} min",
             f"Daly   period: {t_daly(ck):7.2f} min",
             f"AlgoT  period: {t_opt_time(ck, device):7.2f} min   "
             f"(paper Eq. 1)",
             f"AlgoE  period: {t_opt_energy(ck, pw, device):7.2f} min   "
             f"(positive root of the exact quadratic)"]
    pt = evaluate(ck, pw, device)
    lines.append(f"\npredicted: AlgoE saves {(pt.energy_ratio-1)*100:.1f}% "
                 f"energy for {(pt.time_ratio-1)*100:.1f}% extra time")
    # Monte-Carlo check (T_base = 4000 min of work)
    for name, T in (("AlgoT", pt.T_time), ("AlgoE", pt.T_energy)):
        sim = simulate(T, ck, pw, 4000.0, copy.deepcopy(rng), n_trials=200)
        model_T = float(time_final(T, ck, 4000.0, device))
        model_E = float(energy_final(T, ck, pw, 4000.0, device))
        lines.append(f"{name}: model T={model_T:8.1f}  "
                     f"sim T={sim['T_final']:8.1f}  model E={model_E:9.0f}  "
                     f"sim E={sim['E_final']:9.0f}")
    return lines


def main(rng: np.random.Generator, device="cuda") -> list:
    lines = run(rng, device)
    for line in lines:
        print(line)
    return lines
