"""Monte-Carlo validation of the closed forms: simulate the checkpointed
execution at the paper's scenario (the scalar simulator) and compare
E[T], E[E] to the model."""
from __future__ import annotations

import copy

import numpy as np

from ..core import (EXASCALE_POWER_RHO55, energy_final, fig12_checkpoint,
                    simulate, t_opt_energy, t_opt_time, time_final)
from . import _util


def run(rng: np.random.Generator, device="cuda"):
    """``(csv path, max |T_sim - T_model| / T_model, rows)``; rows are
    (strategy, period, T_sim, T_model, E_sim, E_model).  Every row replays
    ``rng`` from its state at the call (a copy a row), as the reference
    reseeds every row: ``np.random.default_rng(0)`` gives its rows."""
    ck = fig12_checkpoint(300.0)
    pw = EXASCALE_POWER_RHO55
    rows = []
    for name, T in (("algo_t", t_opt_time(ck, device)),
                    ("algo_e", t_opt_energy(ck, pw, device)),
                    ("half_opt", 0.5 * t_opt_time(ck, device)),
                    ("twice_opt", 2.0 * t_opt_time(ck, device))):
        sim = simulate(T, ck, pw, 4000.0, copy.deepcopy(rng), n_trials=400)
        rows.append((name, T,
                     sim["T_final"], float(time_final(T, ck, 4000.0, device)),
                     sim["E_final"],
                     float(energy_final(T, ck, pw, 4000.0, device))))
    out = _util.out_path("table_simulation.csv")
    with open(out, "w") as f:
        f.write("strategy,period,T_sim,T_model,E_sim,E_model\n")
        for r in rows:
            f.write(f"{r[0]},{r[1]:.3f},{r[2]:.2f},{r[3]:.2f},"
                    f"{r[4]:.1f},{r[5]:.1f}\n")
    errs = [abs(r[2] - r[3]) / r[3] for r in rows]
    return out, max(errs), rows


def main(rng: np.random.Generator, device="cuda") -> str:
    (out, err, _), us = _util.timed(run, rng, device, repeat=1)
    return _util.emit("table_simulation", us,
                      f"max |T_sim-T_model|/T = {err:.2%} -> {out.name}")
