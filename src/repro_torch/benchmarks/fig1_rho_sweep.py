"""Paper Figure 1: time and energy ratios as a function of rho.

C = R = 10 min, D = 1 min, omega = 1/2; one curve per platform MTBF,
computed as one batched (mu x rho) grid through ``repro_torch.sim``, in
f64 on every device (as the figures' sweeps fig2 and fig3).
Writes ``fig1_rho_sweep.csv`` (mu, rho, energy_ratio, time_ratio) and
returns the paper's headline point: >20% energy gain at ~10% time loss
for (mu=300, rho=5.5).
"""
from __future__ import annotations

import numpy as np

from ..sim import F64, sweep_mu_rho_grid
from . import _util

MUS = [300.0, 120.0, 60.0, 30.0]


def run(device="cuda"):
    """``(csv path, headline row, rows)``; rows are (mu, rho,
    energy_ratio, time_ratio) floats."""
    rhos = list(np.linspace(1.0, 10.0, 19))
    res = sweep_mu_rho_grid(MUS, rhos, device=device, precision=F64)
    rho, er, tr = (x.cpu().numpy() for x in (res.grid.rho, res.energy_ratio,
                                             res.time_ratio))
    rows = [(mu, float(rho[i, j]), float(er[i, j]), float(tr[i, j]))
            for i, mu in enumerate(MUS) for j in range(len(rhos))]
    out = _util.out_path("fig1_rho_sweep.csv")
    with open(out, "w") as f:
        f.write("mu_min,rho,energy_ratio_T_over_E,time_ratio_E_over_T\n")
        for r in rows:
            f.write(",".join(f"{x:.6f}" for x in r) + "\n")
    head = [r for r in rows if r[0] == 300.0 and abs(r[1] - 5.5) < 0.26]
    return out, head[0] if head else rows[0], rows


def main(device="cuda") -> str:
    (out, head, _), us = _util.timed(run, device, repeat=2)
    return _util.emit(
        "fig1_rho_sweep", us,
        f"mu=300 rho~5.5: e_ratio={head[2]:.3f} t_ratio={head[3]:.3f} "
        f"-> {out.name}")
