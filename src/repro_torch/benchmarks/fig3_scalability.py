"""Paper Figure 3: time/energy ratios vs number of nodes.

C = R = 1 min, D = 0.1 min, omega = 1/2, mu = 120 min @ 1e6 nodes, ~ 1/N.
Panels (a) rho = 5.5 and (b) rho = 7 through the batched sweep; the
paper's claims: up to ~30% energy gain at ~12% time overhead, both ratios
-> 1 at 1e8 nodes.
"""
from __future__ import annotations

import numpy as np

from ..core import EXASCALE_POWER_RHO55, EXASCALE_POWER_RHO7
from ..sim import F64, sweep_nodes_grid
from . import _util


def run(device="cuda"):
    """``(csv path, rho=7 peak (energy_ratio, time_ratio, mu), rows)``;
    rows are (rho, mu, energy_ratio, time_ratio) floats."""
    ns = np.logspace(5, 8, 25)
    out = _util.out_path("fig3_scalability.csv")
    best, rows = None, []
    with open(out, "w") as f:
        f.write("rho,n_nodes,mu_min,energy_ratio,time_ratio\n")
        for rho, pw in ((5.5, EXASCALE_POWER_RHO55),
                        (7.0, EXASCALE_POWER_RHO7)):
            res = sweep_nodes_grid(ns, pw, device=device, precision=F64)
            mu, er, tr = (x.cpu().numpy() for x in (
                res.grid.mu, res.energy_ratio, res.time_ratio))
            for i in range(len(ns)):
                rows.append((rho, float(mu[i]), float(er[i]), float(tr[i])))
                f.write(f"{rho},{120.0 * 1e6 / mu[i]:.0f},{mu[i]:.3f},"
                        f"{er[i]:.6f},{tr[i]:.6f}\n")
            if rho == 7.0:
                k = int(np.argmax(er))
                best = (float(er[k]), float(tr[k]), float(mu[k]))
    return out, best, rows


def main(device="cuda") -> str:
    (out, best, _), us = _util.timed(run, device, repeat=2)
    return _util.emit("fig3_scalability", us,
                      f"rho=7 peak: e_ratio={best[0]:.3f} "
                      f"t_ratio={best[1]:.3f} at mu={best[2]:.0f}min "
                      f"-> {out.name}")
