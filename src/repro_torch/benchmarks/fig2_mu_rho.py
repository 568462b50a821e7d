"""Paper Figure 2: ratio surfaces over (mu, rho), C=R=10, D=1, omega=1/2,
the whole surface in one batched sweep."""
from __future__ import annotations

import numpy as np

from ..sim import F64, sweep_mu_rho_grid
from . import _util

MUS = [30, 60, 90, 120, 180, 240, 300, 420, 600]


def run(device="cuda"):
    """``(csv path, (mu, rho, energy_ratio) at the peak, rows)``; rows are
    (mu, rho, energy_ratio, time_ratio) floats."""
    rhos = list(np.linspace(1.0, 10.0, 10))
    res = sweep_mu_rho_grid(MUS, rhos, device=device, precision=F64)
    rho, er, tr = (x.cpu().numpy() for x in (res.grid.rho, res.energy_ratio,
                                             res.time_ratio))
    rows = [(float(mu), float(rho[i, j]), float(er[i, j]), float(tr[i, j]))
            for i, mu in enumerate(MUS) for j in range(len(rhos))]
    out = _util.out_path("fig2_mu_rho.csv")
    with open(out, "w") as f:
        f.write("mu_min,rho,energy_ratio,time_ratio\n")
        for mu, r, e, t in rows:
            f.write(f"{mu:.1f},{r:.3f},{e:.6f},{t:.6f}\n")
    k = np.unravel_index(np.argmax(er), er.shape)
    peak = (MUS[k[0]], float(rho[k]), float(er[k]))
    return out, peak, rows


def main(device="cuda") -> str:
    (out, peak, _), us = _util.timed(run, device, repeat=2)
    return _util.emit("fig2_mu_rho", us,
                      f"peak e_ratio={peak[2]:.3f} at mu={peak[0]:.0f} "
                      f"rho={peak[1]:.1f} -> {out.name}")
