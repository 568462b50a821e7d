"""Figure 4 (this reproduction): multilevel (buddy + PFS) trade-off
surfaces.

Sweeps the Exascale two-level scenario family over buddy-cost ratio x
buddy-loss probability, jointly optimising (T, m) for AlgoT and AlgoE in
one ``sim.evaluate_multilevel_grid`` call (f64), and records per point the
optimal periods and cadences, the gains of the two-level scheme over the
PFS-only single-level optimum, and the AlgoT-vs-AlgoE trade-off.  Writes
``fig4_multilevel.csv``.
"""
from __future__ import annotations

import csv

import numpy as np

from ..sim import F64, buddy_ratio_grid, evaluate_multilevel_grid
from . import _util

RATIOS = [0.02, 0.05, 0.1, 0.2, 0.4, 1.0]
QS = [0.01, 0.05, 0.1, 0.2, 0.4]
MU_MIN = 300.0
M_VALUES = tuple(range(1, 13))

_COLUMNS = ("m_time", "T_time", "m_energy", "T_energy", "time_ratio",
            "energy_ratio", "time_vs_single", "energy_vs_single")


def run(device="cuda"):
    """``(csv path, MultilevelGridResult, headline, rows)``: the headline
    is the strongest two-level win, ``(energy below PFS-only, ratio, q,
    m*)``; rows are the CSV's dicts."""
    grid = buddy_ratio_grid(RATIOS, QS, mu_min=MU_MIN, device=device)
    res = evaluate_multilevel_grid(grid, m_values=M_VALUES, precision=F64,
                                   device=device)
    host = {f: getattr(res, f).cpu().numpy() for f in _COLUMNS}
    rows = []
    for i, r in enumerate(RATIOS):
        for j, q in enumerate(QS):
            row = {"buddy_ratio": r, "q": q, "mu_min": MU_MIN}
            for f in _COLUMNS:
                v = host[f][i, j]
                row[f] = int(v) if f.startswith("m_") else float(v)
            rows.append(row)
    out = _util.out_path("fig4_multilevel.csv")
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    evs = host["energy_vs_single"]
    k = np.unravel_index(np.nanargmin(evs), evs.shape)
    head = (float(1.0 - evs[k]), RATIOS[k[0]], QS[k[1]],
            int(host["m_energy"][k]))
    return out, res, head, rows


def main(device="cuda") -> str:
    (out, _, head, _), us = _util.timed(run, device, repeat=3)
    return _util.emit(
        "fig4_multilevel", us,
        f"{len(RATIOS)}x{len(QS)} grid x {len(M_VALUES)} cadences; "
        f"best energy {100 * head[0]:.0f}% below PFS-only "
        f"(ratio={head[1]:g}, q={head[2]:g}, m*={head[3]}) -> {out.name}")
