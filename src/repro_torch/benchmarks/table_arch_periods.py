"""Per-architecture instantiation of the paper's model on the production
mesh, through the scenario catalog: checkpoint bytes -> C, platform MTBF
-> optimal periods and predicted energy gains, the whole architecture
table solved as one grid (``evaluate_grid`` on ``device``, f64).  The
reference's ``benchmarks/table_arch_periods.py``, its CSV byte for byte."""
from __future__ import annotations

from ..configs import ALL_ARCHS
from ..sim import arch_grid, evaluate_grid
from ..sim.precision import F64
from ..sim.scenarios import STATE_BYTES_PER_PARAM
from . import _util


def run(device="cuda"):
    """``(csv path, the row of the largest C, rows)``; a row is (arch,
    params in billions, state GiB, C s, AlgoT and AlgoE periods s, energy
    and time ratios)."""
    hosts, bw = 64, 8e9
    names = [c.name for c in ALL_ARCHS]
    grid = arch_grid(names, device=device, hosts=hosts, bw=bw, n_nodes=256,
                     D_s=60.0, omega=0.5, profile="paper")
    res = evaluate_grid(grid, precision=F64, device=device)
    cols = [t.tolist() for t in (grid.C, res.T_time, res.T_energy,
                                 res.energy_ratio, res.time_ratio)]
    rows = []
    for name, C, t_time, t_energy, e_ratio, t_ratio in zip(names, *cols):
        state_bytes = C * hosts * bw
        n = state_bytes / STATE_BYTES_PER_PARAM
        rows.append((name, n / 1e9, state_bytes / 2**30, C, t_time, t_energy,
                     e_ratio, t_ratio))
    out = _util.out_path("table_arch_periods.csv")
    with open(out, "w") as f:
        f.write("arch,params_B,state_GiB,C_s,T_opt_time_s,T_opt_energy_s,"
                "energy_ratio,time_ratio\n")
        for r in rows:
            f.write(f"{r[0]},{r[1]:.2f},{r[2]:.1f},{r[3]:.2f},{r[4]:.1f},"
                    f"{r[5]:.1f},{r[6]:.4f},{r[7]:.4f}\n")
    big = max(rows, key=lambda r: r[3])
    return out, big, rows


def main(device="cuda") -> str:
    (out, big, _), us = _util.timed(run, device, repeat=2)
    return _util.emit("table_arch_periods", us,
                      f"largest C: {big[0]} C={big[3]:.1f}s "
                      f"T_opt={big[4]:.0f}s -> {out.name}")
