"""Baseline comparison (paper §3.2 side note): AlgoT / AlgoE against
Young, Daly and the Meneses-Sarood-Kale energy model, plus the
printed-coefficient erratum (the scalar solvers, on ``device``)."""
from __future__ import annotations

from ..core import (EXASCALE_POWER_RHO55, EXASCALE_POWER_RHO7,
                    derived_coefficients, energy_final,
                    energy_quadratic_coefficients, fig12_checkpoint,
                    paper_printed_coefficients, t_daly, t_msk_energy,
                    t_opt_energy, t_opt_time, t_young, time_final)
from . import _util


def run(device="cuda"):
    """``(csv path, (paper c2 error, derived c2 error), rows)``; rows are
    (mu, strategy, period, T_final, E_final) at T_base = 1."""
    rows = []
    for mu in (300.0, 120.0, 60.0):
        ck = fig12_checkpoint(mu)
        pw = EXASCALE_POWER_RHO55
        periods = {
            "algo_t": t_opt_time(ck, device),
            "algo_e": t_opt_energy(ck, pw, device),
            "young": t_young(ck),
            "daly": t_daly(ck),
            "msk_energy": t_msk_energy(ck, pw, device),
        }
        for name, T in periods.items():
            rows.append((mu, name, T,
                         float(time_final(T, ck, device=device)),
                         float(energy_final(T, ck, pw, device=device))))
    out = _util.out_path("table_baselines.csv")
    with open(out, "w") as f:
        f.write("mu_min,strategy,period_min,T_final_norm,E_final_norm\n")
        for r in rows:
            f.write(f"{r[0]},{r[1]},{r[2]:.4f},{r[3]:.6f},{r[4]:.6f}\n")

    # erratum: the paper's printed coefficients are wrong when alpha != 1
    ck = fig12_checkpoint(300.0)
    ours = derived_coefficients(ck, EXASCALE_POWER_RHO7)
    paper = paper_printed_coefficients(ck, EXASCALE_POWER_RHO7)
    exact = energy_quadratic_coefficients(ck, EXASCALE_POWER_RHO7, device)
    err_paper = abs(paper[0] - exact[0]) / abs(exact[0])
    err_ours = abs(ours[0] - exact[0]) / abs(exact[0])
    return out, (err_paper, err_ours), rows


def main(device="cuda") -> str:
    (out, (ep, eo), _), us = _util.timed(run, device, repeat=1)
    return _util.emit("table_baselines", us,
                      f"erratum@rho7: paper_c2_err={ep:.2%} "
                      f"derived_c2_err={eo:.2e} -> {out.name}")
