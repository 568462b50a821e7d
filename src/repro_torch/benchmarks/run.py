"""The paper's figures and tables on the port, one after another: the
counterpart of the reference's ``benchmarks/run.py`` without the system
benches.

Prints ``name,us_per_call,derived`` rows and writes each script's CSV to
``build/repro_torch_results/``.  The scripts that draw take the caller's
numpy generators (``np.random.default_rng(0)`` for the table and fig5,
``default_rng(1)`` for fig5's validation reproduce the reference's
seeds).
"""
from __future__ import annotations

import numpy as np

from . import (fig1_rho_sweep, fig2_mu_rho, fig3_scalability,
               fig4_multilevel, fig5_robustness, table_arch_periods,
               table_baselines, table_simulation)


def run_figures(rng_table: np.random.Generator,
                rng_fig5: np.random.Generator,
                rng_validate: np.random.Generator, device="cuda") -> list:
    """Run every figure and table on ``device``, all in f64 (fig1-4's
    sweeps, the scalar solvers, fig5's event kernel, the architecture
    table's sweep); returns the rows."""
    print("name,us_per_call,derived")
    return [fig1_rho_sweep.main(device), fig2_mu_rho.main(device),
            fig3_scalability.main(device), fig4_multilevel.main(device),
            fig5_robustness.main(rng_fig5, rng_validate, device),
            table_baselines.main(device),
            table_simulation.main(rng_table, device),
            table_arch_periods.main(device)]
