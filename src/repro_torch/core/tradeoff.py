"""Time/energy trade-off sweeps — the quantities plotted in Figures 1-3.

All ratios follow the paper's conventions:
  time_ratio   = T_final(AlgoE) / T_final(AlgoT)   (>= 1; "loss in time")
  energy_ratio = E_final(AlgoT) / E_final(AlgoE)   (>= 1; "gain in energy")

:func:`evaluate` is the scalar path (one point, the exact solvers of
``optimal``).  The sweep functions solve the whole grid through the
batched ``repro_torch.sim`` sweeps (``engine="batched"``, the default)
or point by point (``engine="scalar"``), and return the same
:class:`TradeoffPoint` lists; :func:`evaluate_multilevel` and
:func:`sweep_buddy_ratio` do the same for the two-level (buddy + PFS)
platform and its joint (T, m).  :func:`evaluate_robustness` prices the
exponential-assumption periods under another failure process on a
Monte-Carlo surrogate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from . import model, optimal
from .failures import as_process
from .params import (CheckpointParams, MultilevelCheckpointParams,
                     MultilevelPowerParams, PowerParams, fig12_checkpoint,
                     fig3_checkpoint)


@dataclasses.dataclass(frozen=True)
class TradeoffPoint:
    ckpt: CheckpointParams
    power: PowerParams
    T_time: float              # AlgoT period
    T_energy: float            # AlgoE period
    time_ratio: float          # T_final(AlgoE)/T_final(AlgoT)
    energy_ratio: float        # E_final(AlgoT)/E_final(AlgoE)

    @property
    def energy_saving(self) -> float:
        """Fraction of energy saved by AlgoE vs AlgoT (paper: 'gain')."""
        return 1.0 - 1.0 / self.energy_ratio

    @property
    def time_overhead(self) -> float:
        """Fractional slowdown of AlgoE vs AlgoT (paper: 'loss')."""
        return self.time_ratio - 1.0


def evaluate(ckpt: CheckpointParams, power: PowerParams,
             device="cuda") -> TradeoffPoint:
    """One operating point through the scalar solvers on ``device``."""
    lo, hi = ckpt.valid_period_range()
    if hi <= lo * (1.0 + 1e-9):
        # Degenerate regime (paper §4, Fig. 3 right edge): both strategies
        # collapse to the minimum period ~ C and the ratios to 1.
        return TradeoffPoint(ckpt=ckpt, power=power, T_time=ckpt.C,
                             T_energy=ckpt.C, time_ratio=1.0,
                             energy_ratio=1.0)
    Tt = optimal.t_opt_time(ckpt, device)
    Te = optimal.t_opt_energy(ckpt, power, device)
    t_ratio = float(model.time_final(Te, ckpt, device=device)
                    / model.time_final(Tt, ckpt, device=device))
    e_ratio = float(model.energy_final(Tt, ckpt, power, device=device)
                    / model.energy_final(Te, ckpt, power, device=device))
    return TradeoffPoint(ckpt=ckpt, power=power, T_time=Tt, T_energy=Te,
                         time_ratio=t_ratio, energy_ratio=e_ratio)


def _points_from_grid(res) -> np.ndarray:
    """GridResult -> object array of TradeoffPoint with the grid's shape
    (one copy of the grid and the results to the host)."""
    grid = res.grid.to("cpu")
    host = {f: getattr(res, f).cpu().numpy()
            for f in ("T_time", "T_energy", "time_ratio", "energy_ratio")}
    out = np.empty(grid.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        out[idx] = TradeoffPoint(
            ckpt=grid.ckpt_at(idx), power=grid.power_at(idx),
            **{f: float(v[idx]) for f, v in host.items()})
    return out


# ----------------------------------------------------------------------
# Figure 1: ratios as a function of rho, at one mu
# ----------------------------------------------------------------------

def sweep_rho(rhos: Sequence[float], mu_minutes: float, alpha: float = 1.0,
              engine: str = "batched",
              device="cuda") -> list[TradeoffPoint]:
    """C=R=10, D=1, omega=1/2 (paper Fig. 1); rho swept at fixed alpha."""
    if engine == "scalar":
        ck = fig12_checkpoint(mu_minutes)
        return [evaluate(ck, PowerParams.from_rho(rho=r, alpha=alpha),
                         device) for r in rhos]
    from ..sim import sweep_rho_grid
    res = sweep_rho_grid(rhos, mu_minutes, alpha, device)
    return list(_points_from_grid(res)[0])


# ----------------------------------------------------------------------
# Figure 2: ratio surfaces over (mu, rho)
# ----------------------------------------------------------------------

def sweep_mu_rho(mus: Sequence[float], rhos: Sequence[float],
                 alpha: float = 1.0, engine: str = "batched",
                 device="cuda") -> list[list[TradeoffPoint]]:
    if engine == "scalar":
        return [[evaluate(fig12_checkpoint(mu),
                          PowerParams.from_rho(rho=r, alpha=alpha), device)
                 for r in rhos] for mu in mus]
    from ..sim import sweep_mu_rho_grid
    res = sweep_mu_rho_grid(mus, rhos, alpha, device)
    return [list(row) for row in _points_from_grid(res)]


# ----------------------------------------------------------------------
# Figure 3: scalability in the number of nodes
# ----------------------------------------------------------------------

def sweep_nodes(n_nodes: Sequence[float], power: PowerParams,
                engine: str = "batched",
                device="cuda") -> list[TradeoffPoint]:
    """C=R=1, D=0.1, omega=1/2, mu = 120 min at 1e6 nodes, ~ 1/N."""
    if engine == "scalar":
        return [evaluate(fig3_checkpoint(n), power, device) for n in n_nodes]
    from ..sim import sweep_nodes_grid
    res = sweep_nodes_grid(n_nodes, power, device)
    return list(_points_from_grid(res))


# ----------------------------------------------------------------------
# Multilevel (buddy + PFS) trade-off
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultilevelTradeoffPoint:
    """Jointly optimal (T, m) for AlgoT and AlgoE on a two-level platform,
    the ratios of :class:`TradeoffPoint`, and the comparison against the
    PFS-only single-level scheme."""

    ckpt: MultilevelCheckpointParams
    power: MultilevelPowerParams
    T_time: float              # AlgoT period
    m_time: int                # AlgoT PFS cadence (deep ckpt every m-th)
    T_energy: float            # AlgoE period
    m_energy: int
    time_ratio: float          # T_final(AlgoE)/T_final(AlgoT)
    energy_ratio: float        # E_final(AlgoT)/E_final(AlgoE)
    time_vs_single: float      # T_final(AlgoT, 2-level)/T_final(AlgoT, PFS-only)
    energy_vs_single: float    # E_final(AlgoE, 2-level)/E_final(AlgoE, PFS-only)

    @property
    def energy_saving(self) -> float:
        return 1.0 - 1.0 / self.energy_ratio

    @property
    def time_overhead(self) -> float:
        return self.time_ratio - 1.0


def evaluate_multilevel(ck: MultilevelCheckpointParams,
                        power: MultilevelPowerParams,
                        m_max: int = optimal.DEFAULT_M_MAX,
                        device="cuda") -> MultilevelTradeoffPoint:
    """One two-level operating point through the scalar joint (T, m)
    solvers on ``device``."""
    Tt, mt = optimal.t_opt_time_multilevel(ck, m_max, device)
    Te, me = optimal.t_opt_energy_multilevel(ck, power, m_max, device)
    tf = lambda T, m: float(model.ml_time_final(T, m, ck, device=device))
    en = lambda T, m: float(model.ml_energy_final(T, m, ck, power,
                                                  device=device))
    tf_t, tf_e, e_t, e_e = tf(Tt, mt), tf(Te, me), en(Tt, mt), en(Te, me)

    # PFS-only comparator (the single-level model on C2/R2/D2); where it
    # has no valid period at all (the buddy level rescuing an infeasible
    # platform) the vs-single ratios are NaN.
    sl_ck, sl_pw = ck.single_level(), power.single_level()
    lo, hi = sl_ck.valid_period_range()
    if hi <= lo * (1.0 + 1e-9):
        tvs = evs = float("nan")
    else:
        single = evaluate(sl_ck, sl_pw, device)
        tvs = tf_t / float(model.time_final(single.T_time, sl_ck,
                                            device=device))
        evs = e_e / float(model.energy_final(single.T_energy, sl_ck, sl_pw,
                                             device=device))
    return MultilevelTradeoffPoint(
        ckpt=ck, power=power, T_time=Tt, m_time=mt, T_energy=Te, m_energy=me,
        time_ratio=tf_e / tf_t, energy_ratio=e_t / e_e,
        time_vs_single=tvs, energy_vs_single=evs)


def sweep_buddy_ratio(ratios: Sequence[float], qs: Sequence[float],
                      mu_minutes: float = 300.0,
                      m_max: int = optimal.DEFAULT_M_MAX,
                      engine: str = "batched", device="cuda"):
    """Exascale two-level sweep: buddy cost ratio x buddy-loss probability.

    Returns a (len(ratios), len(qs)) nested list of
    :class:`MultilevelTradeoffPoint`.  The batched path solves the whole
    grid in one :func:`~repro_torch.sim.evaluate_multilevel_grid` call
    (under the resolved precision policy); ``engine="scalar"`` solves
    point by point.
    """
    if engine == "scalar":
        from ..sim.scenarios import get_scenario
        out = []
        for r in ratios:
            row = []
            for q in qs:
                sc = get_scenario("multilevel_exascale", mu_min=mu_minutes,
                                  buddy_ratio=float(r), q=float(q))
                row.append(evaluate_multilevel(sc.ckpt, sc.power, m_max,
                                               device))
            out.append(row)
        return out
    from ..sim import buddy_ratio_grid, evaluate_multilevel_grid
    res = evaluate_multilevel_grid(
        buddy_ratio_grid(ratios, qs, mu_min=mu_minutes, device=device),
        m_values=tuple(range(1, m_max + 1)), device=device)
    return [[res.point_at((i, j)) for j in range(len(qs))]
            for i in range(len(ratios))]


# ----------------------------------------------------------------------
# Robustness: what does assuming exponential failures cost?
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RobustnessPoint:
    """Time/energy penalty of exponential-assumption periods under a
    non-exponential failure process.

    ``T_exp_*`` come from the paper's closed forms (memoryless failures);
    ``T_mc_*`` are the optima under ``process`` (MC surrogate).  Penalties
    are ratios >= ~1, all on common random numbers.
    """

    ckpt: CheckpointParams
    power: PowerParams
    process: object                  # FailureProcess
    T_exp_time: float                # AlgoT closed form (exponential model)
    T_exp_energy: float              # AlgoE quadratic root
    T_young: float
    T_daly: float
    T_mc_time: float                 # process-optimal (MC surrogate)
    T_mc_energy: float
    time_penalty_exp: float          # wall(T_exp_time) / wall(T_mc_time)
    energy_penalty_exp: float        # E(T_exp_energy) / E(T_mc_energy)
    time_penalty_young: float
    time_penalty_daly: float
    energy_penalty_young: float
    energy_penalty_daly: float

    @property
    def time_left_on_table(self) -> float:
        """Fractional extra wall time from trusting the exponential T*."""
        return self.time_penalty_exp - 1.0

    @property
    def energy_left_on_table(self) -> float:
        return self.energy_penalty_exp - 1.0


def evaluate_robustness(ckpt: CheckpointParams, power: PowerParams,
                        process=None, T_base: Optional[float] = None,
                        n_trials: int = 160, *, rng: np.random.Generator,
                        device="cuda") -> RobustnessPoint:
    """One (platform, process) point: one CRN surrogate
    (``optimal.MCSurrogate``, its schedule from the caller's ``rng``), the
    process-optimal periods solved on it, and every candidate period
    scored on the same schedule."""
    process = as_process(process)
    sur = optimal.MCSurrogate(ckpt, power, process, T_base=T_base,
                              n_trials=n_trials, rng=rng, device=device)
    T_mc_t = sur.argmin("time")
    T_mc_e = sur.argmin("energy")
    Tt = optimal.t_opt_time(ckpt, device)
    Te = optimal.t_opt_energy(ckpt, power, device)
    Ty = optimal.t_young(ckpt)
    Td = optimal.t_daly(ckpt)
    # Baselines may leave the surrogate's safe range on extreme platforms;
    # clip so the evaluation stays within the sampled budget.
    cands = np.clip([T_mc_t, T_mc_e, Tt, Te, Ty, Td], sur.lo, sur.hi)
    vals = sur(cands)
    wall, energy = vals["time"], vals["energy"]
    return RobustnessPoint(
        ckpt=ckpt, power=power, process=process,
        T_exp_time=Tt, T_exp_energy=Te, T_young=Ty, T_daly=Td,
        T_mc_time=T_mc_t, T_mc_energy=T_mc_e,
        time_penalty_exp=float(wall[2] / wall[0]),
        energy_penalty_exp=float(energy[3] / energy[1]),
        time_penalty_young=float(wall[4] / wall[0]),
        time_penalty_daly=float(wall[5] / wall[0]),
        energy_penalty_young=float(energy[4] / energy[1]),
        energy_penalty_daly=float(energy[5] / energy[1]))
