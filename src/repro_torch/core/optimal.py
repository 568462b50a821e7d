"""Optimal checkpoint periods: AlgoT, AlgoE, and literature baselines.

AlgoT  — closed form  T_opt = sqrt(2 a b mu)  (paper Eq. (1)).
AlgoE  — the minimum-branch root of the exact quadratic K(T)*E'(T), its
         coefficients recovered by interpolating the analytic product at
         3 points (a 4th verifies the residual), guarded by a golden-section
         argmin of E_final.
Young  — T = sqrt(2 C mu) + C                      [Young 1974]
Daly   — T = sqrt(2 C (mu + D + R)) + C            [Daly 2004]
MSK    — Meneses–Sarood–Kalé energy model as the paper's §3.2 side note
         describes it (omega = 0; per-failure re-exec (T-2C)/2, I/O C).

These are scalar solvers: the model is evaluated as f64 tensors on
``device`` and the root bookkeeping runs on the host.  For non-exponential
failure processes :class:`MCSurrogate` and the ``*_mc`` solvers find the
periods on a Monte-Carlo surrogate run by ``sim.engine``.  The closed forms
that read only the dataclass fields (Young, Daly, the derived
coefficients) are plain host arithmetic and take no device.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import as_f64, resolve_device
from . import model
from .failures import FailureProcess, as_process
from .params import (CheckpointParams, MultilevelCheckpointParams,
                     MultilevelPowerParams, PowerParams)

_GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0

logger = logging.getLogger(__name__)


def _scalar(x) -> float:
    """One model evaluation as a host float."""
    return x.item()


def golden_section(f: Callable[[float], float], lo: float, hi: float,
                   tol: float = 1e-10, max_iter: int = 200) -> float:
    """Minimize unimodal ``f`` on [lo, hi] to relative tolerance ``tol``."""
    a, b = float(lo), float(hi)
    c = b - _GOLDEN * (b - a)
    d = a + _GOLDEN * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(max_iter):
        if abs(b - a) <= tol * (abs(a) + abs(b)):
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - _GOLDEN * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + _GOLDEN * (b - a)
            fd = f(d)
    return 0.5 * (a + b)


def _bracket(ckpt: CheckpointParams) -> Tuple[float, float]:
    """Valid open interval for T, slightly shrunk for numerical safety."""
    lo, hi = ckpt.valid_period_range()
    if hi <= lo:
        raise ValueError(
            f"No valid period: need lower bound max(a={ckpt.a}, C={ckpt.C})"
            f"={lo} < 2*mu*b={hi}; platform MTBF mu={ckpt.mu} too small for "
            f"these checkpoint costs.")
    span = hi - lo
    return lo + 1e-9 * span + 1e-12, hi - 1e-9 * span


# --------------------------------------------------------------------------
# AlgoT — time-optimal period
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PeriodResult:
    """A solved period plus provenance: whether the closed form was clamped
    into the valid bracket and which method produced it."""

    T: float
    clamped: bool = False
    method: str = "closed_form"      # "closed_form" | "numeric"


def t_opt_time_ex(ckpt: CheckpointParams, device="cuda") -> PeriodResult:
    """AlgoT with provenance (see :class:`PeriodResult`)."""
    val = 2.0 * ckpt.a * ckpt.b * ckpt.mu
    if val <= 0:
        # omega == 1 (a == 0) or mu too small: numeric fallback.
        return PeriodResult(T=t_opt_time_numeric(ckpt, device=device),
                            method="numeric")
    t = math.sqrt(val)
    lo, hi = _bracket(ckpt)
    t_clamped = float(min(max(t, lo), hi))
    return PeriodResult(T=t_clamped, clamped=t_clamped != t)


def t_opt_time(ckpt: CheckpointParams, device="cuda") -> float:
    """Paper Eq. (1); logs a warning when the closed form is clamped to the
    edge of the valid bracket (a boundary answer)."""
    res = t_opt_time_ex(ckpt, device)
    if res.clamped:
        logger.warning(
            "t_opt_time: closed form sqrt(2*a*b*mu) fell outside the valid "
            "period bracket and was clamped to %g (ckpt=%r); treat as a "
            "boundary answer", res.T, ckpt)
    return res.T


def t_opt_time_numeric(ckpt: CheckpointParams, T_base: float = 1.0,
                       device="cuda") -> float:
    """Golden-section argmin of the exact T_final (validation path)."""
    lo, hi = _bracket(ckpt)
    return golden_section(
        lambda t: _scalar(model.time_final(t, ckpt, T_base, device)), lo, hi)


# --------------------------------------------------------------------------
# AlgoE — energy-optimal period
# --------------------------------------------------------------------------

def energy_quadratic_coefficients(ckpt: CheckpointParams, power: PowerParams,
                                  device="cuda") -> Tuple[float, float, float]:
    """Coefficients (c2, c1, c0) of the exact quadratic Q(T) = K(T) * E'(T),
    interpolated at 3 points and verified at a 4th."""
    lo, hi = _bracket(ckpt)
    ts = np.array([lo + 0.2 * (hi - lo), lo + 0.45 * (hi - lo),
                   lo + 0.7 * (hi - lo)])
    qs = np.array(model.K_dE_dT(ts, ckpt, power, device=device).tolist())
    V = np.vander(ts, 3)            # columns: t^2, t, 1
    c2, c1, c0 = np.linalg.solve(V, qs)

    t4 = lo + 0.9 * (hi - lo)
    q4 = _scalar(model.K_dE_dT(t4, ckpt, power, device=device))
    q4_poly = c2 * t4**2 + c1 * t4 + c0
    scale = max(abs(q4), abs(q4_poly), abs(c0), 1e-300)
    if not abs(q4 - q4_poly) <= 1e-6 * scale:
        raise AssertionError(
            f"K*E' deviates from a quadratic: {q4} vs {q4_poly} "
            f"(paper §3.2 cancellation violated — formula bug?)")
    return float(c2), float(c1), float(c0)


def derived_coefficients(ckpt: CheckpointParams, power: PowerParams,
                         ) -> Tuple[float, float, float]:
    """Corrected closed-form quadratic coefficients (the reference's
    erratum-corrected algebra)."""
    C, mu = ckpt.C, ckpt.mu
    a, b, omega = ckpt.a, ckpt.b, ckpt.omega
    al, be, ga = power.alpha, power.beta, power.gamma
    P = al * omega * C + be * ckpt.R + ga * ckpt.D
    Q = (be - al * (1.0 - omega)) * C**2
    c2 = (1 / (2 * mu) + P / (2 * mu**2) + al * b / (2 * mu)
          + (al * a - be * C) / (4 * mu**2))
    c1 = (be * C - al * a) * b / mu + Q / (2 * mu**2)
    c0 = (-a * b * (P + mu) / mu - be * C * b**2
          - Q * (b / (2 * mu) + a / (4 * mu**2)))
    return float(c2), float(c1), float(c0)


def paper_printed_coefficients(
        ckpt: CheckpointParams, power: PowerParams,
) -> Tuple[float, float, float]:
    """The paper's final displayed quadratic coefficients, verbatim: kept
    for the erratum comparison (its constant term disagrees with the exact
    interpolated quadratic when alpha != 1)."""
    C, R, D, mu = ckpt.C, ckpt.R, ckpt.D, ckpt.mu
    a, b, omega = ckpt.a, ckpt.b, ckpt.omega
    al, be, ga = power.alpha, power.beta, power.gamma
    c2 = ((al * omega * C + be * R + ga * D) / (2 * mu**2)
          + b / (2 * mu) + (a - be * C) / (4 * mu**2) + 1 / (2 * mu))
    c1 = ((be * C - a) * b / mu
          - 2 * (al * (1 - omega) - be) * C**2 / (4 * mu**2))
    c0 = (-a * b * (al * omega * C + be * R + ga * D + mu) / mu
          - be * C * b**2
          + (b / (2 * mu) + a / (4 * mu**2)) * (al * (1 - omega) - be) * C**2)
    return float(c2), float(c1), float(c0)


def _pick_energy_root(c2: float, c1: float, c0: float, lo: float, hi: float,
                      energy: Callable[[float], float],
                      numeric: Callable[[], float]) -> float:
    """AlgoE root selection on Q = K*E': the unique in-bracket root with
    Q' > 0 (a minimum of E, since K > 0); otherwise cross-check against the
    numeric argmin and prefer it on disagreement."""
    roots = np.roots([c2, c1, c0]) if abs(c2) > 0 else np.array(
        [-c0 / c1] if abs(c1) > 0 else [])
    cands = [float(r.real) for r in np.atleast_1d(roots)
             if abs(r.imag) < 1e-9 * max(1.0, abs(r.real))
             and lo < r.real < hi]
    if not cands:
        return numeric()
    es = [energy(t) for t in cands]
    t_best = cands[int(np.argmin(es))]
    if len(cands) == 1 and 2.0 * c2 * t_best + c1 > 0.0:
        return t_best
    t_num = numeric()
    e_num = energy(t_num)
    if 2.0 * c2 * t_best + c1 <= 0.0 or e_num < min(es) * (1.0 - 1e-12):
        return t_num
    return t_best


def t_opt_energy(ckpt: CheckpointParams, power: PowerParams,
                 device="cuda") -> float:
    """AlgoE: the positive root of K(T) E'(T) = 0, guarded by
    :func:`_pick_energy_root`."""
    lo, hi = _bracket(ckpt)
    try:
        c2, c1, c0 = energy_quadratic_coefficients(ckpt, power, device)
    except AssertionError:
        return t_opt_energy_numeric(ckpt, power, device=device)
    return _pick_energy_root(
        c2, c1, c0, lo, hi,
        energy=lambda t: _scalar(model.energy_final(t, ckpt, power,
                                                    device=device)),
        numeric=lambda: t_opt_energy_numeric(ckpt, power, device=device))


def t_opt_energy_numeric(ckpt: CheckpointParams, power: PowerParams,
                         T_base: float = 1.0, device="cuda") -> float:
    """Golden-section argmin of the exact E_final (validation path)."""
    lo, hi = _bracket(ckpt)
    return golden_section(
        lambda t: _scalar(model.energy_final(t, ckpt, power, T_base,
                                             device)), lo, hi)


# --------------------------------------------------------------------------
# Multilevel (buddy + PFS) joint (T, m) solvers
# --------------------------------------------------------------------------

DEFAULT_M_MAX = 12


def _ml_bracket(ck: MultilevelCheckpointParams,
                m: int) -> Optional[Tuple[float, float]]:
    """Shrunk valid (lo, hi) for period T at a given m; None if degenerate."""
    lo, hi = ck.valid_period_range(m)
    if hi <= lo * (1.0 + 1e-9):
        return None
    span = hi - lo
    return lo + 1e-9 * span + 1e-12, hi - 1e-9 * span


def t_opt_time_multilevel(ck: MultilevelCheckpointParams,
                          m_max: int = DEFAULT_M_MAX,
                          device="cuda") -> Tuple[float, int]:
    """Jointly time-optimal (T, m): per-m closed form
    T*(m) = sqrt(2 a_m b_m mu_m), argmin of T_final over m."""
    best = None
    for m in range(1, m_max + 1):
        br = _ml_bracket(ck, m)
        if br is None:
            continue
        lo, hi = br
        val = 2.0 * ck.a(m) * ck.b(m) * ck.mu_eff(m)
        if val > 0:
            t = float(min(max(math.sqrt(val), lo), hi))
        else:  # omega == 1 degenerates the closed form: numeric fallback
            t = golden_section(
                lambda x: _scalar(model.ml_time_final(x, m, ck,
                                                      device=device)),
                lo, hi)
        tf = _scalar(model.ml_time_final(t, m, ck, device=device))
        if best is None or tf < best[0]:
            best = (tf, t, m)
    if best is None:
        raise ValueError(
            f"No valid (T, m): deep checkpoint C2={ck.C2} too large for "
            f"platform MTBF mu={ck.mu} at every m <= {m_max}.")
    return best[1], best[2]


def ml_energy_quadratic_coefficients(
        ck: MultilevelCheckpointParams, power: MultilevelPowerParams,
        m: int, device="cuda") -> Tuple[float, float, float]:
    """Coefficients of the exact quadratic Q_m(T) = K_m(T) * E'(T),
    interpolated at 3 points and verified at a 4th."""
    br = _ml_bracket(ck, m)
    if br is None:
        raise ValueError(f"no valid period at m={m}")
    lo, hi = br
    ts = np.array([lo + 0.2 * (hi - lo), lo + 0.45 * (hi - lo),
                   lo + 0.7 * (hi - lo)])
    qs = np.array(model.ml_K_dE_dT(ts, m, ck, power,
                                   device=device).tolist())
    V = np.vander(ts, 3)
    c2, c1, c0 = np.linalg.solve(V, qs)

    t4 = lo + 0.9 * (hi - lo)
    q4 = _scalar(model.ml_K_dE_dT(t4, m, ck, power, device=device))
    q4_poly = c2 * t4**2 + c1 * t4 + c0
    scale = max(abs(q4), abs(q4_poly), abs(c0), 1e-300)
    if not abs(q4 - q4_poly) <= 1e-6 * scale:
        raise AssertionError(
            f"K_m*E' deviates from a quadratic at m={m}: {q4} vs {q4_poly} "
            f"(multilevel §3.2 cancellation violated — formula bug?)")
    return float(c2), float(c1), float(c0)


def _t_opt_energy_ml_at(ck: MultilevelCheckpointParams,
                        power: MultilevelPowerParams, m: int,
                        device="cuda") -> float:
    """Energy-optimal T at fixed m (quadratic root + shared guard)."""
    lo, hi = _ml_bracket(ck, m)
    energy = lambda t: _scalar(model.ml_energy_final(t, m, ck, power,
                                                     device=device))

    def numeric() -> float:
        return golden_section(energy, lo, hi)

    try:
        c2, c1, c0 = ml_energy_quadratic_coefficients(ck, power, m, device)
    except AssertionError:
        return numeric()
    return _pick_energy_root(c2, c1, c0, lo, hi, energy=energy,
                             numeric=numeric)


def t_opt_energy_multilevel(ck: MultilevelCheckpointParams,
                            power: MultilevelPowerParams,
                            m_max: int = DEFAULT_M_MAX,
                            device="cuda") -> Tuple[float, int]:
    """Jointly energy-optimal (T, m): per-m quadratic root, argmin over m."""
    best = None
    for m in range(1, m_max + 1):
        if _ml_bracket(ck, m) is None:
            continue
        t = _t_opt_energy_ml_at(ck, power, m, device)
        e = _scalar(model.ml_energy_final(t, m, ck, power, device=device))
        if best is None or e < best[0]:
            best = (e, t, m)
    if best is None:
        raise ValueError(
            f"No valid (T, m): deep checkpoint C2={ck.C2} too large for "
            f"platform MTBF mu={ck.mu} at every m <= {m_max}.")
    return best[1], best[2]


# --------------------------------------------------------------------------
# MC-surrogate solvers for non-exponential failure processes
# --------------------------------------------------------------------------
#
# No closed form exists for Weibull / log-normal / trace failures, so the
# optimal period is found on a Monte-Carlo surrogate: one schedule set
# (common random numbers) is reused for every candidate T, which makes the
# objective a deterministic, nearly smooth function of T.  A coarse grid
# scan localizes the argmin's basin; golden section on the surrogate
# polishes it.


class MCSurrogate:
    """CRN Monte-Carlo objective E[T_final] / E[E_final] as a function of T.

    Built once per (ckpt, power, process): the schedule is sampled once on
    the host from the caller's ``rng`` (``np.random.default_rng(s)``
    reproduces the reference's ``seed=s``) and moved to ``device`` once;
    every evaluation replays it through ``sim.engine.simulate_candidates``
    (one launch for all of a call's candidates under the event kinds), so
    calls are deterministic and comparable across T.
    """

    def __init__(self, ckpt: CheckpointParams, power: PowerParams,
                 process: Optional[FailureProcess] = None,
                 T_base: Optional[float] = None, n_trials: int = 160, *,
                 rng: np.random.Generator,
                 engine_kind: Optional[str] = None, dispatch=None,
                 device="cuda"):
        # imported here: the sim package imports core
        from ..sim import engine as _engine
        from ..sim.scenarios import ParamGrid
        self.ckpt, self.power = ckpt, power
        self.process = as_process(process)
        self.engine_kind = _engine.resolve_engine_kind(engine_kind)
        self.dispatch = dispatch
        self.device = resolve_device(device)
        lo, hi = _bracket(ckpt)
        t_ref = t_opt_time_ex(ckpt, self.device).T
        # Generous decades around the exponential optimum, clear of the
        # bracket edges where E[T_final] diverges and the budgets with it.
        self.lo = max(lo * 1.02, t_ref / 10.0)
        self.hi = min(hi * 0.9, t_ref * 10.0)
        if T_base is None:
            # many periods and failures per trajectory, a sane budget
            T_base = max(30.0 * t_ref, 10.0 * ckpt.mu)
        self.T_base = float(T_base)
        self.n_trials = int(n_trials)

        self._grid1 = ParamGrid.from_params(ckpt, power,
                                            self.device).reshape((1,))
        probes = np.linspace(self.lo, self.hi, 9)
        cap = _engine.default_fail_capacity(probes, self._grid1, self.T_base,
                                            process=self.process)
        self._n_steps = (None if self.engine_kind in _engine._EVENT_LIKE
                         else _engine.default_step_budget(
                             probes, self._grid1, self.T_base,
                             process=self.process))
        gaps = _engine.presample_gaps(self._grid1, self.n_trials, cap, rng,
                                      process=self.process)
        self._gaps = torch.as_tensor(gaps, dtype=torch.float64,
                                     device=self.device)
        self._engine = _engine
        self._first_evals: dict = {}   # initial argmin grid, shared by keys

    def __call__(self, Ts) -> dict:
        """Mean wall time / energy (+ standard errors) at each candidate T,
        host numpy arrays; all candidates share the schedule."""
        Ts = np.atleast_1d(np.asarray(Ts, dtype=np.float64))
        tb = self._engine.simulate_candidates(
            Ts, self._grid1, self.T_base, gaps=self._gaps,
            n_steps=self._n_steps, engine_kind=self.engine_kind,
            dispatch=self.dispatch, device=self.device)
        if bool(tb.truncated.any()):
            raise RuntimeError("MC surrogate: step budget exceeded — "
                               "candidate period too close to the bracket "
                               "edge for this failure process")
        if bool(tb.gaps_exhausted.any()):
            raise RuntimeError("MC surrogate: failure schedule exhausted — "
                               "increase the pre-sample capacity")
        wall, energy = tb.wall_time[:, 0, :], tb.energy[:, 0, :]
        n = wall.shape[-1]
        host = lambda x: x.cpu().numpy()
        se = lambda a: host(a.std(dim=-1, correction=1)) / math.sqrt(n)
        return {"time": host(wall.mean(dim=-1)),
                "energy": host(energy.mean(dim=-1)),
                "time_se": se(wall), "energy_se": se(energy)}

    def argmin(self, key: str, rounds: int = 3, pts: int = 17) -> float:
        """Coarse-to-fine grid localization + golden-section polish of the
        surrogate argmin for ``key`` in {"time", "energy"}."""
        lo, hi = self.lo, self.hi
        xs = np.geomspace(lo, hi, pts)
        for rnd in range(rounds):
            if rnd == 0:
                # the first (geomspace) grid is the same for both keys
                if pts not in self._first_evals:
                    self._first_evals[pts] = self(xs)
                ys = self._first_evals[pts][key]
            else:
                ys = self(xs)[key]
            i = int(np.argmin(ys))
            lo, hi = xs[max(i - 1, 0)], xs[min(i + 1, pts - 1)]
            xs = np.linspace(lo, hi, pts)
        return golden_section(lambda t: float(self([t])[key][0]), lo, hi,
                              tol=1e-6, max_iter=40)


def t_opt_time_mc(ckpt: CheckpointParams,
                  process: Optional[FailureProcess] = None,
                  power: Optional[PowerParams] = None,
                  T_base: Optional[float] = None, n_trials: int = 160, *,
                  rng: np.random.Generator,
                  engine_kind: Optional[str] = None, dispatch=None,
                  device="cuda") -> float:
    """Time-optimal period under an arbitrary failure process (MC
    surrogate); with the exponential process it converges to AlgoT."""
    power = power or PowerParams(P_static=1.0, P_cal=0.0, P_io=0.0)
    return MCSurrogate(ckpt, power, process, T_base, n_trials, rng=rng,
                       engine_kind=engine_kind, dispatch=dispatch,
                       device=device).argmin("time")


def t_opt_energy_mc(ckpt: CheckpointParams, power: PowerParams,
                    process: Optional[FailureProcess] = None,
                    T_base: Optional[float] = None, n_trials: int = 160, *,
                    rng: np.random.Generator,
                    engine_kind: Optional[str] = None, dispatch=None,
                    device="cuda") -> float:
    """Energy-optimal period under an arbitrary failure process."""
    return MCSurrogate(ckpt, power, process, T_base, n_trials, rng=rng,
                       engine_kind=engine_kind, dispatch=dispatch,
                       device=device).argmin("energy")


def mc_evaluate_periods(Ts: Sequence[float], ckpt: CheckpointParams,
                        power: PowerParams,
                        process: Optional[FailureProcess] = None,
                        T_base: Optional[float] = None, n_trials: int = 160,
                        *, rng: np.random.Generator,
                        engine_kind: Optional[str] = None, dispatch=None,
                        device="cuda") -> dict:
    """Mean wall time / energy at each candidate period under ``process``
    (one schedule shared by all candidates)."""
    return MCSurrogate(ckpt, power, process, T_base, n_trials, rng=rng,
                       engine_kind=engine_kind, dispatch=dispatch,
                       device=device)(Ts)


# --------------------------------------------------------------------------
# Literature baselines
# --------------------------------------------------------------------------

def t_young(ckpt: CheckpointParams) -> float:
    """Young 1974: T = sqrt(2 C mu) + C (blocking model)."""
    return math.sqrt(2.0 * ckpt.C * ckpt.mu) + ckpt.C


def t_daly(ckpt: CheckpointParams) -> float:
    """Daly 2004 (first-order form): T = sqrt(2 C (mu + D + R)) + C."""
    return math.sqrt(2.0 * ckpt.C * (ckpt.mu + ckpt.D + ckpt.R)) + ckpt.C


def _msk_energy(T, ckpt: CheckpointParams, power: PowerParams,
                T_base: float = 1.0, device="cuda"):
    """MSK energy objective (omega forced to 0; re-exec (T-2C)/2 and a full
    checkpoint of I/O per failure)."""
    ck0 = CheckpointParams(C=ckpt.C, R=ckpt.R, D=ckpt.D, mu=ckpt.mu, omega=0.0)
    T = as_f64(T, device)
    Tf = model.time_final(T, ck0, T_base, T.device)
    nf = Tf / ck0.mu
    T_cal = T_base + nf * (T - 2.0 * ck0.C) / 2.0
    T_io = T_base * ck0.C / (T - ck0.C) + nf * (ck0.R + ck0.C)
    T_down = nf * ck0.D
    return (T_cal * power.P_cal + T_io * power.P_io
            + T_down * power.P_down + Tf * power.P_static)


def t_msk_energy(ckpt: CheckpointParams, power: PowerParams,
                 device="cuda") -> float:
    """Energy-optimal period under the MSK approximation (numeric argmin)."""
    ck0 = CheckpointParams(C=ckpt.C, R=ckpt.R, D=ckpt.D, mu=ckpt.mu, omega=0.0)
    lo, hi = _bracket(ck0)
    lo = max(lo, 2.0 * ck0.C + 1e-12)  # MSK re-exec term needs T > 2C
    return golden_section(
        lambda t: _scalar(_msk_energy(t, ck0, power, device=device)), lo, hi)


STRATEGIES = ("algo_t", "algo_e", "young", "daly", "msk_energy")


def period_for(strategy: str, ckpt: CheckpointParams,
               power: PowerParams | None = None, device="cuda") -> float:
    """Uniform entry point over :data:`STRATEGIES`."""
    if strategy == "algo_t":
        return t_opt_time(ckpt, device)
    if strategy == "algo_e":
        if power is None:
            raise ValueError("algo_e needs PowerParams")
        return t_opt_energy(ckpt, power, device)
    if strategy == "young":
        return t_young(ckpt)
    if strategy == "daly":
        return t_daly(ckpt)
    if strategy == "msk_energy":
        if power is None:
            raise ValueError("msk_energy needs PowerParams")
        return t_msk_energy(ckpt, power, device)
    raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
