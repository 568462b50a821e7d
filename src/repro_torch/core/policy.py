"""Checkpoint-period policy: the paper's formulas as a runtime decision.

The :class:`CheckpointPolicy` is the bridge between the analytical core and
the fault-tolerant trainer:

 * the trainer feeds it *measurements* (step time, per-level checkpoint
   durations C1/C2, overlap factor omega, per-level recovery times R1/R2,
   downtimes, observed failure times);
 * the policy maintains EWMA estimates, re-solves the chosen strategy
   (AlgoT / AlgoE / Young / Daly / MSK / fixed, or the joint multilevel
   ``algo_t_ml`` / ``algo_e_ml`` solvers) when estimates drift beyond
   ``drift_threshold``, and exposes the decision as "checkpoint every k
   steps" plus "write the deep (PFS) level every m-th checkpoint".

All policy times are SECONDS (the trainer's unit); the analytical model is
unit-agnostic so no conversion is needed beyond consistency.  The solvers
evaluate the model as f64 tensors on the policy's ``device`` (default
``"cuda"``); the estimates and the decision are host floats.

Step conversion semantics: the model's period T is *wall* time per period,
of which ``a = (1-omega) * C`` is the checkpoint's critical-path share and
``T - a`` is work.  Training steps carry only the work, and the trainer
charges the checkpoint's ``(1-omega)*C`` wall cost separately, so for the
model-driven strategies ``period_steps`` budgets ``(T - a) / step_time``
steps per period — making the *realized* wall period equal the solved T.
The ``fixed`` strategy keeps the literal interpretation (checkpoint every
``fixed_period_s`` seconds of stepping).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .._device import resolve_device
from . import model, optimal
from .params import (CheckpointParams, MultilevelCheckpointParams,
                     MultilevelPowerParams, PowerParams)

#: Joint (T, m) strategies: solve period AND deep-write cadence together.
ML_STRATEGIES = ("algo_t_ml", "algo_e_ml")


@dataclasses.dataclass
class _Ewma:
    """Exponentially-weighted mean with a drift detector."""

    alpha: float = 0.3
    value: Optional[float] = None

    def update(self, x: float) -> None:
        self.value = x if self.value is None else (
            self.alpha * x + (1.0 - self.alpha) * self.value)

    def get(self, default: float) -> float:
        return default if self.value is None else self.value


@dataclasses.dataclass
class PolicyConfig:
    strategy: str = "algo_t"          # optimal.STRATEGIES, ML_STRATEGIES
    fixed_period_s: float = 600.0     # used when strategy == "fixed"
    # Priors (used until enough measurements arrive).  C_s/R_s/D_s are the
    # deep (PFS, level-2) costs — for single-level strategies every
    # checkpoint is deep, so they are simply THE costs.
    C_s: float = 60.0
    R_s: float = 60.0
    D_s: float = 6.0
    mu_s: float = 24 * 3600.0         # platform MTBF prior
    omega: float = 0.5
    #: deep-flush overlap prior (VELOC async flush); None -> the shared
    #: ``omega`` applies to both levels.  Only read by the *_ml
    #: strategies, as ``MultilevelCheckpointParams.omega2``.
    omega2: Optional[float] = None
    # Multilevel (buddy, level-1) priors — only read by the *_ml strategies:
    C1_s: float = 6.0
    R1_s: float = 6.0
    D1_s: Optional[float] = None      # None -> D_s
    q: float = 0.1                    # P[failure also loses the buddy copy]
    m_max: int = optimal.DEFAULT_M_MAX
    # Re-solve when an estimate moves by more than this fraction:
    drift_threshold: float = 0.10
    min_period_steps: int = 1
    #: blend observed failure gaps into the MTBF estimate.  Disable when the
    #: platform MTBF is known (e.g. scaled-time validation runs) so the
    #: solved period is a pure function of the configured scenario.
    mu_from_observations: bool = True


class CheckpointPolicy:
    """Online period selection driven by the paper's model."""

    def __init__(self, config: PolicyConfig, power: PowerParams,
                 ml_power: Optional[MultilevelPowerParams] = None,
                 device="cuda"):
        self.config = config
        self.power = power
        #: where the solvers evaluate the model.
        self.device = resolve_device(device)
        #: per-level I/O powers for the *_ml energy solver; defaults to
        #: degenerate levels (buddy draws PFS power).
        self.ml_power = (ml_power if ml_power is not None
                         else MultilevelPowerParams.from_power(power))
        self._C = _Ewma()             # deep (level-2) checkpoint duration
        self._R = _Ewma()
        self._D = _Ewma()
        self._C1 = _Ewma()            # buddy (level-1) checkpoint duration
        self._R1 = _Ewma()
        self._D1 = _Ewma()
        self._omega = _Ewma()
        self._step_time = _Ewma(alpha=0.1)
        self._failure_gaps: list[float] = []
        self._last_failure_t: Optional[float] = None
        #: deep (PFS) tier health, driven by the checkpoint manager's
        #: degrade/heal FSM; False re-solves at the buddy-only tier.
        self._deep_available = True
        # (param values, (strategy, deep_available), T, m) of last solve
        self._cached: Optional[tuple] = None

    # ---- measurement intake ------------------------------------------------
    def observe_step_time(self, seconds: float) -> None:
        self._step_time.update(seconds)
        # step time changes do not invalidate the period (seconds-based).

    def observe_checkpoint(self, *, duration_s: float,
                           slowdown_work_fraction: float | None = None,
                           level: int = 2) -> None:
        """Record a completed checkpoint.

        ``level`` is the deepest level written: 2 for a deep (PFS) write,
        1 for a buddy-only write (the ``pfs_every`` cadence's cheap
        checkpoints).  ``slowdown_work_fraction`` is the measured omega:
        fraction of a normal step's work that still progressed per unit
        time while the checkpoint was in flight (1.0 = fully overlapped).
        """
        (self._C if level >= 2 else self._C1).update(duration_s)
        if slowdown_work_fraction is not None:
            self._omega.update(min(max(slowdown_work_fraction, 0.0), 1.0))

    def observe_recovery(self, *, recovery_s: float, downtime_s: float,
                         level: int = 2) -> None:
        """``level`` is the level the recovery read from (1 = buddy)."""
        (self._R if level >= 2 else self._R1).update(recovery_s)
        (self._D if level >= 2 else self._D1).update(downtime_s)

    def observe_failure(self, wall_time_s: float) -> None:
        if self._last_failure_t is not None:
            gap = wall_time_s - self._last_failure_t
            if gap > 0:
                self._failure_gaps.append(gap)
        self._last_failure_t = wall_time_s

    # ---- estimates ---------------------------------------------------------
    @property
    def is_multilevel(self) -> bool:
        return self.config.strategy in ML_STRATEGIES

    @property
    def mu_estimate_s(self) -> float:
        """MLE of the exponential MTBF from observed gaps, blended with the
        prior (the prior acts as one pseudo-observation); the prior alone
        when ``mu_from_observations`` is off."""
        cfg = self.config
        if not self._failure_gaps or not cfg.mu_from_observations:
            return cfg.mu_s
        n = len(self._failure_gaps)
        return (sum(self._failure_gaps) + cfg.mu_s) / (n + 1)

    def checkpoint_params(self) -> CheckpointParams:
        cfg = self.config
        return CheckpointParams(
            C=self._C.get(cfg.C_s),
            R=self._R.get(cfg.R_s),
            D=self._D.get(cfg.D_s),
            mu=self.mu_estimate_s,
            omega=self._omega.get(cfg.omega),
        )

    def checkpoint_params_ml(self) -> MultilevelCheckpointParams:
        cfg = self.config
        d1 = cfg.D_s if cfg.D1_s is None else cfg.D1_s
        return MultilevelCheckpointParams(
            C1=self._C1.get(cfg.C1_s), R1=self._R1.get(cfg.R1_s),
            C2=self._C.get(cfg.C_s), R2=self._R.get(cfg.R_s),
            D1=self._D1.get(d1), D2=self._D.get(cfg.D_s),
            mu=self.mu_estimate_s, q=cfg.q,
            omega=self._omega.get(cfg.omega),
            omega2=cfg.omega2,
        )

    def overlap_for(self, level: int) -> float:
        """The effective overlap factor of a level-``level`` write: the
        buddy's w1 / the deep flush's w2 under the *_ml strategies, the
        shared omega otherwise — what the trainer uses to split a write
        into its critical-path stall and its in-flight flush window."""
        if self.is_multilevel:
            ck = self.checkpoint_params_ml()
            return ck.w1 if level <= 1 else ck.w2
        return self.checkpoint_params().omega

    # ---- deep-tier health (driven by the manager's degrade/heal FSM) -------
    @property
    def deep_available(self) -> bool:
        return self._deep_available

    def set_deep_available(self, available: bool) -> None:
        """Flip the deep (PFS) tier's availability.  While unavailable the
        *_ml strategies re-solve the buddy-only single-level problem, so
        the period re-anchors at the degraded tier (and back on heal)."""
        if bool(available) != self._deep_available:
            self._deep_available = bool(available)
            self._cached = None

    # ---- decision ----------------------------------------------------------
    def _param_values(self) -> tuple:
        """The estimate tuple whose drift invalidates the cached solve."""
        if self.is_multilevel:
            ck = self.checkpoint_params_ml()
            return (ck.C1, ck.R1, ck.D1, ck.C2, ck.R2, ck.D2, ck.mu)
        ck = self.checkpoint_params()
        return (ck.C, ck.R, ck.D, ck.mu)

    def _solve(self) -> tuple[float, int]:
        cfg, dev = self.config, self.device
        if self.is_multilevel and not self._deep_available:
            # Degraded tier: the deep store is down, every checkpoint is
            # buddy-only — solve the single-level problem at the buddy's
            # (C1, R1, D1, w1) and its I/O power.
            ck = self.checkpoint_params_ml().buddy_only()
            if cfg.strategy == "algo_e_ml":
                mp = self.ml_power
                buddy_power = PowerParams(P_static=mp.P_static,
                                          P_cal=mp.P_cal, P_io=mp.P_io1,
                                          P_down=mp.P_down)
                return optimal.t_opt_energy(ck, buddy_power, dev), 1
            return optimal.t_opt_time(ck, dev), 1
        if cfg.strategy == "algo_t_ml":
            T, m = optimal.t_opt_time_multilevel(self.checkpoint_params_ml(),
                                                 m_max=cfg.m_max, device=dev)
            return T, m
        if cfg.strategy == "algo_e_ml":
            T, m = optimal.t_opt_energy_multilevel(
                self.checkpoint_params_ml(), self.ml_power, m_max=cfg.m_max,
                device=dev)
            return T, m
        return optimal.period_for(cfg.strategy, self.checkpoint_params(),
                                  self.power, dev), 1

    def _decision(self) -> tuple[float, int]:
        """(period T seconds, deep-write cadence m), cached across calls and
        re-solved only when an estimate drifts beyond the threshold."""
        cfg = self.config
        if cfg.strategy == "fixed":
            return cfg.fixed_period_s, 1
        if not math.isfinite(self.mu_estimate_s):   # no failures expected
            return float("inf"), 1
        vals = self._param_values()
        key = (cfg.strategy, self._deep_available)
        if self._cached is not None:
            ovals, okey, operiod, om = self._cached

            def drift(new, old):
                return abs(new - old) > cfg.drift_threshold * max(old, 1e-9)
            if (okey == key and len(vals) == len(ovals)
                    and not any(drift(n, o) for n, o in zip(vals, ovals))):
                return operiod, om
        T, m = self._solve()
        self._cached = (vals, key, T, m)
        return T, m

    def period_seconds(self) -> float:
        return self._decision()[0]

    def deep_every(self) -> int:
        """The model's m: write the deep (PFS) level every m-th checkpoint.
        1 for every single-level strategy."""
        return self._decision()[1]

    def _critical_path_a(self, m: int) -> float:
        """The checkpoint's expected critical-path wall share per period,
        a = (1-omega) * C_mean(m)."""
        if m > 1 or self.is_multilevel:
            return self.checkpoint_params_ml().a(m)
        return self.checkpoint_params().a

    def period_steps(self) -> int:
        """The decision in trainer units: checkpoint every k steps.

        Steps carry the period's *work* share ``T - a`` (see module
        docstring); the ``fixed`` strategy keeps the literal ``T``.
        """
        st = self._step_time.get(1.0)
        T, m = self._decision()
        if not math.isfinite(T):       # infinite MTBF: never checkpoint
            return 10 ** 9
        work = T if self.config.strategy == "fixed" \
            else T - self._critical_path_a(m)
        k = int(round(work / max(st, 1e-9)))
        return max(k, self.config.min_period_steps)

    def operating_point(self, m: Optional[int] = None) -> dict:
        """The decision as actually executed by the trainer: k steps per
        period plus the checkpoint's wall share, at deep cadence ``m``
        (defaults to the policy's own; pass the manager's when its
        ``pfs_every`` was hand-set)."""
        T, m_pol = self._decision()
        m_eff = m_pol if m is None else m
        k = self.period_steps()
        s = self._step_time.get(1.0)
        realized = (float("inf") if not math.isfinite(T)
                    else k * s + self._critical_path_a(m_eff))
        return {"strategy": self.config.strategy,
                "period_solved_s": T, "deep_every": m_eff,
                "period_steps": k, "step_s": s,
                "period_realized_s": realized}

    # ---- reporting ---------------------------------------------------------
    def report(self) -> dict:
        ck, dev = self.checkpoint_params(), self.device
        out = {
            "strategy": self.config.strategy,
            "C_s": ck.C, "R_s": ck.R, "D_s": ck.D, "mu_s": ck.mu,
            "omega": ck.omega,
            "period_s": self.period_seconds(),
            "period_steps": self.period_steps(),
            "deep_every": self.deep_every(),
            "step_time_s": self._step_time.get(float("nan")),
            "n_failures_observed": len(self._failure_gaps),
        }
        if not math.isfinite(ck.mu):
            return out
        if self.is_multilevel:
            mlck = self.checkpoint_params_ml()
            out.update({"C1_s": mlck.C1, "R1_s": mlck.R1, "D1_s": mlck.D1,
                        "q": mlck.q, "omega2": mlck.w2,
                        "deep_available": self._deep_available})
            try:
                tt, mt = optimal.t_opt_time_multilevel(
                    mlck, m_max=self.config.m_max, device=dev)
                te, me = optimal.t_opt_energy_multilevel(
                    mlck, self.ml_power, m_max=self.config.m_max,
                    device=dev)
                out["algo_t_ml_period_s"], out["algo_t_ml_m"] = tt, mt
                out["algo_e_ml_period_s"], out["algo_e_ml_m"] = te, me
                out["predicted_time_ratio"] = float(
                    model.ml_time_final(te, me, mlck, device=dev)
                    / model.ml_time_final(tt, mt, mlck, device=dev))
                out["predicted_energy_ratio"] = float(
                    model.ml_energy_final(tt, mt, mlck, self.ml_power,
                                          device=dev)
                    / model.ml_energy_final(te, me, mlck, self.ml_power,
                                            device=dev))
            except (ValueError, AssertionError):
                pass
            return out
        try:
            tt = optimal.t_opt_time(ck, dev)
            te = optimal.t_opt_energy(ck, self.power, dev)
            out["algo_t_period_s"] = tt
            out["algo_e_period_s"] = te
            out["predicted_time_ratio"] = float(
                model.time_final(te, ck, device=dev)
                / model.time_final(tt, ck, device=dev))
            out["predicted_energy_ratio"] = float(
                model.energy_final(tt, ck, self.power, device=dev)
                / model.energy_final(te, ck, self.power, device=dev))
        except (ValueError, AssertionError):
            pass
        return out
