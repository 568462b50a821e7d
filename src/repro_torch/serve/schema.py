"""Request/response schema of the checkpoint-advisor service.

An :class:`AdviceRequest` describes one running job's platform — its MTBF,
the checkpoint storage tiers it can write to, its power envelope, and a
failure-process hint — plus what it wants optimized ("time" or "energy").
The service answers with an :class:`Advice`: the checkpoint period, the
deep-checkpoint cadence, which store tier(s) to use, and the predicted
makespan/energy at that operating point.

Two shapes of request:

one tier
    Single-level checkpointing (the paper's model): the advisor returns
    the AlgoT/AlgoE period for that tier's (C, R, D, P_io).

two tiers (fast -> deep)
    Buddy + PFS hierarchy (the VELOC shape): every period ends with a
    fast-tier write, every ``m``-th one with a deep write; the advisor
    jointly optimizes (T, m) and recommends whether the hierarchy
    actually beats deep-only on this platform.

Unit contract: all durations (C, R, D, mu, T_base and the returned
period) share one time unit; powers share one power unit — exactly the
``core.params`` convention.

``T_base`` never changes the recommendation: both objectives are
homogeneous of degree 1 in ``T_base`` (every term of T_final and E_final
scales linearly with the amount of work), so the optimal (T, m) is
``T_base``-invariant and the service solves at ``T_base = 1`` and scales
the predicted totals.  This is also why ``T_base`` is excluded from the
cache fingerprint (see ``serve.fingerprint``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from ..core.params import (CheckpointParams, MultilevelCheckpointParams,
                           MultilevelPowerParams, PowerParams)

#: default cap on the deep-checkpoint cadence candidates for two-tier
#: requests (matches ``sim.evaluate_multilevel_grid``'s default range).
DEFAULT_MAX_DEEP_EVERY = 12

_OBJECTIVES = ("time", "energy")


@dataclasses.dataclass(frozen=True)
class StoreTier:
    """One checkpoint storage tier offered to the advisor.

    ``C``/``R``: write/read duration; ``D``: downtime after a failure
    recovered from this tier; ``P_io``: I/O overhead power while
    writing/reading it; ``q``: probability a failure also destroys this
    tier's copy (only meaningful for the FAST tier of a two-tier request
    — e.g. both nodes of a buddy pair dying; the deep tier is assumed
    durable).
    """

    name: str
    C: float
    R: float
    D: float
    P_io: float
    q: float = 0.0

    def __post_init__(self):
        for f in ("C", "R", "D", "P_io"):
            v = getattr(self, f)
            if not (isinstance(v, (int, float)) and math.isfinite(v)
                    and v >= 0.0):
                raise ValueError(f"tier {self.name!r}: {f} must be a finite "
                                 f"number >= 0, got {v!r}")
        if not (0.0 <= self.q <= 1.0):
            raise ValueError(f"tier {self.name!r}: q must be in [0,1], "
                             f"got {self.q!r}")


@dataclasses.dataclass(frozen=True)
class AdviceRequest:
    """One "what period / how many levels / which store" query.

    ``tiers`` is ordered fast -> deep; one tier means single-level
    checkpointing, two means a buddy+PFS hierarchy whose deep cadence
    ``m`` the advisor chooses (up to ``max_deep_every``).

    ``process``/``process_param`` is the failure-process hint
    (``"exponential"``, ``"weibull"`` with shape, ``"lognormal"`` with
    sigma).  The served periods are the exponential closed forms — the
    hint is part of the cache identity and is echoed back with
    ``Advice.closed_form_exact`` so callers know when the answer carries
    the (small, quantified) non-exponential model bias; re-solving under
    a fitted process posterior is the online-adaptation roadmap item.
    """

    mu: float
    tiers: Tuple[StoreTier, ...]
    omega: float = 0.5
    #: deep-flush overlap factor of a two-tier request (VELOC async
    #: flush); None -> the shared ``omega`` applies to both tiers.
    omega2: Optional[float] = None
    P_static: float = 10.0
    P_cal: float = 10.0
    P_down: float = 0.0
    objective: str = "energy"
    T_base: float = 1.0
    process: str = "exponential"
    process_param: float = 1.0
    max_deep_every: int = DEFAULT_MAX_DEEP_EVERY

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if not 1 <= len(self.tiers) <= 2:
            raise ValueError(f"need 1 (single-level) or 2 (buddy+deep) "
                             f"tiers, got {len(self.tiers)}")
        if self.objective not in _OBJECTIVES:
            raise ValueError(f"objective must be one of {_OBJECTIVES}, "
                             f"got {self.objective!r}")
        if not (math.isfinite(self.mu) and self.mu > 0.0):
            raise ValueError(f"mu must be > 0, got {self.mu!r}")
        if not (0.0 <= self.omega <= 1.0):
            raise ValueError(f"omega must be in [0,1], got {self.omega!r}")
        if self.omega2 is not None and not (0.0 <= self.omega2 <= 1.0):
            raise ValueError(f"omega2 must be in [0,1] or None, "
                             f"got {self.omega2!r}")
        if not (math.isfinite(self.T_base) and self.T_base > 0.0):
            raise ValueError(f"T_base must be > 0, got {self.T_base!r}")
        if self.P_static <= 0.0:
            raise ValueError("P_static must be > 0")
        if min(self.P_cal, self.P_down) < 0.0:
            raise ValueError("powers must be >= 0")
        if not 1 <= self.max_deep_every <= DEFAULT_MAX_DEEP_EVERY:
            # The advisor's cadence candidate set is fixed at
            # 1..DEFAULT_MAX_DEEP_EVERY so batch composition never
            # changes what a lane computes (see serve.batcher); caps
            # act through the per-lane m_max mask only.
            raise ValueError(f"max_deep_every must be in "
                             f"[1, {DEFAULT_MAX_DEEP_EVERY}], "
                             f"got {self.max_deep_every}")

    # -- shape ----------------------------------------------------------------
    @property
    def is_multilevel(self) -> bool:
        return len(self.tiers) == 2

    @property
    def fast(self) -> StoreTier:
        return self.tiers[0]

    @property
    def deep(self) -> StoreTier:
        return self.tiers[-1]

    @property
    def w2(self) -> float:
        """Effective deep-flush overlap (``omega2``, defaulting to
        ``omega`` — mirrors ``MultilevelCheckpointParams.w2``)."""
        return self.omega if self.omega2 is None else self.omega2

    # -- conversions to the core parameter objects ---------------------------
    def single_params(self) -> Tuple[CheckpointParams, PowerParams]:
        """The (ckpt, power) pair of a one-tier request."""
        t = self.tiers[0]
        return (CheckpointParams(C=t.C, R=t.R, D=t.D, mu=self.mu,
                                 omega=self.omega),
                PowerParams(P_static=self.P_static, P_cal=self.P_cal,
                            P_io=t.P_io, P_down=self.P_down))

    def multilevel_params(self) -> Tuple[MultilevelCheckpointParams,
                                         MultilevelPowerParams]:
        """The two-level (ckpt, power) pair of a two-tier request."""
        t1, t2 = self.tiers
        return (MultilevelCheckpointParams(
                    C1=t1.C, R1=t1.R, D1=t1.D, C2=t2.C, R2=t2.R, D2=t2.D,
                    mu=self.mu, q=t1.q, omega=self.omega,
                    omega2=self.omega2),
                MultilevelPowerParams(P_static=self.P_static,
                                      P_cal=self.P_cal, P_io1=t1.P_io,
                                      P_io2=t2.P_io, P_down=self.P_down))

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_params(cls, ckpt: CheckpointParams, power: PowerParams,
                    tier_name: str = "pfs", **kwargs) -> "AdviceRequest":
        """Single-level request from the core parameter objects."""
        return cls(mu=ckpt.mu, omega=ckpt.omega,
                   tiers=(StoreTier(name=tier_name, C=ckpt.C, R=ckpt.R,
                                    D=ckpt.D, P_io=power.P_io),),
                   P_static=power.P_static, P_cal=power.P_cal,
                   P_down=power.P_down, **kwargs)

    @classmethod
    def from_multilevel_params(cls, ckpt: MultilevelCheckpointParams,
                               power: MultilevelPowerParams,
                               fast_name: str = "buddy",
                               deep_name: str = "pfs",
                               **kwargs) -> "AdviceRequest":
        """Two-tier request from the core multilevel parameter objects."""
        return cls(mu=ckpt.mu, omega=ckpt.w1,
                   omega2=None if ckpt.w2 == ckpt.w1 else ckpt.w2,
                   tiers=(StoreTier(name=fast_name, C=ckpt.C1, R=ckpt.R1,
                                    D=ckpt.D1, P_io=power.P_io1, q=ckpt.q),
                          StoreTier(name=deep_name, C=ckpt.C2, R=ckpt.R2,
                                    D=ckpt.D2, P_io=power.P_io2)),
                   P_static=power.P_static, P_cal=power.P_cal,
                   P_down=power.P_down, **kwargs)


@dataclasses.dataclass(frozen=True)
class Advice:
    """The served recommendation for one :class:`AdviceRequest`.

    ``period``/``deep_every``/``store`` are the operating point for the
    request's objective; the cross-objective optima (``T_time``,
    ``T_energy`` and their cadences) ride along so a caller can price the
    switch without a second request.  ``predicted_wall`` and
    ``predicted_energy`` are the model expectations AT the served point,
    scaled to the request's ``T_base``.

    ``cert_bound`` is the certified quantization-degradation bound of the
    fingerprint cache (see ``serve.fingerprint``): the served objective
    value is within ``cert_bound`` (relatively) of the request's exact
    optimum, and the service guarantees ``cert_bound <= tol`` (requests
    whose cell cannot be certified are solved exactly; ``exact=True``,
    ``cert_bound=0``).

    ``valid=False`` marks degenerate platforms (no usable period: C of
    the order of the MTBF even for the best tier); the served period then
    follows the sweep convention (T = C, ratios 1) and the predictions
    are NaN.
    """

    objective: str
    period: float
    deep_every: int
    store: str
    predicted_wall: float
    predicted_energy: float
    T_time: float
    T_energy: float
    m_time: int
    m_energy: int
    vs_single: float
    valid: bool
    cache_hit: bool
    cert_bound: float
    exact: bool
    closed_form_exact: bool
    process: str = "exponential"

    @property
    def wall_overhead(self) -> float:
        """Predicted makespan inflation over failure-free execution."""
        return self.predicted_wall  # already in units of T_base-scaled time


def store_recommendation(req: AdviceRequest, deep_every: int) -> str:
    """Human-readable store recommendation string.

    For two-tier requests, ``deep_every == 1`` means every checkpoint is
    deep — the fast tier is never the recovery source and the honest
    recommendation is the deep tier alone.
    """
    if not req.is_multilevel:
        return req.tiers[0].name
    if deep_every == 1:
        return req.deep.name
    return f"{req.fast.name}+{req.deep.name}:deep_every={deep_every}"
