"""Model parameters for the Aupy et al. checkpoint time/energy model.

All durations share one time unit (the paper uses minutes); powers share
one power unit (the paper normalizes to milliwatt/node).  These are plain
host dataclasses: the batched layers lift them into tensors through
:class:`repro_torch.sim.scenarios.ParamGrid`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

MINUTE = 1.0  # canonical paper unit


@dataclasses.dataclass(frozen=True)
class CheckpointParams:
    """Resilience parameters (paper §2.1).

    C   : checkpoint duration.
    R   : recovery (read back) duration.
    D   : downtime (reboot / spare swap-in).
    mu  : platform MTBF (``mu_ind / n`` for ``n`` components).
    omega : slow-down factor in [0,1] — work performed during a checkpoint
          is ``omega*C`` work units (0 blocking, 1 fully overlapped).
    """

    C: float
    R: float
    D: float
    mu: float
    omega: float = 0.0

    def __post_init__(self) -> None:
        if not (0.0 <= self.omega <= 1.0):
            raise ValueError(f"omega must be in [0,1], got {self.omega}")
        for name in ("C", "R", "D"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.mu <= 0:
            raise ValueError("mu must be > 0")

    @property
    def a(self) -> float:
        """a = (1-omega) C : work units lost to checkpoint jitter per period."""
        return (1.0 - self.omega) * self.C

    @property
    def b(self) -> float:
        """b = 1 - (D + R + omega*C)/mu."""
        return 1.0 - (self.D + self.R + self.omega * self.C) / self.mu

    def valid_period_range(self) -> tuple[float, float]:
        """Open interval of T where T_final is positive/finite."""
        lo = max(self.a, self.C)  # a period must at least contain a checkpoint
        hi = 2.0 * self.mu * self.b
        return lo, hi

    @classmethod
    def from_platform(cls, *, n_nodes: int, mu_ind: float, C: float,
                      R: float, D: float,
                      omega: float = 0.0) -> "CheckpointParams":
        """Platform MTBF from per-node MTBF: mu = mu_ind / N (paper §2.1)."""
        return cls(C=C, R=R, D=D, mu=mu_ind / float(n_nodes), omega=omega)


@dataclasses.dataclass(frozen=True)
class PowerParams:
    """Power parameters (paper §2.2), in a common power unit.

    P_static : base power when the platform is on.
    P_cal    : CPU overhead power while computing.
    P_io     : I/O overhead power while checkpointing / recovering.
    P_down   : overhead while a machine is down (paper uses 0).
    """

    P_static: float
    P_cal: float
    P_io: float
    P_down: float = 0.0

    def __post_init__(self) -> None:
        if self.P_static <= 0:
            raise ValueError("P_static must be > 0 (alpha/beta/gamma undefined)")

    @property
    def alpha(self) -> float:
        return self.P_cal / self.P_static

    @property
    def beta(self) -> float:
        return self.P_io / self.P_static

    @property
    def gamma(self) -> float:
        return self.P_down / self.P_static

    @property
    def rho(self) -> float:
        """rho = (1+beta)/(1+alpha), paper Eq. (2)."""
        return (1.0 + self.beta) / (1.0 + self.alpha)

    @classmethod
    def from_ratios(cls, *, alpha: float, beta: float, gamma: float = 0.0,
                    P_static: float = 1.0) -> "PowerParams":
        return cls(P_static=P_static, P_cal=alpha * P_static,
                   P_io=beta * P_static, P_down=gamma * P_static)

    @classmethod
    def from_rho(cls, *, rho: float, alpha: float = 1.0, gamma: float = 0.0,
                 P_static: float = 1.0) -> "PowerParams":
        """Build powers achieving a target rho at fixed alpha (Fig. 1 sweep)."""
        beta = rho * (1.0 + alpha) - 1.0
        if beta < 0:
            raise ValueError(f"rho={rho} with alpha={alpha} needs beta<0")
        return cls.from_ratios(alpha=alpha, beta=beta, gamma=gamma,
                               P_static=P_static)


# --------------------------------------------------------------------------
# Multilevel (buddy + PFS) extension
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultilevelCheckpointParams:
    """Two-level (buddy + PFS) resilience parameters.

    Every period of length T ends with a checkpoint; level 1 ("buddy",
    RAM-to-RAM replication) is cheap, and every ``m``-th checkpoint writes
    the deep level 2 ("PFS") instead, refreshing both recovery levels.  A
    failure also loses the buddy copy with probability ``q``; recovery then
    reads the last PFS checkpoint.

    C1, R1, D1 : level-1 checkpoint / recovery / downtime durations.
    C2, R2, D2 : level-2 (deep) durations; typically C2 >> C1.
    mu         : platform MTBF (all failures, both kinds).
    q          : P[failure also loses the level-1 copy] in [0, 1].
    omega      : shared checkpoint overlap factor.
    omega1     : buddy-write overlap factor; None -> ``omega``.
    omega2     : deep-flush overlap factor; None -> ``omega``.  The deep
                 write is a flush-in-flight interval of wall length C2 at
                 compute rate ``omega2``; a failure inside it loses the
                 uncommitted generation.

    ``m`` is a decision variable, so the per-``m`` quantities are methods.
    With degenerate levels (C1 == C2, R1 == R2, D1 == D2) and ``m = 1``
    every formula reduces bit-for-bit to :class:`CheckpointParams`; with
    ``omega1 == omega2`` to the shared-omega form.
    """

    C1: float
    R1: float
    C2: float
    R2: float
    D1: float
    D2: float
    mu: float
    q: float = 0.1
    omega: float = 0.0
    omega1: Optional[float] = None
    omega2: Optional[float] = None

    def __post_init__(self) -> None:
        if not (0.0 <= self.omega <= 1.0):
            raise ValueError(f"omega must be in [0,1], got {self.omega}")
        for name in ("omega1", "omega2"):
            w = getattr(self, name)
            if w is not None and not (0.0 <= w <= 1.0):
                raise ValueError(f"{name} must be in [0,1], got {w}")
        if not (0.0 <= self.q <= 1.0):
            raise ValueError(f"q must be in [0,1], got {self.q}")
        for name in ("C1", "R1", "C2", "R2", "D1", "D2"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.mu <= 0:
            raise ValueError("mu must be > 0")

    @property
    def w1(self) -> float:
        """Effective buddy-write overlap (omega1, defaulting to omega)."""
        return self.omega if self.omega1 is None else self.omega1

    @property
    def w2(self) -> float:
        """Effective deep-flush overlap (omega2, defaulting to omega)."""
        return self.omega if self.omega2 is None else self.omega2

    @property
    def _shared_omega(self) -> bool:
        """Both levels share one overlap factor: the formulas below then
        take the exact shared-omega expressions."""
        return self.w1 == self.w2

    def C_mean(self, m: int) -> float:
        """Mean checkpoint cost per period: ((m-1) C1 + C2) / m."""
        return ((m - 1) * self.C1 + self.C2) / m

    def C_omega_mean(self, m: int) -> float:
        """Mean overlapped checkpoint cost per period,
        ((m-1) w1 C1 + w2 C2) / m."""
        if self._shared_omega:
            return self.w1 * self.C_mean(m)
        return ((m - 1) * self.w1 * self.C1 + self.w2 * self.C2) / m

    def a(self, m: int) -> float:
        """a_m = ((m-1)(1-w1) C1 + (1-w2) C2) / m, the checkpoint's mean
        critical-path share per period."""
        if self._shared_omega:
            return (1.0 - self.w1) * self.C_mean(m)
        return ((m - 1) * (1.0 - self.w1) * self.C1
                + (1.0 - self.w2) * self.C2) / m

    def flush_window(self, m: int) -> float:
        """Wall length of the deep flush-in-flight interval, ``w2 * C2``."""
        del m  # per-superperiod window; independent of m
        return self.w2 * self.C2

    def expected_fixed_loss(self, m: int) -> float:
        """E[D + R + w*C_lag per failure], mixing soft and hard with q as
        ``soft + q*(hard - soft)`` so degenerate levels reduce exactly."""
        soft = self.D1 + self.R1 + self.C_omega_mean(m)
        hard = self.D2 + self.R2 + self.w2 * self.C2
        return soft + self.q * (hard - soft)

    def S2(self, m: int) -> float:
        """E[C_k^2] over the period types: ((m-1) C1^2 + C2^2) / m."""
        return ((m - 1) * self.C1**2 + self.C2**2) / m

    def S2_omega(self, m: int) -> float:
        """E[w_k C_k^2] over the period types."""
        if self._shared_omega:
            return self.w1 * self.S2(m)
        return ((m - 1) * self.w1 * self.C1**2
                + self.w2 * self.C2**2) / m

    def b(self, m: int) -> float:
        """b_m = 1 - expected_fixed_loss(m) / mu."""
        return 1.0 - self.expected_fixed_loss(m) / self.mu

    def mu_eff(self, m: int) -> float:
        """Effective MTBF of the T/2 re-execution term, mu / (1 + q(m-1)):
        a hard failure loses ~m*T/2 instead of T/2."""
        return self.mu / (1.0 + self.q * (m - 1))

    def valid_period_range(self, m: int) -> tuple[float, float]:
        """Open interval of T where the multilevel T_final is positive."""
        lo = max(self.a(m), self.C1, self.C2)
        hi = 2.0 * self.mu_eff(m) * self.b(m)
        return lo, hi

    def single_level(self) -> CheckpointParams:
        """The PFS-only comparator: every checkpoint deep, no buddy."""
        return CheckpointParams(C=self.C2, R=self.R2, D=self.D2, mu=self.mu,
                                omega=self.w2)

    def buddy_only(self) -> CheckpointParams:
        """The degraded-tier comparator: every checkpoint a buddy write
        (what the policy solves while the deep store is down)."""
        return CheckpointParams(C=self.C1, R=self.R1, D=self.D1, mu=self.mu,
                                omega=self.w1)

    @classmethod
    def from_single(cls, ckpt: CheckpointParams, *,
                    C1: Optional[float] = None, R1: Optional[float] = None,
                    D1: Optional[float] = None,
                    q: float = 0.0) -> "MultilevelCheckpointParams":
        """Lift a single-level parameter set; levels default to degenerate
        (C1 = C2 and so on), the exact-reduction construction."""
        return cls(C1=ckpt.C if C1 is None else C1,
                   R1=ckpt.R if R1 is None else R1,
                   C2=ckpt.C, R2=ckpt.R,
                   D1=ckpt.D if D1 is None else D1, D2=ckpt.D,
                   mu=ckpt.mu, q=q, omega=ckpt.omega)


@dataclasses.dataclass(frozen=True)
class MultilevelPowerParams:
    """Power parameters with per-level I/O overheads: ``P_io1`` while
    writing or reading the buddy level, ``P_io2`` the deep (PFS) level."""

    P_static: float
    P_cal: float
    P_io1: float
    P_io2: float
    P_down: float = 0.0

    def __post_init__(self) -> None:
        if self.P_static <= 0:
            raise ValueError("P_static must be > 0")

    @property
    def alpha(self) -> float:
        return self.P_cal / self.P_static

    @property
    def beta1(self) -> float:
        return self.P_io1 / self.P_static

    @property
    def beta2(self) -> float:
        return self.P_io2 / self.P_static

    @property
    def gamma(self) -> float:
        return self.P_down / self.P_static

    @property
    def rho2(self) -> float:
        """Deep-level rho = (P_static + P_io2) / (P_static + P_cal)."""
        return (self.P_static + self.P_io2) / (self.P_static + self.P_cal)

    def single_level(self) -> PowerParams:
        """PFS-only comparator powers (P_io = P_io2)."""
        return PowerParams(P_static=self.P_static, P_cal=self.P_cal,
                           P_io=self.P_io2, P_down=self.P_down)

    @classmethod
    def from_power(cls, power: PowerParams,
                   P_io1: Optional[float] = None) -> "MultilevelPowerParams":
        """Lift single-level powers; P_io1 defaults to degenerate (= P_io)."""
        return cls(P_static=power.P_static, P_cal=power.P_cal,
                   P_io1=power.P_io if P_io1 is None else P_io1,
                   P_io2=power.P_io, P_down=power.P_down)


# --- Paper §4 reference scenarios -------------------------------------------

#: Exascale power scenario #1: 20 MW / 1e6 nodes = 20 mW/node, half static.
EXASCALE_POWER_RHO55 = PowerParams(P_static=10.0, P_cal=10.0, P_io=100.0,
                                   P_down=0.0)

#: Exascale power scenario #2: P_static = 5 mW, same overheads (rho = 7).
EXASCALE_POWER_RHO7 = PowerParams(P_static=5.0, P_cal=10.0, P_io=100.0,
                                  P_down=0.0)

#: Exascale two-level power scenario: PFS I/O at the paper's 100 mW
#: overhead, buddy (NIC + remote RAM) at 20 mW.
EXASCALE_ML_POWER = MultilevelPowerParams(P_static=10.0, P_cal=10.0,
                                          P_io1=20.0, P_io2=100.0,
                                          P_down=0.0)

#: Jaguar-derived per-processor MTBF (~125 years), in minutes.
MU_IND_JAGUAR_MIN = 125.0 * 365.0 * 24.0 * 60.0


def fig12_checkpoint(mu_min: float) -> CheckpointParams:
    """Figures 1-2 resilience scenario: C = R = 10, D = 1, omega = 1/2."""
    return CheckpointParams(C=10.0, R=10.0, D=1.0, mu=mu_min, omega=0.5)


def fig3_checkpoint(n_nodes: float) -> CheckpointParams:
    """Figure 3 scalability scenario: C = R = 1, D = 0.1, omega = 1/2, MTBF
    120 min at 1e6 nodes scaling as 1/N."""
    mu = 120.0 * (1.0e6 / float(n_nodes))
    return CheckpointParams(C=1.0, R=1.0, D=0.1, mu=mu, omega=0.5)
