"""Model parameters for the Aupy et al. checkpoint time/energy model.

All durations share one time unit (the paper uses minutes); powers share
one power unit (the paper normalizes to milliwatt/node).  These are plain
host dataclasses: the batched layers lift them into tensors through
:class:`repro_torch.sim.scenarios.ParamGrid`.
"""
from __future__ import annotations

import dataclasses

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


# --- Paper §4 reference scenarios -------------------------------------------

#: Exascale power scenario #1: 20 MW / 1e6 nodes = 20 mW/node, half static.
EXASCALE_POWER_RHO55 = PowerParams(P_static=10.0, P_cal=10.0, P_io=100.0,
                                   P_down=0.0)

#: Exascale power scenario #2: P_static = 5 mW, same overheads (rho = 7).
EXASCALE_POWER_RHO7 = PowerParams(P_static=5.0, P_cal=10.0, P_io=100.0,
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
