"""Phase-based energy accounting (the paper's §2.2 powers, as a runtime).

Host bookkeeping only: it holds no tensors and takes no device.

The trainer tags every wall-clock interval with a :class:`Phase`; the meter
integrates phase durations against a :class:`PowerProfile` and reports both
joules and the paper's normalized parameters (alpha, beta, gamma, rho) so the
analytical optimizer consumes *measured* power numbers.

Overlap semantics follow the paper: during a non-blocking checkpoint both the
CPU (at work-rate omega) and the I/O system draw power, so COMPUTE and
CHECKPOINT_IO intervals may overlap; the static power is paid once on the
wall clock.

Two-level accounting: buddy (level-1) I/O gets its own phases and its own
power (``io_buddy_w``, the multilevel model's P_io1 — NIC + remote RAM,
materially below PFS draw).  ``io_buddy_w=None`` keeps the levels
degenerate (buddy draws PFS power), which preserves the single-level
energy report bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict
from typing import Optional

from ..core.params import MultilevelPowerParams, PowerParams


class Phase(enum.Enum):
    COMPUTE = "compute"            # processors busy executing work
    CHECKPOINT_IO = "checkpoint_io"  # writing a deep (PFS) checkpoint
    CHECKPOINT_IO_BUDDY = "checkpoint_io_buddy"  # buddy-only write (level 1)
    RECOVERY_IO = "recovery_io"    # reading a deep checkpoint after a failure
    RECOVERY_IO_BUDDY = "recovery_io_buddy"      # buddy read (level 1)
    DOWN = "down"                  # downtime (reboot / spare swap-in)
    IDLE = "idle"                  # static power only


@dataclasses.dataclass(frozen=True)
class PowerProfile:
    """Per-node powers in watts (or any consistent unit)."""

    static_w: float
    compute_w: float     # overhead while computing  (P_cal)
    io_w: float          # overhead during deep checkpoint/recovery I/O (P_io)
    down_w: float = 0.0  # overhead while down (P_down)
    name: str = "custom"
    #: overhead during buddy (level-1) I/O; None = same as io_w (P_io1).
    io_buddy_w: Optional[float] = None

    @property
    def io_buddy_w_eff(self) -> float:
        return self.io_w if self.io_buddy_w is None else self.io_buddy_w

    def power_params(self) -> PowerParams:
        return PowerParams(P_static=self.static_w, P_cal=self.compute_w,
                           P_io=self.io_w, P_down=self.down_w)

    def ml_power_params(self) -> MultilevelPowerParams:
        """Per-level powers for the multilevel (T, m) energy solver."""
        return MultilevelPowerParams(P_static=self.static_w,
                                     P_cal=self.compute_w,
                                     P_io1=self.io_buddy_w_eff,
                                     P_io2=self.io_w, P_down=self.down_w)


#: The paper's Exascale scenario, milliwatts/node (rho = 5.5).
PAPER_EXASCALE_PROFILE = PowerProfile(static_w=10.0, compute_w=10.0,
                                      io_w=100.0, down_w=0.0,
                                      name="paper_exascale_rho5.5")

#: Same scenario with the two-level split of EXASCALE_ML_POWER: buddy I/O
#: (NIC + remote RAM) at 20 mW against the PFS's 100 mW.
PAPER_EXASCALE_ML_PROFILE = PowerProfile(static_w=10.0, compute_w=10.0,
                                         io_w=100.0, down_w=0.0,
                                         io_buddy_w=20.0,
                                         name="paper_exascale_ml")

#: The reference's absolute host profile (per TPU v5e host: chips + NICs +
#: SSD), carried over unchanged as an input of its scenarios; it is not a
#: measurement of any GPU host.
TPU_V5E_HOST_PROFILE = PowerProfile(static_w=240.0, compute_w=560.0,
                                    io_w=160.0, down_w=0.0,
                                    name="tpu_v5e_host")


class EnergyMeter:
    """Integrates phase durations -> joules; paper-compatible breakdown."""

    def __init__(self, profile: PowerProfile):
        self.profile = profile
        self.phase_s: dict = defaultdict(float)
        self.wall_s: float = 0.0

    # -- interval API ---------------------------------------------------------
    def add(self, phase: Phase, seconds: float, *,
            advances_wall: bool = True) -> None:
        """Record an interval.  Overlapped intervals (the omega*C compute
        during a checkpoint) are added with ``advances_wall=False`` so static
        power is not double-counted."""
        if seconds < 0:
            raise ValueError("negative interval")
        self.phase_s[phase] += seconds
        if advances_wall:
            self.wall_s += seconds

    # -- reports --------------------------------------------------------------
    def energy_j(self) -> dict:
        p = self.profile
        e = {
            "static": self.wall_s * p.static_w,
            "compute": self.phase_s[Phase.COMPUTE] * p.compute_w,
            "io": (self.phase_s[Phase.CHECKPOINT_IO]
                   + self.phase_s[Phase.RECOVERY_IO]) * p.io_w,
            "io_buddy": (self.phase_s[Phase.CHECKPOINT_IO_BUDDY]
                         + self.phase_s[Phase.RECOVERY_IO_BUDDY])
            * p.io_buddy_w_eff,
            "down": self.phase_s[Phase.DOWN] * p.down_w,
        }
        e["total"] = sum(e.values())
        return e

    def report(self) -> dict:
        out = {f"T_{k.value}_s": v for k, v in self.phase_s.items()}
        out["T_wall_s"] = self.wall_s
        out.update({f"E_{k}_j": v for k, v in self.energy_j().items()})
        pp = self.profile.power_params()
        out.update({"alpha": pp.alpha, "beta": pp.beta, "gamma": pp.gamma,
                    "rho": pp.rho})
        return out
