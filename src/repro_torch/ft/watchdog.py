"""Straggler watchdog: EWMA step-time tracking with sigma-threshold flags.

At 1000+ nodes, slow hosts (thermal throttling, failing NICs) stretch every
synchronous step.  The watchdog flags step-time excursions; the trainer's
mitigation hook can rebalance microbatches or evict the host (simulated —
the decision logic is what we exercise here).

Counterpart of the reference's ``repro/ft/watchdog.py``: on the same
step-time series it raises the same events."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass
class WatchdogConfig:
    ewma_alpha: float = 0.1
    sigma_threshold: float = 4.0    # flag if step > mean + k*std
    min_samples: int = 8
    consecutive_to_escalate: int = 3


class StepTimeWatchdog:
    def __init__(self, config: Optional[WatchdogConfig] = None,
                 on_straggler: Optional[Callable[[dict], None]] = None):
        # NOTE: built per instance — a dataclass default argument would be
        # one shared WatchdogConfig across watchdogs.
        self.cfg = config if config is not None else WatchdogConfig()
        self.on_straggler = on_straggler
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n: int = 0
        self.consecutive: int = 0
        self.events: list = []

    def observe(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        a = self.cfg.ewma_alpha
        if self.mean is None:
            self.mean, self.var = duration_s, 0.0
            self.n = 1
            return False
        flagged = False
        std = math.sqrt(max(self.var, 1e-18))
        if (self.n >= self.cfg.min_samples
                and duration_s > self.mean + self.cfg.sigma_threshold * std
                and duration_s > 1.5 * self.mean):
            flagged = True
            self.consecutive += 1
            event = {"step": step, "duration_s": duration_s,
                     "mean_s": self.mean, "std_s": std,
                     "escalate": (self.consecutive
                                  >= self.cfg.consecutive_to_escalate)}
            self.events.append(event)
            if self.on_straggler:
                self.on_straggler(event)
        else:
            self.consecutive = 0
            # only non-flagged samples update the baseline (else stragglers
            # poison the statistics)
            delta = duration_s - self.mean
            self.mean += a * delta
            self.var = (1 - a) * (self.var + a * delta * delta)
        self.n += 1
        return flagged
