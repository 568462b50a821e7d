# reprolint: disable-file=RPL001 (the injector's failure times and hardness must stay the reference's numpy streams bit for bit, default_rng(seed) for the gaps and default_rng((seed, 0x6b75)) for hardness: every comparison of a run against the reference rests on them, and the reference seeds at the same two lines)
"""Failure injection for the fault-tolerant trainer: schedules failures over
wall-clock time with platform MTBF mu = mu_ind / N (paper §2.1), plus
downtime/recovery duration models.

Counterpart of the reference's ``repro/ft/failures.py``: for every process
and seed the failure times and their hardness are the reference's bit for
bit (the same two numpy streams, seeded the same way).

The inter-failure distribution is pluggable (``FailureModel.process``, any
:class:`repro_torch.core.failures.FailureProcess`); the default is the
paper's exponential.

Two-level severity: with probability ``buddy_loss_prob`` (the multilevel
model's ``q``) a failure is *hard* — it takes the in-memory buddy copy
down with it, forcing recovery from the deep (PFS) level.  Hardness draws
come from a *separate* RNG stream so enabling q does not perturb the
failure-time schedule (same gaps with q=0 and q=0.5 at a given seed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.failures import FailureProcess, as_process


@dataclasses.dataclass
class FailureModel:
    mu_s: float                 # platform MTBF (seconds)
    downtime_s: float = 2.0     # D: reboot / spare swap-in
    recovery_extra_s: float = 0.0  # added to the measured restore time (R)
    seed: int = 0
    #: inter-failure distribution; None = exponential.
    process: Optional[FailureProcess] = None
    #: P[failure also loses the buddy copy] — the multilevel model's q.
    buddy_loss_prob: float = 0.0
    #: downtime after a *hard* failure (D2); None = same as downtime_s.
    downtime_hard_s: Optional[float] = None
    #: scaled-time per-level recovery overrides: when set, the trainer
    #: charges this instead of the measured restore time (R1 = buddy,
    #: R2 = deep); None = measure + recovery_extra_s.
    recovery_buddy_s: Optional[float] = None
    recovery_deep_s: Optional[float] = None

    @classmethod
    def from_platform(cls, *, n_nodes: int, mu_ind_s: float, **kw):
        return cls(mu_s=mu_ind_s / n_nodes, **kw)


class FailureInjector:
    """Schedules failure times from the model's process; the trainer polls
    ``check``.

    Scheduling semantics: with the default exponential process the next
    failure is drawn from the *poll* time (`now`) — distributionally exact
    for a memoryless process.  For any other process the renewal clock
    must not drift with polling latency, so the next failure is scheduled
    from the previous failure's actual time instead (an absolute-time
    schedule).
    """

    def __init__(self, model: FailureModel, start_time: float = 0.0):
        self.model = model
        self.rng = np.random.default_rng(model.seed)
        # independent stream: hardness draws must not disturb the gap draws
        self._hard_rng = np.random.default_rng((model.seed, 0x6b75))
        self.enabled = model.mu_s > 0 and np.isfinite(model.mu_s)
        self._exponential = model.process is None
        self._gap_iter = None if self._exponential else \
            as_process(model.process).iter_gaps(self.rng,
                                                mean=model.mu_s)
        self._next = (start_time + self._draw() if self.enabled else np.inf)
        self.n_failures = 0
        self.n_hard = 0
        self.failure_times: list = []
        #: severity of the most recent failure returned by ``check``.
        self.last_was_hard = False

    def _draw(self) -> float:
        if self._exponential:
            return self.rng.exponential(self.model.mu_s)
        return next(self._gap_iter)

    @property
    def next_failure_time(self) -> float:
        return self._next

    def check(self, now: float) -> bool:
        """True exactly once per scheduled failure at/after its time."""
        if not self.enabled or now < self._next:
            return False
        self.n_failures += 1
        self.failure_times.append(self._next)
        q = self.model.buddy_loss_prob
        self.last_was_hard = bool(q > 0.0
                                  and self._hard_rng.random() < q)
        self.n_hard += int(self.last_was_hard)
        origin = now if self._exponential else self._next
        self._next = origin + self._draw()
        return True

    def downtime_for(self, hard: bool) -> float:
        m = self.model
        if hard and m.downtime_hard_s is not None:
            return m.downtime_hard_s
        return m.downtime_s

    def mtbf_estimate(self) -> Optional[float]:
        if len(self.failure_times) < 2:
            return None
        gaps = np.diff(self.failure_times)
        return float(np.mean(gaps))
