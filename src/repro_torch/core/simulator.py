"""Discrete-event Monte-Carlo simulator of periodic non-blocking checkpointing.

The scalar oracle: one trajectory at a time, phase by phase, in host
floats.  Execution alternates compute phases (length T - C, work rate 1)
and checkpoint phases (length C, work rate omega, I/O active).  A
checkpoint commits the state as of the beginning of its phase, so the
omega*C work done during it is only protected by the NEXT checkpoint.  A
failure costs downtime D and recovery R and rolls back to the last
committed state.

It shares no algebra with the batched event engine (which jumps from
failure to failure in closed form), which is what makes it an independent
check of that engine.  The failure schedule comes from ``gaps=`` (a
pre-sampled gap array, the engine's format, numpy or tensor), from
``process=`` sampled lazily from the caller's numpy ``rng``, or from a
replaying ``rng`` such as :class:`repro_torch.sim.engine.ScheduledRNG`.
A schedule that runs dry, or an exceeded event budget, raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .failures import FailureProcess, as_process
from .params import CheckpointParams, PowerParams


@dataclasses.dataclass
class SimResult:
    wall_time: float          # == paper's T_final
    energy: float             # == paper's E_final
    n_failures: int
    work_executed: float      # == paper's T_cal
    io_time: float            # == paper's T_io
    down_time: float          # == paper's T_down
    n_checkpoints: int


class _GapSource:
    """Uniform draw interface over the three schedule flavours above."""

    def __init__(self, rng, mu: float, process: Optional[FailureProcess],
                 gaps: Optional[Sequence] = None):
        self.exhausted = False
        if gaps is not None:
            if isinstance(gaps, torch.Tensor):
                gaps = gaps.detach().to("cpu", torch.float64).numpy()
            self._gaps = np.asarray(gaps, dtype=np.float64).ravel()
            self._i = 0
            self._draw = self._from_array
        elif getattr(rng, "replays_schedule", False):
            self._rng = rng
            self._mu = mu
            self._draw = self._from_replaying_rng
        else:
            self._iter = as_process(process).iter_gaps(rng, mean=mu)
            self._draw = self._from_process

    def _from_array(self) -> float:
        if self._i >= self._gaps.size:
            self.exhausted = True
            return math.inf
        g = float(self._gaps[self._i])
        self._i += 1
        return g

    def _from_replaying_rng(self) -> float:
        g = float(self._rng.exponential(self._mu))
        if getattr(self._rng, "exhausted", False):
            self.exhausted = True
        return g

    def _from_process(self) -> float:
        return next(self._iter)

    def __call__(self) -> float:
        return self._draw()


def simulate_once(T: float, ckpt: CheckpointParams, power: PowerParams,
                  T_base: float, rng: Optional[np.random.Generator] = None,
                  process: Optional[FailureProcess] = None,
                  gaps: Optional[Sequence] = None,
                  max_events: Optional[int] = None) -> SimResult:
    """One trajectory of the checkpointed execution, on the host.

    ``gaps`` (a pre-sampled schedule) overrides ``process``/``rng``.
    Raises ``RuntimeError`` when the event budget or a finite schedule runs
    out before ``T_base`` work completes.
    """
    C, R, D, mu, omega = ckpt.C, ckpt.R, ckpt.D, ckpt.mu, ckpt.omega
    if T <= (1.0 - omega) * C:
        raise ValueError("period too short: no work progress per period")

    wall = 0.0
    committed = 0.0        # work protected by the last completed checkpoint
    live = 0.0             # work executed since (not yet all committed)
    work_exec = 0.0        # total CPU work units executed (incl. re-exec)
    io_time = 0.0
    down_time = 0.0
    n_fail = 0
    n_ckpt = 0

    draw_gap = _GapSource(rng, mu, process, gaps)
    next_fail = draw_gap()          # absolute: first renewal starts at t=0

    phase = "compute"
    phase_left = T - C
    ckpt_snapshot = 0.0    # work value being written by the in-flight ckpt

    if max_events is None:
        max_events = int(50 * (T_base / max(T - (1 - omega) * C, 1e-9)
                               + T_base / mu + 100))
    for _ in range(max_events):
        if live >= T_base - 1e-12:
            break
        rate = 1.0 if phase == "compute" else omega
        t_done = ((T_base - live) / rate) if rate > 0 else math.inf
        t_next = min(phase_left, t_done)

        if wall + t_next < next_fail:
            # Phase segment completes without failure.
            wall += t_next
            live += rate * t_next
            work_exec += rate * t_next
            if phase == "checkpoint":
                io_time += t_next
            phase_left -= t_next
            if live >= T_base - 1e-12:
                break
            if phase_left <= 1e-12:
                if phase == "compute":
                    phase = "checkpoint"
                    phase_left = C
                    ckpt_snapshot = live     # state at ckpt start is written
                else:
                    committed = ckpt_snapshot
                    n_ckpt += 1
                    phase = "compute"
                    phase_left = T - C
        else:
            # Failure strikes mid-phase.
            dt = next_fail - wall
            wall = next_fail
            live += rate * dt
            work_exec += rate * dt
            if phase == "checkpoint":
                io_time += dt            # partially-written ckpt I/O is wasted
            n_fail += 1
            # Downtime + recovery; the failure clock renews at recovery end.
            wall += D
            down_time += D
            wall += R
            io_time += R
            live = committed
            phase = "compute"
            phase_left = T - C
            next_fail = wall + draw_gap()
    else:
        raise RuntimeError(
            f"simulator exceeded its event budget ({max_events} events) "
            f"before completing T_base={T_base} work — partial trajectories "
            f"are not returned (check params, or raise max_events)")

    if draw_gap.exhausted:
        raise RuntimeError(
            "failure schedule exhausted before the trajectory completed "
            "(tail would be simulated failure-free); provide a longer gaps "
            "schedule")

    energy = (power.P_static * wall + power.P_cal * work_exec
              + power.P_io * io_time + power.P_down * down_time)
    return SimResult(wall_time=wall, energy=energy, n_failures=n_fail,
                     work_executed=work_exec, io_time=io_time,
                     down_time=down_time, n_checkpoints=n_ckpt)


def simulate(T: float, ckpt: CheckpointParams, power: PowerParams,
             T_base: float, rng: np.random.Generator, n_trials: int = 200,
             process: Optional[FailureProcess] = None) -> dict:
    """Monte-Carlo estimate (mean over trials) with standard errors.

    ``rng`` is the caller's numpy generator (``np.random.default_rng(s)``
    reproduces the reference's ``simulate(seed=s)`` stream).
    """
    walls, energies, fails = [], [], []
    cals, ios, downs = [], [], []
    for _ in range(n_trials):
        r = simulate_once(T, ckpt, power, T_base, rng, process=process)
        walls.append(r.wall_time)
        energies.append(r.energy)
        fails.append(r.n_failures)
        cals.append(r.work_executed)
        ios.append(r.io_time)
        downs.append(r.down_time)

    def mean_se(x):
        x = np.asarray(x, dtype=np.float64)
        return float(x.mean()), float(x.std(ddof=1) / math.sqrt(len(x)))

    out = {}
    for k, v in (("T_final", walls), ("E_final", energies), ("T_cal", cals),
                 ("T_io", ios), ("T_down", downs), ("n_failures", fails)):
        m, se = mean_se(v)
        out[k] = m
        out[k + "_se"] = se
    return out
