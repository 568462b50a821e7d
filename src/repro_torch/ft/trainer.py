"""Fault-tolerant trainer: the paper's closed loop.

Counterpart of the reference's ``repro/ft/trainer.py``, with the same
semantics and report keys.  Wires together:
  model train_step  <-  repro_torch.models
  data pipeline     <-  repro_torch.data.synthetic (checkpointable)
  period policy     <-  repro_torch.core.policy (AlgoT / AlgoE / ... /
                        algo_t_ml)
  checkpointing     <-  repro_torch.ckpt (snapshot -> sharded store ->
                        buddy)
  failure injection <-  repro_torch.ft.failures (any FailureProcess @
                        platform MTBF)
  straggler watch   <-  repro_torch.ft.watchdog
  energy accounting <-  repro_torch.energy (phase powers -> joules)
  metrics           <-  repro_torch.ft.tracker (jsonl / stdout / memory)

Time can be real (wall clock) or *scaled*: ``sim_seconds_per_step`` lets a
small model emulate production step times so that MTBF/periods exercise
realistic regimes in seconds of test time.  For validation runs, the
checkpoint/recovery/downtime durations are virtual too (manager
``virtual_C*_s``, failure-model ``recovery_*_s`` / ``downtime_*_s``), so
the whole run lives in one consistent virtual-time world whose parameters
are exactly the analytical scenario's — the failure schedule is then the
only randomness, and measured wall/energy converge to the model's
``time_final`` / ``energy_final`` (``ml_*`` for two-level runs) over seeds.
In measured mode a step is timed on the host clock after
``torch.cuda.synchronize`` when the state is on a card; the loss is read
with one ``float()`` a step and nothing else syncs the host.

Overlap accounting mirrors the model: a non-blocking checkpoint of cost C
advances the wall by its critical-path share ``(1-omega)*C`` while the I/O
device is busy for the full C (the remaining ``omega*C`` is metered
off-wall, overlapped under later compute).  Compute time is the steps
alone — the overlapped work is already inside them.

Failures roll the run back to the last committed checkpoint — data stream
included — so a failure-free run and a failure+resume run produce IDENTICAL
final parameters.  *Hard* failures (probability q) drop the buddy replica
first, forcing a deep (PFS) restore at R2/D2 cost.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ckpt.tree import tree_leaves, tree_map
from ..core.policy import CheckpointPolicy
from ..energy import EnergyMeter, Phase
from .failures import FailureInjector
from .tracker import NullTracker, Tracker
from .watchdog import StepTimeWatchdog


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    sim_seconds_per_step: Optional[float] = None  # None -> measured wall time
    checkpoint_at_start: bool = True
    max_failures: int = 1000


def _host(x):
    """A restored data-state leaf as a host numpy value."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _state_device(state) -> torch.device:
    """The device of the state's first tensor leaf (the host without one)."""
    for x in tree_leaves(state):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


class FaultTolerantTrainer:
    def __init__(self, *, train_step: Callable, state: Any, data,
                 policy: CheckpointPolicy, manager, meter: EnergyMeter,
                 failures: FailureInjector,
                 watchdog: Optional[StepTimeWatchdog] = None,
                 tracker: Optional[Tracker] = None,
                 config: Optional[TrainerConfig] = None):
        self.train_step = train_step
        self.state = state          # (params, opt_state)
        self.data = data
        self.policy = policy
        self.manager = manager
        self.meter = meter
        self.failures = failures
        self.watchdog = watchdog or StepTimeWatchdog()
        if self.watchdog.on_straggler is None:
            self.watchdog.on_straggler = self._on_straggler
        self.tracker = tracker or NullTracker()
        # NOTE: built per instance — a dataclass default argument would be
        # one shared TrainerConfig across trainers.
        self.cfg = config if config is not None else TrainerConfig()
        if getattr(self.manager, "on_alarm", False) is None:
            self.manager.on_alarm = self._on_alarm
        # virtual clock (seconds since run start)
        self.now = 0.0
        self.step = 0
        self.log: list = []
        self.n_rollbacks = 0
        self.n_flush_aborts = 0
        #: in-flight deep/buddy flush of the newest checkpoint: committed
        #: only once the virtual clock passes ``commit_at`` — a failure
        #: inside the window loses the generation (the model's
        #: hazard-during-flush).
        self._pending_flush: Optional[dict] = None

    def _on_straggler(self, event: dict) -> None:
        self.tracker.log({"kind": "straggler", "t": self.now, **event})

    def _on_alarm(self, alarm: dict) -> None:
        self.tracker.log({"kind": "alarm", "t": self.now, **alarm})

    # ---------------------------------------------------------------- helpers
    def _full_state(self) -> dict:
        return {"model": self.state, "data": self.data.state(),
                "step": np.asarray(self.step, np.int64)}

    def _advance(self, seconds: float, phase: Phase) -> None:
        self.now += seconds
        self.meter.add(phase, seconds)

    # ---------------------------------------------------------------- failure
    def _handle_failure(self):
        self.n_rollbacks += 1
        self.policy.observe_failure(self.now)
        # A failure inside the flush window interrupts the in-flight
        # write: abort the flush thread, reject the torn generation, and
        # revert the buddy — restore then falls back to the previous
        # surviving generation/level (the model's flush-window loss).
        pend, self._pending_flush = self._pending_flush, None
        if pend is not None and self.now < pend["commit_at"]:
            self.manager.discard_in_flight(pend["step"], pend["level"])
            self.n_flush_aborts += 1
            self.tracker.log({"kind": "flush_aborted", "t": self.now,
                              "step": pend["step"],
                              "level": pend["level"]})
        hard = self.failures.last_was_hard
        if hard:
            self.manager.drop_buddy()
        # downtime D (D2 for hard failures when configured)
        D = self.failures.downtime_for(hard)
        self._advance(D, Phase.DOWN)
        # recovery R: restore the last *surviving* checkpoint (measured,
        # or the scenario's virtual per-level cost in scaled time)
        t0 = time.perf_counter()
        like = self._full_state()
        restored, ck_step, source = self.manager.restore(like)
        r_measured = time.perf_counter() - t0
        fm = self.failures.model
        # Recovery level follows failure *severity*, not the manager's
        # tie-breaking: a soft failure with a buddy level reads the (always
        # freshest) buddy copy at R1 cost, exactly the model's q-mixing.
        level = 1 if (not hard and self.manager.buddy is not None) else 2
        virt = fm.recovery_buddy_s if level == 1 else fm.recovery_deep_s
        R = (r_measured + fm.recovery_extra_s) if virt is None else virt
        self._advance(R, Phase.RECOVERY_IO_BUDDY if level == 1
                      else Phase.RECOVERY_IO)
        self.policy.observe_recovery(recovery_s=R, downtime_s=D, level=level)
        if restored is None:
            # no checkpoint yet: restart from step 0 state (kept by caller)
            raise RuntimeError(
                "failure before first checkpoint and no initial snapshot")
        self.state = restored["model"]
        self.data.restore(tree_map(_host, restored["data"]))
        self.step = int(restored["step"])
        self.log.append({"event": "rollback", "to_step": self.step,
                         "source": source, "t": self.now})
        self.tracker.log({"kind": "failure", "t": self.now, "hard": hard,
                          "downtime_s": D, "recovery_s": R,
                          "level": level, "source": source,
                          "to_step": self.step})

    # ------------------------------------------------------------------- run
    def run(self) -> dict:
        cfg = self.cfg
        dev = _state_device(self.state)
        if cfg.checkpoint_at_start:
            self.manager.checkpoint(self.step, self._full_state(), block=True)

        losses = []
        while self.step < cfg.total_steps:
            pend = self._pending_flush
            if pend is not None and self.now >= pend["commit_at"]:
                self._pending_flush = None     # flush window closed: committed
            if self.failures.check(self.now):
                self._handle_failure()
                continue

            batch = self.data.peek()
            t0 = time.perf_counter()
            params, opt, metrics = self.train_step(self.state[0],
                                                   self.state[1], batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            step_s = (cfg.sim_seconds_per_step
                      if cfg.sim_seconds_per_step is not None else wall)

            # A failure scheduled inside this step interrupts it: the
            # partial compute is wasted wall time and the step's results
            # never commit (a crashed node checkpoints nothing) — without
            # this, work would "outrun" the failure to the next poll.
            nf = self.failures.next_failure_time
            if nf < self.now + step_s:
                self.meter.add(Phase.COMPUTE, max(nf - self.now, 0.0))
                self.now = nf       # loop-top check fires exactly here
                continue

            self.state = (params, opt)
            next(self.data)          # consume the batch
            self.step += 1
            self._advance(step_s, Phase.COMPUTE)
            self.policy.observe_step_time(step_s)
            self.watchdog.observe(self.step, step_s)
            loss = float(metrics["loss"])
            losses.append(loss)
            self.tracker.log({"kind": "step", "t": self.now,
                              "step": self.step, "step_s": step_s,
                              "loss": loss})

            # policy-driven non-blocking checkpoint (level 2 = deep/PFS,
            # level 1 = buddy-only on the every-m-th cadence)
            level = self.manager.due(self.step)
            if level:
                omega = self.policy.overlap_for(level)
                C_est = self.manager.expected_cost(level) or 0.0
                phase = (Phase.CHECKPOINT_IO if level >= 2
                         else Phase.CHECKPOINT_IO_BUDDY)
                nf = self.failures.next_failure_time
                if nf < self.now + C_est * (1.0 - omega):
                    # failure mid-write: the partial I/O is wasted wall
                    # time and the checkpoint never commits (torn write)
                    self.meter.add(phase, max(nf - self.now, 0.0))
                    self.now = nf
                    self.tracker.log({"kind": "checkpoint_aborted",
                                      "t": self.now, "step": self.step,
                                      "level": level})
                    continue
                level = self.manager.checkpoint(self.step,
                                                self._full_state())
                omega = self.policy.overlap_for(level)
                phase = (Phase.CHECKPOINT_IO if level >= 2
                         else Phase.CHECKPOINT_IO_BUDDY)
                virt = self.manager.expected_virtual_cost(level)
                if virt is not None:
                    # scaled-time world: charge the scenario's cost and
                    # leave the flush IN FLIGHT for omega*C more wall —
                    # a failure inside that window aborts it.
                    C = virt
                else:
                    # measured mode: drain the write and read its cost.
                    last = self.manager.last_checkpoint()
                    C = last["C_s"] if last else C_est
                # non-blocking: only (1-omega)*C hits the wall; the I/O
                # device is busy the full C (rest overlaps later compute)
                self._advance(C * (1.0 - omega), phase)
                self.meter.add(phase, C * omega, advances_wall=False)
                if virt is not None and omega > 0.0:
                    self._pending_flush = {"step": self.step,
                                           "level": level,
                                           "commit_at": self.now + C * omega}
                self.tracker.log({"kind": "checkpoint", "t": self.now,
                                  "step": self.step, "level": level,
                                  "C_s": C})

            if self.failures.n_failures > cfg.max_failures:
                raise RuntimeError("failure budget exceeded")

        self.manager.wait()
        report = {
            "final_step": self.step,
            "losses": losses,
            "n_failures": self.failures.n_failures,
            "n_hard_failures": self.failures.n_hard,
            "n_rollbacks": self.n_rollbacks,
            "wall_s": self.now,
            "energy": self.meter.report(),
            "policy": self.policy.report(),
            "operating_point": self.policy.operating_point(
                self.manager.deep_every()),
            "straggler_events": len(self.watchdog.events),
            "straggler_escalations": sum(1 for e in self.watchdog.events
                                         if e.get("escalate")),
            "flush_aborts": self.n_flush_aborts,
            "flush_errors": len(getattr(self.manager, "flush_errors", ())),
            "pfs_degraded": getattr(self.manager, "degraded", False),
            "alarms": list(getattr(self.manager, "alarms", ())),
            "checkpoints": list(self.manager.stats),
        }
        self.tracker.log({"kind": "summary", "t": self.now,
                          "final_step": self.step,
                          "n_failures": self.failures.n_failures,
                          "n_rollbacks": self.n_rollbacks,
                          "wall_s": self.now,
                          "energy_total_j": report["energy"]["E_total_j"]})
        self.tracker.close()
        return report
