"""Checkpoint manager: non-blocking (paper's omega) policy-driven checkpoints.

Pipeline per checkpoint (the VELOC shape):
  1. **snapshot** — device->host copy of the training state, as fresh host
     tensors (this is the only part that stalls the accelerator; with
     double buffering it overlaps the next step's compute, giving omega
     close to 1 for the write phase).  Compressed leaves go back to the
     device inside the store's save; quantizing before this copy would
     move a quarter of the bytes and is left to a later change;
  2. **buddy** — push the shard to an in-memory buddy replica on the critical
     path (paper refs [12,14]: the fast local write that makes any single
     loss recoverable without touching slow storage);
  3. **flush** — a :class:`FlushController`-owned background thread streams
     the snapshot through the sharded store (manifest/checksum/atomic
     commit) with bounded retry/backoff.  The flush is *interruptible*: the
     failure path calls :meth:`CheckpointManager.discard_in_flight`, which
     aborts the write thread mid-chunk, rejects the torn generation, and
     reverts the buddy to its previous buffer — the model's
     failure-during-flush semantics (the in-flight generation is lost,
     restore falls back one level/generation).

Graceful degradation: after ``degrade_after`` CONSECUTIVE deep-flush IO
failures (aborts from failure interrupts do not count) the manager flips
to buddy-only operation, raises an alarm, and tells the policy the deep
tier is gone (``policy.set_deep_available(False)`` — the period re-solves
at the degraded tier).  While degraded, every ``heal_every``-th scheduled
checkpoint probes the deep store; one success heals and re-enables it.

The manager feeds *measurements* back into the CheckpointPolicy: C (write
duration), omega (overlap efficiency), and exposes maybe_checkpoint(step) as
the single integration point for the trainer.

Two-level cadence: every checkpoint pushes to the buddy replica, every
``m``-th also writes the sharded (PFS) store.  ``m`` comes from
``ManagerConfig.pfs_every`` when hand-set, or — the model-driven path —
from ``policy.deep_every()`` when ``pfs_every`` is None, so the joint
``(T, m)`` solvers choose both the period and the deepening cadence.

Scaled-time runs set ``virtual_C1_s`` / ``virtual_C2_s``: the write still
happens for real (restores must work), but the *reported* duration — what
the policy estimates from and what the trainer charges to its virtual
clock — is the configured per-level cost, so the run's checkpoint
parameters are exactly the scenario's.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..core.policy import CheckpointPolicy
from .store import FlushAborted, ShardedStore
from .tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _to_host(x):
    """A private host copy of one leaf (tensors are mutable, so the copy
    never aliases the caller's memory)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    return x


def _to_like(x, like):
    """A fresh copy of host leaf ``x`` on the device of ``like`` (a
    tensor), or on the host."""
    if isinstance(x, torch.Tensor):
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        return x.to(dev, copy=True)
    return x


class BuddyReplica:
    """In-memory replica of a partner's latest shard (simulated pairing).

    Double-buffered: ``push`` keeps the previous generation around so a
    failure-interrupted checkpoint can ``revert`` to it — the buddy-level
    half of the model's in-flight-generation loss.  It holds host tensors.
    """

    def __init__(self):
        self._data: Optional[tuple] = None     # (step, leaves, treedef)
        self._prev: Optional[tuple] = None
        self._lock = threading.Lock()

    def push(self, step: int, tree: Any) -> None:
        """Replace the newest buffer with ``tree``.  Host tensors are kept
        as they are (the caller hands them over); other leaves are copied
        to the host."""
        leaves, treedef = tree_flatten(tree)
        host = [x if isinstance(x, torch.Tensor) and x.device.type == "cpu"
                else _to_host(x) for x in leaves]
        with self._lock:
            self._prev = self._data
            self._data = (step, host, treedef)

    def revert(self, step: int) -> bool:
        """Discard the ``step`` generation (if it is the newest), falling
        back to the previous buffer.  Returns whether anything changed."""
        with self._lock:
            if self._data is not None and self._data[0] == step:
                self._data, self._prev = self._prev, None
                return True
            return False

    def clear(self) -> None:
        """Drop the replica (a *hard* failure: both buddies lost)."""
        with self._lock:
            self._data = None
            self._prev = None

    def restore(self, like_tree: Any):
        with self._lock:
            if self._data is None:
                return None, None
            step, host, treedef = self._data
        likes = tree_leaves(like_tree)
        out = [_to_like(arr, like) for arr, like in zip(host, likes)]
        return tree_unflatten(treedef, out), step


@dataclasses.dataclass
class ManagerConfig:
    async_write: bool = True
    use_buddy: bool = True
    #: deep-storage cadence (the model's ``m``): every checkpoint pushes to
    #: the buddy replica, every ``pfs_every``-th also writes the sharded
    #: (PFS) store.  1 = every checkpoint goes deep (single-level behavior).
    #: None = ask the policy (``policy.deep_every()``, the joint (T, m)
    #: solver's m) before each checkpoint.
    pfs_every: Optional[int] = 1
    #: scaled-time overrides: report these as the per-level checkpoint
    #: durations instead of the measured wall time (None = measure).  When
    #: set, the measured overlap fraction is *not* reported either — the
    #: policy keeps its configured omega prior, as the scenario intends.
    virtual_C1_s: Optional[float] = None
    virtual_C2_s: Optional[float] = None
    #: flush controller: retry a failed deep write this many times with
    #: linear backoff, under an optional wall-clock deadline per flush.
    flush_retries: int = 2
    flush_backoff_s: float = 0.01
    flush_deadline_s: Optional[float] = None
    #: graceful degradation: this many CONSECUTIVE failed deep flushes
    #: (IO failures — failure-interrupt aborts do not count) flip the
    #: manager to buddy-only and re-solve the policy at the degraded
    #: tier.  0 disables degradation.
    degrade_after: int = 3
    #: while degraded, every N-th scheduled checkpoint probes the deep
    #: store; a success heals (0 = never probe, degradation is final).
    heal_every: int = 4


class FlushController:
    """Owns the asynchronous deep-flush thread.

    Replaces the old join-before-snapshot drain: the checkpoint path
    still serializes flushes (``wait`` before a new submit), but the
    FAILURE path can now ``abort()`` an in-flight write — the abort event
    is checked between payload chunks inside ``ShardedStore.save`` and
    interrupts retry backoffs — instead of blocking behind it.

    Each flush is one ``write(abort)`` callable run with bounded
    retry/backoff (linear, ``backoff_s * attempt``) under an optional
    deadline.  Completion is reported through ``on_done(step, outcome,
    payload)`` with outcome ``"ok"`` / ``"failed"`` / ``"aborted"``.
    """

    def __init__(self, store: ShardedStore, retries: int = 2,
                 backoff_s: float = 0.01,
                 deadline_s: Optional[float] = None):
        self.store = store
        self.retries = retries
        self.backoff_s = backoff_s
        self.deadline_s = deadline_s
        self._thread: Optional[threading.Thread] = None
        self._abort = threading.Event()
        self.inflight_step: Optional[int] = None

    @property
    def busy(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def submit(self, step: int, write, on_done) -> None:
        """Start ``write`` in the background (drains any previous flush
        first — one in-flight write at a time)."""
        self.wait()
        self._abort = threading.Event()
        self.inflight_step = step
        self._thread = threading.Thread(
            target=self._run, args=(step, write, self._abort, on_done),
            daemon=True)
        self._thread.start()

    def run_sync(self, step: int, write, on_done) -> None:
        """Blocking flush through the same retry/deadline machinery."""
        self.wait()
        self._abort = threading.Event()
        self.inflight_step = step
        self._run(step, write, self._abort, on_done)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drain the in-flight flush (checkpoint-path barrier; the
        failure path uses :meth:`abort` instead).  True when idle."""
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                return False
        self._thread = None
        return True

    def abort(self) -> bool:
        """Interrupt the in-flight flush (failure path).  Returns whether
        a live write was actually aborted."""
        t = self._thread
        if t is None or not t.is_alive():
            self._thread = None
            return False
        self._abort.set()
        t.join()
        self._thread = None
        return True

    def _run(self, step, write, abort, on_done):
        deadline = (None if self.deadline_s is None
                    else time.monotonic() + self.deadline_s)
        attempt = 0
        try:
            while True:
                try:
                    on_done(step, "ok", write(abort))
                    return
                except FlushAborted as e:
                    on_done(step, "aborted", e)
                    return
                except OSError as e:
                    attempt += 1
                    if (attempt > self.retries
                            or (deadline is not None
                                and time.monotonic() >= deadline)):
                        on_done(step, "failed", e)
                        return
                    try:
                        self.store.fault("retry_backoff", abort)
                    except FlushAborted as e2:
                        on_done(step, "aborted", e2)
                        return
                    except OSError as e2:
                        on_done(step, "failed", e2)
                        return
                    if abort.wait(self.backoff_s * attempt):
                        on_done(step, "aborted", e)
                        return
        finally:
            self.inflight_step = None


class CheckpointManager:
    def __init__(self, store: ShardedStore, policy: CheckpointPolicy,
                 config: Optional[ManagerConfig] = None,
                 on_alarm=None):
        # NOTE: default must be built per instance — a dataclass instance
        # as a parameter default would be SHARED across managers.
        config = ManagerConfig() if config is None else config
        if config.pfs_every is not None and config.pfs_every < 1:
            raise ValueError(f"pfs_every must be >= 1, got {config.pfs_every}")
        if (config.pfs_every or 1) > 1 and not config.use_buddy:
            raise ValueError("pfs_every > 1 needs the buddy level enabled "
                             "(buddy-only checkpoints would protect nothing)")
        self.store = store
        self.policy = policy
        self.cfg = config
        self.buddy = BuddyReplica() if config.use_buddy else None
        self.flush = FlushController(store, retries=config.flush_retries,
                                     backoff_s=config.flush_backoff_s,
                                     deadline_s=config.flush_deadline_s)
        self.on_alarm = on_alarm         # callable(dict) | None
        self.alarms: list = []
        self.degraded = False
        self.flush_errors: list = []
        self.buddy_push_failures = 0
        self._flush_failures = 0         # consecutive, IO-failure only
        self._ckpts_while_degraded = 0
        self._last_ckpt_step: Optional[int] = None
        self._n_ckpts = 0                # schedule position (the model's k)
        self._ckpt_pos: dict = {}        # step -> schedule ordinal
        self._lock = threading.Lock()
        self.stats: list = []

    # -------------------------------------------------------------- schedule
    def deep_every(self) -> int:
        """The effective m: the config's when hand-set, else the policy's
        (clamped to 1 when there is no buddy level to carry the cheap
        checkpoints)."""
        m = self.cfg.pfs_every
        if m is None:
            m = max(1, int(self.policy.deep_every()))
        return m if self.buddy is not None else 1

    # ------------------------------------------------------------------ write
    def _record(self, step: int, level: int, t_snapshot: float,
                t_write: float, n_bytes: int):
        measured = t_snapshot + t_write
        virt = (self.cfg.virtual_C2_s if level >= 2
                else self.cfg.virtual_C1_s)
        C = measured if virt is None else virt
        with self._lock:
            self.stats.append({"step": step, "snapshot_s": t_snapshot,
                               "write_s": t_write, "measured_s": measured,
                               "C_s": C, "level": level,
                               "bytes": n_bytes})
        # omega: only the snapshot stalls compute; the write overlaps.  In
        # scaled time the measured split is meaningless — keep the prior.
        omega = None if virt is not None else (
            t_write / measured if measured > 0 else 0.0)
        self.policy.observe_checkpoint(duration_s=C,
                                       slowdown_work_fraction=omega,
                                       level=level)

    def _alarm(self, kind: str, step: int, **extra):
        alarm = {"kind": kind, "step": step, **extra}
        self.alarms.append(alarm)
        if self.on_alarm is not None:
            self.on_alarm(alarm)

    def _flush_done(self, step: int, outcome: str, payload,
                    t_snapshot: float):
        """Flush-thread completion: record + drive the degrade/heal FSM."""
        if outcome == "ok":
            meta, t_write = payload
            self._record(step, 2, t_snapshot, t_write, meta["bytes"])
            self._flush_failures = 0
            if self.degraded:
                self.degraded = False
                self._ckpts_while_degraded = 0
                self._alarm("pfs_healed", step)
                self.policy.set_deep_available(True)
        elif outcome == "failed":
            self.flush_errors.append({"step": step, "error": repr(payload)})
            self._flush_failures += 1
            if (not self.degraded and self.buddy is not None
                    and self.cfg.degrade_after > 0
                    and self._flush_failures >= self.cfg.degrade_after):
                self.degraded = True
                self._ckpts_while_degraded = 0
                self._alarm("pfs_degraded", step,
                            consecutive_failures=self._flush_failures)
                self.policy.set_deep_available(False)
        # "aborted": a failure interrupt, not a store problem — it neither
        # records a checkpoint nor counts toward degradation.

    def checkpoint(self, step: int, state: Any, *, block: bool = False,
                   deep: Optional[bool] = None) -> int:
        """Snapshot + buddy push now; deep flush in the background.

        ``deep`` forces/suppresses the deep (PFS) write; by default the
        ``deep_every()`` schedule decides: checkpoints 0, m, 2m, ... go
        deep, the rest are buddy-only (the model's every-m-th cadence).
        While degraded, scheduled deep writes downgrade to buddy-only
        except the periodic heal probe.  Returns the level written
        (2 = deep, 1 = buddy-only).
        """
        if deep is None:
            deep = self._n_ckpts % self.deep_every() == 0
            if deep and self.degraded and self.buddy is not None:
                self._ckpts_while_degraded += 1
                deep = (self.cfg.heal_every > 0
                        and self._ckpts_while_degraded
                        % self.cfg.heal_every == 0)
        if not deep and self.buddy is None:
            raise ValueError("deep=False without a buddy level would "
                             "persist nothing (same invariant as the "
                             "pfs_every > 1 config guard)")
        self._ckpt_pos[step] = self._n_ckpts
        self._n_ckpts += 1
        if deep:
            self.flush.wait()            # one in-flight deep write at a time
        self.store.fault("snapshot")
        t0 = time.perf_counter()
        host = tree_map(_to_host, state)                      # device->host
        t_snapshot = time.perf_counter() - t0
        self._last_ckpt_step = step
        t_push = 0.0
        if self.buddy is not None:
            # VELOC local write: on the critical path, before the flush.
            t1 = time.perf_counter()
            try:
                self.store.fault("buddy_push")
                self.buddy.push(step, host)
            except OSError:
                self.buddy_push_failures += 1
            t_push = time.perf_counter() - t1
        if not deep:
            self._record(step, 1, t_snapshot, t_push, 0)
            return 1

        def write(abort):
            tw = time.perf_counter()
            meta = self.store.save(step, host, abort=abort)
            return meta, time.perf_counter() - tw

        def done(s, outcome, payload):
            self._flush_done(s, outcome, payload, t_snapshot)

        if self.cfg.async_write and not block:
            self.flush.submit(step, write, done)
        else:
            self.flush.run_sync(step, write, done)
        return 2

    def due(self, step: int) -> int:
        """0 when the period has not elapsed, else the level the next
        checkpoint WOULD write (2 = deep, 1 = buddy-only) — without
        writing anything.  Lets the trainer price the write (and model a
        failure interrupting it) before committing.  Degradation-aware:
        while buddy-only, scheduled deep writes report as level 1 except
        the upcoming heal probe."""
        period = self.policy.period_steps()
        last = self._last_ckpt_step
        if last is not None and step - last < period:
            return 0
        deep = self._n_ckpts % self.deep_every() == 0
        if deep and self.degraded and self.buddy is not None:
            deep = (self.cfg.heal_every > 0
                    and (self._ckpts_while_degraded + 1)
                    % self.cfg.heal_every == 0)
        return 2 if deep else 1

    def expected_virtual_cost(self, level: int) -> Optional[float]:
        """The scaled-time override for a write at ``level`` (None =
        measured mode)."""
        return (self.cfg.virtual_C2_s if level >= 2
                else self.cfg.virtual_C1_s)

    def expected_cost(self, level: int) -> Optional[float]:
        """The cost a write at ``level`` will report: the virtual override
        in scaled time, else the recent measured mean (None before any)."""
        virt = self.expected_virtual_cost(level)
        return virt if virt is not None else self.measured_C_s

    def maybe_checkpoint(self, step: int, state: Any) -> int:
        """Policy-driven: checkpoint when period_steps have elapsed.

        Returns 0 when skipped, else the level written (2 = deep, 1 =
        buddy-only) — falsy/truthy compatible with the old bool API.
        """
        if not self.due(step):
            return 0
        return self.checkpoint(step, state)

    def wait(self):
        """Drain the in-flight deep flush (checkpoint-path barrier; the
        failure path uses :meth:`discard_in_flight` instead of waiting)."""
        self.flush.wait()

    def discard_in_flight(self, step: int, level: int) -> bool:
        """Failure-interrupt of the in-flight checkpoint of ``step``:
        abort the flush thread if it is still writing, reject the torn
        (or raced-to-commit) generation, and fall the buddy back to its
        previous buffer — the model's flush-window loss, made mechanical.

        The abort does NOT count toward degradation (it is a failure
        interrupt, not a store fault).  Returns whether a live write was
        actually aborted mid-flight.
        """
        aborted = False
        if level >= 2:
            aborted = self.flush.abort()
            # invalidate regardless of the real-time race: the virtual
            # clock says this generation was lost, so a write that
            # happened to commit must be rejected too (determinism of the
            # rollback-identity property does not depend on thread
            # timing).
            self.store.invalidate(step)
        if self.buddy is not None:
            self.buddy.revert(step)
        return aborted

    def drop_buddy(self) -> None:
        """Simulate a hard failure: the buddy copy is lost too, so the next
        restore must fall back to the deep (PFS) level."""
        if self.buddy is not None:
            self.buddy.clear()

    # ---------------------------------------------------------------- restore
    def restore(self, like_tree: Any):
        """Deepest *surviving* level wins by recency: the newest of (valid
        store generation, buddy replica).  With ``pfs_every > 1`` the buddy
        usually holds a fresher state than the last PFS write; ties prefer
        the store (it survives process loss, the buddy does not).

        A store-sourced restore reseeds the buddy replica: after a hard
        failure the replacement pair starts protected again, so later
        buddy-only checkpoints have a level to deepen from.
        """
        self.wait()
        s_tree, s_step = self.store.restore(like_tree)
        b_tree, b_step = (self.buddy.restore(like_tree)
                          if self.buddy is not None else (None, None))
        if b_tree is not None and (s_tree is None or b_step > s_step):
            self._rewind_to(b_step)
            return b_tree, b_step, "buddy"
        if s_tree is not None:
            if self.buddy is not None:
                self.buddy.push(s_step, tree_map(_to_host, s_tree))
            self._rewind_to(s_step)
            return s_tree, s_step, "store"
        return None, None, "none"

    def _rewind_to(self, step: int) -> None:
        """Re-anchor the schedule at a restored checkpoint: checkpoints for
        the redone span must be re-taken (``_last_ckpt_step`` rolls back —
        otherwise a second failure during the redo re-loses everything),
        and the deep-every cadence resumes from the restored checkpoint's
        ordinal so the superperiod structure survives rollbacks."""
        self._last_ckpt_step = step
        pos = self._ckpt_pos.get(step)
        if pos is not None:
            self._n_ckpts = pos + 1

    @property
    def measured_C_s(self) -> Optional[float]:
        with self._lock:
            if not self.stats:
                return None
            return float(np.mean([s["C_s"] for s in self.stats[-5:]]))

    def last_checkpoint(self) -> Optional[dict]:
        """The most recent completed write's stats entry (level, C_s, ...)."""
        self.wait()
        with self._lock:
            return dict(self.stats[-1]) if self.stats else None
