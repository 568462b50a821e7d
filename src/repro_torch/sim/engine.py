"""Batched Monte-Carlo trajectory engine (on the device).

The scalar event loop of ``core.simulator.simulate_once`` rewritten for
every (grid point, trial) lane at once.  ``engine_kind=`` selects the
machine, under the reference's three names (:func:`resolve_engine_kind`):

``"event"`` (default) and ``"pallas"``
    One iteration per FAILURE: between failures the trajectory is closed
    form.  Both run the event kernel (:mod:`repro_torch.kernels
    .event_sweep`, CUDA on the card, its plain PyTorch version on the
    CPU); the reference's two are bit-identical under f64.  They differ in
    precision only (:func:`_engine_policy`): with no ``precision`` given,
    ``"event"`` runs the f64 oracle and ``"pallas"`` the device's default
    policy (compensated f32 on CUDA).
``"step"``
    One iteration per phase segment or failure (:func:`_run_one`), the
    scalar oracle's bit-level twin: plain PyTorch over all lanes, in f64,
    on either device.

Schedules come from one of two places:

* ``gaps=`` — a caller-supplied ``(B, N, F)`` schedule (numpy or tensor),
  shared by the scalar oracle in the parity checks.  Each block reaches
  the kernel in the caller's layout, cast to the compute dtype (the
  kernel reads through the strides; a ``(B, F, N)`` copy, whose reads
  coalesce, measured no faster on the H100 and costs a transpose).
* auto-sampled, from counter-based uniforms: gap ``j`` of grid point
  ``i`` and trial ``t`` is a function of (``seed``, ``i``, ``t``, ``j``,
  the process) alone (:mod:`repro_torch.core.philox`).  On a CUDA device
  the event kernel draws each gap itself when the lane needs it
  (:func:`~repro_torch.kernels.event_sweep.event_sweep_sampled`, one
  launch per block), so no schedule is stored and a block's memory is its
  outputs.  On the CPU, and for the step scan, the schedule is drawn block
  by block (:func:`sampled_schedules`, the plain version of those draws)
  and swept.  Grid points are grouped into
  power-of-two capacity buckets (:func:`fail_capacity_points`): a lane's
  capacity is the length of its schedule, past which it runs failure-free
  and is flagged; the trials and grid axes are cut into blocks under the
  device-memory budget.  Buckets, chunk size and memory budget are
  therefore bit-exact no-ops on a given device, as in the reference (the
  draws do not match JAX's threefry streams; they are held statistically).

:func:`simulate_candidates` runs M candidate periods against one shared
schedule (common random numbers), the hot path of the MC solvers.

Precision follows :func:`_engine_policy`: gaps are drawn in f64 and cast
to the policy's compute dtype before the sweep; outputs are f64.  Results
stay on the device as tensors.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Iterator, Optional

import numpy as np
import torch

from .._device import F64, resolve_device
from ..core.failures import as_process
from ..core.philox import CounterKey
from ..kernels.event_sweep import event_sweep, event_sweep_sampled
from . import dispatch as _dispatch
from . import precision as _precision
from .scenarios import ParamGrid

#: kinds with the event kernel's trajectory semantics and budget algebra.
_EVENT_LIKE = ("event", "pallas")
#: every selectable engine kind.
_ENGINE_KINDS = ("event", "pallas", "step")

#: the step scan's phases.
COMPUTE, CHECKPOINT = 0, 1
#: work-completion slack, the scalar simulator's epsilon.
_EPS = 1e-12

#: per-lane device bytes besides its schedule (outputs and temporaries),
#: in units of 8 bytes — the reference's ``8 * (capacity + 32)`` estimate.
_LANE_OVERHEAD = 32
#: per-lane device bytes of a block whose gaps the kernel draws: its
#: outputs (4 f64, 2 int32, 2 bool).
_OUT_LANE_BYTES = 4 * 8 + 2 * 4 + 2


class ScheduledRNG:
    """np.random.Generator stand-in replaying a fixed gap schedule for
    ``simulate_once(..., rng=ScheduledRNG(gaps))``.  The ``scale`` argument
    of :meth:`exponential` is ignored (the gaps are already in wall-clock
    units); past the end the draw is ``inf`` and :attr:`exhausted` is set."""

    replays_schedule = True

    def __init__(self, gaps):
        if isinstance(gaps, torch.Tensor):
            gaps = gaps.detach().to("cpu", torch.float64).numpy()
        self._gaps = [float(g) for g in np.asarray(gaps).ravel()]
        self._i = 0
        self.exhausted = False

    def exponential(self, scale: float = 1.0) -> float:
        if self._i >= len(self._gaps):
            self.exhausted = True
            return math.inf
        g = self._gaps[self._i]
        self._i += 1
        return g


@dataclasses.dataclass(frozen=True)
class TrajectoryBatch:
    """Per-trajectory outputs, tensors of ``grid.shape + (n_trials,)``."""

    wall_time: torch.Tensor      # paper's T_final
    energy: torch.Tensor         # paper's E_final
    work_executed: torch.Tensor  # paper's T_cal
    io_time: torch.Tensor        # paper's T_io
    down_time: torch.Tensor      # paper's T_down
    n_failures: torch.Tensor
    n_checkpoints: torch.Tensor
    truncated: torch.Tensor      # step budget exhausted before completion
    gaps_exhausted: torch.Tensor  # schedule ran dry (tail failure-free)


def resolve_engine_kind(engine_kind: Optional[str] = None) -> str:
    """An ``engine_kind`` argument: None defers to ``$REPRO_ENGINE_KIND``
    and then to ``"event"``; explicit kinds pass through.  Raises on
    unknown kinds."""
    if engine_kind is None:
        engine_kind = os.environ.get("REPRO_ENGINE_KIND", "").strip() \
            or "event"
    if engine_kind not in _ENGINE_KINDS:
        raise ValueError(f"unknown engine_kind {engine_kind!r}; "
                         f"one of {sorted(_ENGINE_KINDS)}")
    return engine_kind


def _engine_policy(engine_kind: str, dispatch, precision,
                   device) -> _precision.PrecisionPolicy:
    """The :class:`~repro_torch.sim.precision.PrecisionPolicy` an engine
    call runs under.  An explicit ``precision`` wins.  Without one,
    ``"event"`` and ``"step"`` run the f64 oracle (the reference's scan
    kinds ignore the policy), and ``"pallas"`` resolves as every other
    entry point does (``dispatch``, ``$REPRO_PRECISION``, the device's
    default).  The step scan runs f64 only."""
    if engine_kind == "pallas":
        return _dispatch.resolve_precision(dispatch, precision, device)
    pol = _precision.F64 if precision is None else \
        _precision.resolve(precision)
    if engine_kind == "step" and not pol.exact:
        raise ValueError(f"engine_kind='step' runs f64 only, not "
                         f"{pol.name}")
    return pol


def _run_one(T, C, R, D, omega, T_base, gaps: torch.Tensor, *,
             n_steps: int) -> dict:
    """The step scan over a ``(B,) x (B, N, F)`` workload, in f64: one
    iteration per phase segment or failure, the reference's
    ``_run_one`` term for term, as one masked update of every lane (a
    ``torch.where`` per carry field for its ``sel`` and ``keep``).  Lanes
    that are done keep their state; the loop stops once every lane is done,
    which skips only identity steps.  Returns the event kernel's outputs
    (``event_sweep.OUTPUT_KEYS``)."""
    dt, dev = gaps.dtype, gaps.device
    B, N, F = gaps.shape
    k0 = lambda v: torch.tensor(v, dtype=dt, device=dev)
    zero, one, eps, inf = k0(0.0), k0(1.0), k0(_EPS), k0(math.inf)
    col = lambda x: x.reshape(B, 1)
    T, C, R, D, omega, T_base = (col(x) for x in (T, C, R, D, omega, T_base))
    i32 = lambda v: torch.full((B, N), v, dtype=torch.int32, device=dev)
    fz = torch.zeros((B, N), dtype=dt, device=dev)
    wall, committed, live, work, io, down, snapshot = (fz.clone()
                                                       for _ in range(7))
    next_fail = gaps[:, :, 0].clone()
    phase_left = (T - C).expand(B, N).clone()
    phase, n_fail, n_ckpt, fail_idx = i32(COMPUTE), i32(0), i32(0), i32(1)
    done = torch.zeros((B, N), dtype=torch.bool, device=dev)

    for _ in range(int(n_steps)):
        if bool(done.all()):
            break
        in_ckpt = phase == CHECKPOINT
        rate = torch.where(in_ckpt, omega, one)
        t_done = torch.where(rate > zero, (T_base - live) / torch.where(
            rate > zero, rate, one), inf)
        t_next = torch.minimum(phase_left, t_done)
        no_fail = wall + t_next < next_fail

        # branch A: the phase segment completes without failure
        wall_a = wall + t_next
        live_a = live + rate * t_next
        work_a = work + rate * t_next
        io_a = io + torch.where(in_ckpt, t_next, zero)
        left_a = phase_left - t_next
        finished = live_a >= T_base - eps
        boundary = ~finished & (left_a <= eps)
        start_ckpt = boundary & ~in_ckpt
        end_ckpt = boundary & in_ckpt
        phase_a = torch.where(start_ckpt, CHECKPOINT,
                              torch.where(end_ckpt, COMPUTE, phase))
        left_a = torch.where(start_ckpt, C,
                             torch.where(end_ckpt, T - C, left_a))
        snapshot_a = torch.where(start_ckpt, live_a, snapshot)
        committed_a = torch.where(end_ckpt, snapshot, committed)
        n_ckpt_a = n_ckpt + end_ckpt.to(torch.int32)

        # branch B: a failure strikes mid-segment
        dtf = next_fail - wall
        work_b = work + rate * dtf
        io_b = io + torch.where(in_ckpt, dtf, zero) + R
        wall_b = next_fail + D + R
        gi = torch.clamp(fail_idx, max=F - 1).to(torch.int64)
        gap = torch.where(fail_idx < F, torch.gather(
            gaps, 2, gi.unsqueeze(-1)).squeeze(-1), inf)

        sel = lambda a, b: torch.where(no_fail, a, b)
        keep = lambda old, new: torch.where(done, old, new)
        wall, committed, live, work, io, down, next_fail, phase_left, \
            snapshot, phase, n_fail, n_ckpt, fail_idx = (
                keep(o, n) for o, n in (
                    (wall, sel(wall_a, wall_b)),
                    (committed, sel(committed_a, committed)),
                    (live, sel(live_a, committed)),
                    (work, sel(work_a, work_b)),
                    (io, sel(io_a, io_b)),
                    (down, sel(down, down + D)),
                    (next_fail, sel(next_fail, wall_b + gap)),
                    (phase_left, sel(left_a, T - C)),
                    (snapshot, sel(snapshot_a, snapshot)),
                    (phase, sel(phase_a, COMPUTE).to(torch.int32)),
                    (n_fail, sel(n_fail, n_fail + 1)),
                    (n_ckpt, sel(n_ckpt_a, n_ckpt)),
                    (fail_idx, sel(fail_idx, fail_idx + 1))))
        done = done | (no_fail & finished)
    return {"wall_time": wall, "work_executed": work, "io_time": io,
            "down_time": down, "n_failures": n_fail,
            "n_checkpoints": n_ckpt, "truncated": ~done,
            "gaps_exhausted": fail_idx > F}


# ---------------------------------------------------------------------------
# Budget estimation (host arithmetic, as in the reference)
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _expected_failures(T, grid: ParamGrid, T_base) -> np.ndarray:
    """E[#failures] from the closed-form model, clipped to be usable even
    slightly outside the model's validity range."""
    a, b, mu = _host(grid.a), _host(grid.b), _host(grid.mu)
    T = _host(T)
    T_base = _host(T_base)
    denom = (T - a) * (b - T / (2.0 * mu))
    with np.errstate(divide="ignore", invalid="ignore"):
        tf = np.where(denom > 1e-12, T_base * T / denom, np.inf)
    tf = np.where(np.isfinite(tf) & (tf > 0), tf, 50.0 * T_base)
    return tf / mu


def _process_cv_points(process, size: int) -> np.ndarray:
    """Per-raveled-grid-point gap CV; 1.0 where the process declares none."""
    if process is None:
        return np.ones(size, dtype=np.float64)
    cv = np.asarray(as_process(process).ravel().gap_cv(), dtype=np.float64)
    return np.broadcast_to(cv.ravel() if cv.ndim else cv, (size,))


def _pow2(n) -> np.ndarray:
    """Elementwise next power of two (>= 1), as int64."""
    n = np.maximum(np.asarray(n), 1).astype(np.int64)
    flat = np.array([1 << (int(v) - 1).bit_length() for v in n.ravel()],
                    dtype=np.int64)
    return flat.reshape(n.shape)


def _per_point(arr, size: int) -> np.ndarray:
    """Collapse a budget estimate to one value per raveled grid point."""
    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim >= 1 and arr.shape[-1] == size:
        if arr.ndim > 1:
            arr = arr.max(axis=tuple(range(arr.ndim - 1)))
        return arr
    return np.broadcast_to(arr.max() if arr.ndim else arr, (size,))


def fail_capacity_points(T, grid: ParamGrid, T_base,
                         process=None) -> np.ndarray:
    """Per-grid-point schedule capacity (mean + 10 sigma margin, scaled by
    the gap CV), bucketed to powers of two; shape ``(grid.size,)``."""
    cv = np.maximum(1.0, _process_cv_points(process, grid.size))
    nf = _expected_failures(T, grid, T_base) * cv * cv
    cap = np.ceil(nf + 10.0 * cv * np.sqrt(nf + 1.0) + 10.0)
    return _pow2(_per_point(cap, grid.size))


def default_fail_capacity(T, grid: ParamGrid, T_base, process=None) -> int:
    """Grid-wide schedule capacity: the worst point's bucketed budget."""
    return int(np.max(fail_capacity_points(T, grid, T_base, process=process)))


def step_budget_points(T, grid: ParamGrid, T_base,
                       process=None) -> np.ndarray:
    """Per-grid-point step-scan length (expected phase events with a 2x +
    fluctuation margin), bucketed to powers of two; shape ``(grid.size,)``
    (the reference's budget, term for term)."""
    cv = np.maximum(1.0, _process_cv_points(process, grid.size))
    T = _host(T)
    work_per_period = np.maximum(T - _host(grid.a), 1e-9)
    periods = _host(T_base) / work_per_period
    nf = _expected_failures(T, grid, T_base) * cv * cv
    per_fail = 2.0 * np.maximum(T / work_per_period, 1.0) + 4.0
    events = 2.0 * periods + 2.0 + nf * per_fail
    margin = 10.0 * cv * np.sqrt(nf + 1.0) * per_fail
    steps = np.ceil(2.0 * events + margin + 64.0)
    return _pow2(_per_point(steps, grid.size))


def default_step_budget(T, grid: ParamGrid, T_base, process=None) -> int:
    """Grid-wide step-scan length: the worst point's bucketed budget."""
    return int(np.max(step_budget_points(T, grid, T_base, process=process)))


def presample_gaps(grid: ParamGrid, n_trials: int, capacity: int,
                   rng: np.random.Generator, process=None) -> np.ndarray:
    """Host schedule ``(B, n_trials, capacity)`` from the caller's numpy
    generator (``np.random.default_rng(seed)`` reproduces the reference's
    ``presample_gaps(seed=seed)``)."""
    mu = _host(grid.ravel().mu)[:, None, None]
    size = (grid.size, n_trials, capacity)
    if process is None:
        return rng.exponential(scale=mu, size=size)
    return np.asarray(process.ravel().sample(rng, size=size, mean=mu),
                      dtype=np.float64)


def _scan_len(n: int) -> int:
    """Bucket a step budget up to a power of two."""
    return 1 << (max(int(n), 1) - 1).bit_length()


# ---------------------------------------------------------------------------
# Schedules, block by block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleBlock:
    """One block of work: raveled grid points ``points`` (int64 tensor on
    the device) x trials ``trials``, their f64 schedule ``gaps`` of shape
    ``(len(points), len(trials), F)``, and the kernel's step budget."""

    points: torch.Tensor
    trials: range
    gaps: torch.Tensor
    n_steps: int


def _lane_bytes(capacity: int, stored: bool = True) -> int:
    """Device bytes of one lane of a block: its f64 schedule of
    ``capacity`` gaps and the overhead, or, when the kernel draws the gaps
    (``stored=False``), its outputs alone."""
    if not stored:
        return _OUT_LANE_BYTES
    return 8 * (int(capacity) + _LANE_OVERHEAD)


def _blocks(idx: np.ndarray, n_trials: int, per_trial: int, dispatch):
    """(point slice of ``idx``, trial range) blocks under the budget, for
    lanes of ``per_trial`` bytes each."""
    tc = _dispatch.trial_chunk(n_trials, per_trial, dispatch)
    for t0 in range(0, n_trials, tc):
        trials = range(t0, min(t0 + tc, n_trials))
        for start, stop in _dispatch.chunk_plan(
                len(idx), len(trials) * per_trial, dispatch):
            yield idx[start:stop], trials


def _flat_inputs(T, grid: ParamGrid, T_base, device):
    """Flat f64 (B,) tensors of T and T_base on ``device`` plus the flat
    grid; raises on a period with no work progress."""
    flat = grid.ravel().to(device)
    T_arr = torch.broadcast_to(torch.as_tensor(T, dtype=F64, device=device),
                               grid.shape).reshape(-1)
    Tb_arr = torch.broadcast_to(
        torch.as_tensor(T_base, dtype=F64, device=device),
        grid.shape).reshape(-1)
    if bool(torch.any(T_arr <= (1.0 - flat.omega) * flat.C)):
        raise ValueError("period too short: no work progress per period")
    return flat, T_arr, Tb_arr


def _buckets(T_arr, flat: ParamGrid, Tb_arr, process,
             n_steps: Optional[int], engine_kind: str = "event"):
    """(capacity, step budget, raveled point indices) of every pow2
    capacity bucket, split by step budget, in the engine's order."""
    caps = fail_capacity_points(T_arr, flat, Tb_arr, process=process)
    if n_steps is not None:
        budgets = np.full(flat.size, _scan_len(n_steps), dtype=np.int64)
    elif engine_kind in _EVENT_LIKE:
        budgets = caps + 1
    else:
        budgets = step_budget_points(T_arr, flat, Tb_arr, process=process)
    for cap in np.unique(caps):
        in_bucket = caps == cap
        for b in np.unique(budgets[in_bucket]):
            yield int(cap), int(b), np.nonzero(in_bucket & (budgets == b))[0]


def _process_mean(proc, flat: ParamGrid, dev) -> torch.Tensor:
    """The (B,) f64 mean each point's gaps are drawn at."""
    return torch.as_tensor(proc.resolve_mean(_host(flat.mu)), dtype=F64,
                           device=dev).broadcast_to((flat.size,))


def _drawn_blocks(flat: ParamGrid, buckets, n_trials: int, seed: int,
                  process, dispatch, dev) -> Iterator[ScheduleBlock]:
    """The (trial, point) blocks of every ``(capacity, budget, points)``
    bucket, each drawn on ``dev`` from the counter-based streams of its
    lanes."""
    proc = as_process(process).ravel()
    mean = _process_mean(proc, flat, dev)
    for cap, steps, idx in buckets:
        for pts, trials in _blocks(idx, n_trials, _lane_bytes(cap),
                                   dispatch):
            pts_t = torch.as_tensor(pts, dtype=torch.int64, device=dev)
            key = CounterKey(int(seed), pts_t, torch.arange(
                trials.start, trials.stop, dtype=torch.int64, device=dev))
            gaps = proc.subset(pts).sample_gaps(
                key, (len(pts), len(trials), cap), mean=mean[pts_t],
                device=dev)
            yield ScheduleBlock(points=pts_t, trials=trials, gaps=gaps,
                                n_steps=steps)


def sampled_schedules(T, grid: ParamGrid, T_base: float = 1.0,
                      n_trials: int = 200, seed: int = 0, process=None,
                      n_steps: Optional[int] = None, dispatch=None,
                      device="cuda", engine_kind: str = "event"
                      ) -> Iterator[ScheduleBlock]:
    """The auto-sampled schedules of :func:`simulate_trajectories`, drawn
    in PyTorch: one pow2 capacity bucket at a time, each cut into (trial,
    point) blocks under the memory budget, every block drawn on ``device``
    from the counter-based stream of its lanes.  A lane's gaps depend on
    (``seed``, point, trial, gap index, process) only, so another
    ``dispatch`` yields the same gaps in other blocks.  The engine sweeps
    these on the CPU and through the step scan; on a CUDA device its event
    kernel draws the same lanes itself, and these are the plain version of
    those draws.  ``engine_kind`` sets the blocks' step budgets."""
    dev = resolve_device(device)
    flat, T_arr, Tb_arr = _flat_inputs(T, grid, T_base, dev)
    return _drawn_blocks(flat, _buckets(T_arr, flat, Tb_arr, process,
                                        n_steps, engine_kind),
                         n_trials, seed, process, dispatch, dev)


def _explicit_schedules(gaps: torch.Tensor, size: int, n_steps: int,
                        dispatch) -> Iterator[ScheduleBlock]:
    """Blocks of a caller-supplied ``(B, N, F)`` schedule."""
    n_trials, cap = int(gaps.shape[1]), int(gaps.shape[2])
    idx = np.arange(size)
    for pts, trials in _blocks(idx, n_trials, _lane_bytes(cap), dispatch):
        sl = slice(int(pts[0]), int(pts[-1]) + 1)
        yield ScheduleBlock(
            points=torch.as_tensor(pts, dtype=torch.int64,
                                   device=gaps.device),
            trials=trials,
            gaps=gaps[sl, trials.start:trials.stop, :], n_steps=n_steps)


def _normalize_gaps(gaps, size: int, device) -> torch.Tensor:
    """A caller schedule as an f64 ``(size, n_trials, F)`` tensor on
    ``device`` (1-D and 2-D schedules broadcast over points/trials)."""
    g = torch.as_tensor(gaps, dtype=F64, device=device)
    if g.ndim == 1:
        g = g[None, None, :]
    if g.ndim == 2:
        g = g[None, :, :]
    return torch.broadcast_to(g, (size, g.shape[-2], g.shape[-1]))


def _point_params(flat: ParamGrid, T_arr, Tb_arr, p, policy) -> tuple:
    """(T, C, R, D, omega, T_base) of points ``p`` in the compute dtype."""
    cast = policy.cast
    return (cast(T_arr[p]), cast(flat.C[p]), cast(flat.R[p]),
            cast(flat.D[p]), cast(flat.omega[p]), cast(Tb_arr[p]))


def _scatter(acc: dict, out: dict, p, trials: range, size: int,
             n_trials: int) -> None:
    """Write a block's ``(len(p), len(trials))`` outputs into ``acc``."""
    t = slice(trials.start, trials.stop)
    for k, v in out.items():
        if k not in acc:
            acc[k] = torch.empty((size, n_trials), dtype=v.dtype,
                                 device=v.device)
        acc[k][p, t] = v


def _sweep(engine_kind: str, params: tuple, gaps: torch.Tensor, n_steps: int,
           policy) -> dict:
    """One block through the kind's machine: the event kernel, or the step
    scan (f64)."""
    if engine_kind == "step":
        return _run_one(*params, gaps, n_steps=n_steps)
    return event_sweep(*params, gaps, n_steps=n_steps,
                       compensated=policy.compensated)


def _run_blocks(blocks, flat: ParamGrid, T_arr: torch.Tensor,
                Tb_arr: torch.Tensor, n_trials: int, policy,
                engine_kind: str = "event") -> dict:
    """Run the kind's machine over every block of a stored schedule;
    returns flat ``(B, n_trials)`` output tensors on the grid's device."""
    acc: dict = {}
    for blk in blocks:
        p = blk.points
        out = _sweep(engine_kind,
                     _point_params(flat, T_arr, Tb_arr, p, policy),
                     policy.cast(blk.gaps), blk.n_steps, policy)
        _scatter(acc, out, p, blk.trials, flat.size, n_trials)
    return acc


def sampled_launches(flat: ParamGrid, T_arr: torch.Tensor,
                     Tb_arr: torch.Tensor, n_trials: int, seed: int,
                     process, n_steps, dispatch, policy, buckets=None):
    """The ``event_sweep_sampled`` calls of an auto-sampled run, one per
    block of every (capacity, budget) bucket (``buckets``, default the
    engine's, :func:`_buckets`): ``(points, trials, args, kwargs)``, in the
    engine's order."""
    dev = T_arr.device
    proc = as_process(process).ravel()
    spec = proc.gap_spec(_process_mean(proc, flat, dev), flat.size, dev)
    if buckets is None:
        buckets = _buckets(T_arr, flat, Tb_arr, process, n_steps)
    for cap, steps, idx in buckets:
        for pts, trials in _blocks(idx, n_trials,
                                   _lane_bytes(cap, stored=False), dispatch):
            p = torch.as_tensor(pts, dtype=torch.int64, device=dev)
            yield p, trials, _point_params(flat, T_arr, Tb_arr, p, policy), \
                dict(seed=seed, points=p, trial0=trials.start,
                     n_trials=len(trials), spec=spec.take(p), capacity=cap,
                     n_steps=steps, compensated=policy.compensated)


def _run_sampled(flat: ParamGrid, T_arr: torch.Tensor, Tb_arr: torch.Tensor,
                 n_trials: int, seed: int, process, n_steps, dispatch,
                 policy, buckets=None) -> dict:
    """Run the event kernel with in-kernel draws, one launch a block;
    returns flat ``(B, n_trials)`` output tensors."""
    acc: dict = {}
    for p, trials, args, kw in sampled_launches(
            flat, T_arr, Tb_arr, n_trials, seed, process, n_steps, dispatch,
            policy, buckets):
        _scatter(acc, event_sweep_sampled(*args, **kw), p, trials, flat.size,
                 n_trials)
    return acc


def _assemble_batch(out: dict, grid: ParamGrid, n_trials: int,
                    lead: tuple = ()) -> TrajectoryBatch:
    """Reshape flat outputs to ``lead + grid.shape + (n_trials,)`` and
    attach the energy integral (``lead`` is the candidate axis of
    :func:`simulate_candidates`)."""
    shp = lead + grid.shape + (n_trials,)
    dev = out["wall_time"].device
    bc = lambda x: x.to(dev).reshape((1,) * len(lead) + grid.shape + (1,))
    wall = out["wall_time"].reshape(shp)
    work = out["work_executed"].reshape(shp)
    io = out["io_time"].reshape(shp)
    down = out["down_time"].reshape(shp)
    energy = (bc(grid.P_static) * wall + bc(grid.P_cal) * work
              + bc(grid.P_io) * io + bc(grid.P_down) * down)
    return TrajectoryBatch(
        wall_time=wall, energy=energy, work_executed=work, io_time=io,
        down_time=down,
        n_failures=out["n_failures"].reshape(shp),
        n_checkpoints=out["n_checkpoints"].reshape(shp),
        truncated=out["truncated"].reshape(shp),
        gaps_exhausted=out["gaps_exhausted"].reshape(shp))


def _schedule_steps(engine_kind: str, n_steps: Optional[int], F: int, T,
                    flat: ParamGrid, Tb_arr, process) -> int:
    """The step budget of one schedule of ``F`` gaps for every lane:
    ``n_steps`` bucketed, else the event kinds' F + 1 (a schedule of F
    gaps admits at most F failures), else the step scan's budget."""
    if n_steps is not None:
        return _scan_len(n_steps)
    if engine_kind in _EVENT_LIKE:
        return _scan_len(F) + 1
    return default_step_budget(T, flat, Tb_arr, process=process)


def simulate_trajectories(T, grid: ParamGrid, T_base: float = 1.0,
                          n_trials: int = 200, seed: int = 0, gaps=None,
                          n_steps: Optional[int] = None, process=None,
                          engine_kind: Optional[str] = None, dispatch=None,
                          precision=None,
                          device="cuda") -> TrajectoryBatch:
    """Simulate every (grid point x trial) trajectory on ``device``.

    ``T`` broadcasts against ``grid.shape``.  ``gaps`` (grid.size,
    n_trials, F) overrides the auto-sampled schedule — pass the same
    schedule to ``simulate_once(gaps=...)`` for parity checks.  ``process``
    selects the inter-failure distribution of auto-sampled schedules.
    ``n_steps`` caps the machine's iterations (default: for the event kinds
    the schedule capacity + 1, which a complete trajectory never exceeds;
    for ``"step"`` :func:`step_budget_points`).  ``engine_kind`` selects
    the machine (:func:`resolve_engine_kind`; see the module docstring).
    ``dispatch`` bounds the device memory of each block; ``precision``
    selects the event kernel's :class:`~repro_torch.sim.precision
    .PrecisionPolicy` (None: :func:`_engine_policy`).  On a CUDA device an
    auto-sampled run of an event kind draws its gaps inside the kernel.
    """
    kind = resolve_engine_kind(engine_kind)
    dev = resolve_device(device)
    flat, T_arr, Tb_arr = _flat_inputs(T, grid, T_base, dev)
    pol = _engine_policy(kind, dispatch, precision, dev)
    if gaps is not None:
        g = _normalize_gaps(gaps, flat.size, dev)
        n_trials = int(g.shape[1])
        steps = _schedule_steps(kind, n_steps, g.shape[-1], T_arr, flat,
                                Tb_arr, process)
        out = _run_blocks(_explicit_schedules(g, flat.size, steps, dispatch),
                          flat, T_arr, Tb_arr, n_trials, pol, kind)
    elif dev.type == "cuda" and kind in _EVENT_LIKE:
        out = _run_sampled(flat, T_arr, Tb_arr, int(n_trials), seed,
                           process, n_steps, dispatch, pol)
    else:
        blocks = sampled_schedules(T_arr, flat, Tb_arr, n_trials, seed,
                                   process, n_steps, dispatch, dev, kind)
        out = _run_blocks(blocks, flat, T_arr, Tb_arr, int(n_trials), pol,
                          kind)
    return _assemble_batch(out, grid, int(n_trials))


def _cand_axis(M: int, B: int) -> str:
    """The axis a candidate call runs its launches over: the candidate
    axis for a one-point grid (the MC surrogate's shape: one launch whose
    rows are the candidates, the schedule read through a point stride of
    0), else the grid axis (one pass over the grid per candidate)."""
    return "cand" if B == 1 and M > 1 else "grid"


def simulate_candidates(T_cand, grid: ParamGrid, T_base: float = 1.0,
                        n_trials: int = 200, seed: int = 0, gaps=None,
                        n_steps: Optional[int] = None, process=None,
                        engine_kind: Optional[str] = None, dispatch=None,
                        precision=None, device="cuda") -> TrajectoryBatch:
    """Simulate M candidate periods against ONE shared set of failure
    schedules (common random numbers; the MC solvers' hot path).

    ``T_cand`` has shape ``(M,) + grid.shape`` (or ``(M,)``, one period per
    candidate for the whole grid).  Outputs carry a leading ``(M,)`` axis
    over ``grid.shape + (n_trials,)``.  The schedule is never tiled:

    * a caller's schedule on a one-point grid: one pass whose rows are the
      M candidates, the ``(1, N, F)`` schedule expanded to ``(M, N, F)``
      (point stride 0, nothing copied);
    * a caller's schedule on a larger grid: one pass over the grid per
      candidate, as the reference's Pallas route does;
    * auto-sampled (``gaps=None``): the capacity is the worst over all
      candidates and points; on a CUDA device each candidate's pass draws
      its gaps in the kernel from the same ``seed`` (a lane's draws depend
      on (seed, point, trial, gap index) only, so the candidates share
      them); elsewhere the blocks are drawn once and swept per candidate.

    Other arguments as :func:`simulate_trajectories`.
    """
    kind = resolve_engine_kind(engine_kind)
    dev = resolve_device(device)
    flat = grid.ravel().to(dev)
    B = flat.size
    T2 = torch.as_tensor(T_cand, dtype=F64, device=dev)
    M = int(T2.shape[0])
    if T2.ndim == 1:
        T2 = T2.reshape((M,) + (1,) * max(len(grid.shape), 1))
    T2 = torch.broadcast_to(T2, (M,) + grid.shape).reshape(M, B)
    Tb_arr = torch.broadcast_to(torch.as_tensor(
        T_base, dtype=F64, device=dev), grid.shape).reshape(-1)
    if bool(torch.any(T2 <= (1.0 - flat.omega) * flat.C)):
        raise ValueError("period too short: no work progress per period")
    pol = _engine_policy(kind, dispatch, precision, dev)

    if gaps is None:
        n_trials = int(n_trials)
        cap = default_fail_capacity(T2, flat, Tb_arr, process=process)
        buckets = [(cap, _schedule_steps(kind, n_steps, cap, T2, flat,
                                         Tb_arr, process), np.arange(B))]
        if dev.type == "cuda" and kind in _EVENT_LIKE:
            out = _stack([_run_sampled(flat, T2[m], Tb_arr, n_trials, seed,
                                       process, None, dispatch, pol, buckets)
                          for m in range(M)])
        else:
            blocks = list(_drawn_blocks(flat, buckets, n_trials, seed,
                                        process, dispatch, dev))
            out = _stack([_run_blocks(blocks, flat, T2[m], Tb_arr, n_trials,
                                      pol, kind) for m in range(M)])
    else:
        # cast once, so no pass below copies the schedule
        g = pol.cast(_normalize_gaps(gaps, B, dev))
        n_trials = int(g.shape[1])
        steps = _schedule_steps(kind, n_steps, g.shape[-1], T2, flat, Tb_arr,
                                process)
        if _cand_axis(M, B) == "cand":
            rows = flat.take(torch.zeros(M, dtype=torch.int64, device=dev))
            out = _run_blocks(_explicit_schedules(g.expand(M, -1, -1), M,
                                                  steps, dispatch),
                              rows, T2[:, 0], Tb_arr.expand(M), n_trials,
                              pol, kind)
        else:
            out = _stack([_run_blocks(_explicit_schedules(g, B, steps,
                                                          dispatch),
                                      flat, T2[m], Tb_arr, n_trials, pol,
                                      kind) for m in range(M)])
    return _assemble_batch(out, grid, n_trials, lead=(M,))


def _stack(parts: list) -> dict:
    """Per-candidate flat outputs stacked on a leading candidate axis."""
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def simulate_grid(T, grid: ParamGrid, T_base: float = 1.0,
                  n_trials: int = 200, seed: int = 0, gaps=None,
                  n_steps: Optional[int] = None, process=None,
                  engine_kind: Optional[str] = None, dispatch=None,
                  precision=None, device="cuda") -> dict:
    """Batched analogue of ``core.simulator.simulate``: mean/SE tensors of
    ``grid.shape`` ("T_final", "T_final_se", "E_final", ...).  Raises when
    any trajectory was truncated or ran out of schedule."""
    tb = simulate_trajectories(T, grid, T_base, n_trials=n_trials, seed=seed,
                               gaps=gaps, n_steps=n_steps, process=process,
                               engine_kind=engine_kind, dispatch=dispatch,
                               precision=precision,
                               device=device)
    n_trunc = int(tb.truncated.sum())
    if n_trunc:
        raise RuntimeError(
            f"{n_trunc} trajectories exceeded the step budget; pass a "
            f"larger n_steps (check params)")
    n_dry = int(tb.gaps_exhausted.sum())
    if n_dry:
        raise RuntimeError(
            f"{n_dry} trajectories exhausted their failure schedule (tail "
            f"simulated failure-free); pass a gaps array with larger "
            f"capacity")
    out = {}
    n = tb.wall_time.shape[-1]
    for key, arr in (("T_final", tb.wall_time), ("E_final", tb.energy),
                     ("T_cal", tb.work_executed), ("T_io", tb.io_time),
                     ("T_down", tb.down_time),
                     ("n_failures", tb.n_failures.to(F64))):
        out[key] = arr.mean(dim=-1)
        out[key + "_se"] = arr.std(dim=-1, correction=1) / math.sqrt(n)
    return out
