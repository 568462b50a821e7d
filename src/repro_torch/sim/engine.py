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

:func:`simulate_trajectories_ml` runs the two-level (buddy + PFS) engine:
a step scan in plain PyTorch (:func:`_run_one_ml`, the reference's XLA
scan term for term) over a schedule of gaps and hard-failure flags drawn on
the host from the caller's numpy generator.

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
from .scenarios import MultilevelParamGrid, ParamGrid

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


def _device_blocks(idx: np.ndarray, n_trials: int, per_trial: int,
                   dispatch, device: torch.device):
    """(device, point slice of ``idx``, trial range): ``idx`` cut into one
    contiguous piece a device of the sweep mesh (``device`` alone on one),
    each piece into :func:`_blocks` under the budget on its device."""
    for d, lo, hi in _dispatch.pieces(
            len(idx), _dispatch.split_devices(dispatch, device)):
        for pts, trials in _blocks(idx[lo:hi], n_trials, per_trial,
                                   dispatch):
            yield d, pts, trials


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
    bucket, each drawn on its piece's device (``dev`` on one) from the
    counter-based streams of its lanes."""
    proc = as_process(process).ravel()
    mean = _process_mean(proc, flat, dev)
    for cap, steps, idx in buckets:
        for d, pts, trials in _device_blocks(idx, n_trials, _lane_bytes(cap),
                                             dispatch, dev):
            pts_t = torch.as_tensor(pts, dtype=torch.int64, device=d)
            key = CounterKey(int(seed), pts_t, torch.arange(
                trials.start, trials.stop, dtype=torch.int64, device=d))
            gaps = proc.subset(pts).sample_gaps(
                key, (len(pts), len(trials), cap),
                mean=mean[pts_t.to(dev)].to(d), device=d)
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
    """Blocks of a caller-supplied ``(B, N, F)`` schedule, each moved to
    its piece's device (a broadcast schedule moves its one copy)."""
    n_trials, cap = int(gaps.shape[1]), int(gaps.shape[2])
    idx = np.arange(size)
    for d, pts, trials in _device_blocks(idx, n_trials, _lane_bytes(cap),
                                         dispatch, gaps.device):
        sl = slice(int(pts[0]), int(pts[-1]) + 1)
        yield ScheduleBlock(
            points=torch.as_tensor(pts, dtype=torch.int64, device=d),
            trials=trials,
            gaps=_dispatch.to_device(
                gaps[sl, trials.start:trials.stop, :], d), n_steps=n_steps)


def _normalize_gaps(gaps, size: int, device, dtype=F64) -> torch.Tensor:
    """A caller schedule as a ``(size, n_trials, F)`` tensor of ``dtype``
    (f64 gaps; the two-level engine's bool hard flags) on ``device`` (1-D
    and 2-D schedules broadcast over points/trials)."""
    g = torch.as_tensor(gaps, dtype=dtype, device=device)
    if g.ndim == 1:
        g = g[None, None, :]
    if g.ndim == 2:
        g = g[None, :, :]
    return torch.broadcast_to(g, (size, g.shape[-2], g.shape[-1]))


def _point_params(flat: ParamGrid, T_arr, Tb_arr, p, policy) -> tuple:
    """(T, C, R, D, omega, T_base) of points ``p`` in the compute dtype, on
    the device of ``p`` (the grid's tensors are indexed where they live)."""
    cast = policy.cast
    d, q = p.device, p.to(T_arr.device)
    return tuple(cast(x[q]).to(d) for x in (T_arr, flat.C, flat.R, flat.D,
                                            flat.omega, Tb_arr))


def _scatter(acc: dict, out: dict, p, trials: range, size: int,
             n_trials: int, device: torch.device) -> None:
    """Write a block's ``(len(p), len(trials))`` outputs into ``acc`` on
    ``device``, gathering them there."""
    t = slice(trials.start, trials.stop)
    if isinstance(p, torch.Tensor):
        p = p.to(device)
    for k, v in out.items():
        if k not in acc:
            acc[k] = torch.empty((size, n_trials), dtype=v.dtype,
                                 device=device)
        acc[k][p, t] = v.to(device)


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
    """Run the kind's machine over every block of a stored schedule, each
    on its block's device; returns flat ``(B, n_trials)`` output tensors
    gathered on ``T_arr``'s device."""
    acc: dict = {}
    for blk in blocks:
        p = blk.points
        with _dispatch.on_device(p.device):
            out = _sweep(engine_kind,
                         _point_params(flat, T_arr, Tb_arr, p, policy),
                         policy.cast(blk.gaps), blk.n_steps, policy)
        _scatter(acc, out, p, blk.trials, flat.size, n_trials, T_arr.device)
    return acc


def sampled_launches(flat: ParamGrid, T_arr: torch.Tensor,
                     Tb_arr: torch.Tensor, n_trials: int, seed: int,
                     process, n_steps, dispatch, policy, buckets=None):
    """The ``event_sweep_sampled`` calls of an auto-sampled run, one per
    block of every (capacity, budget) bucket (``buckets``, default the
    engine's, :func:`_buckets`) and device piece of the sweep mesh:
    ``(points, trials, args, kwargs)``, in the engine's order, every
    tensor on the piece's device.  The points are global indices, so a
    lane's draws do not depend on the split."""
    dev = T_arr.device
    proc = as_process(process).ravel()
    spec = proc.gap_spec(_process_mean(proc, flat, dev), flat.size, dev)
    if buckets is None:
        buckets = _buckets(T_arr, flat, Tb_arr, process, n_steps)
    for cap, steps, idx in buckets:
        for d, pts, trials in _device_blocks(
                idx, n_trials, _lane_bytes(cap, stored=False), dispatch,
                dev):
            p = torch.as_tensor(pts, dtype=torch.int64, device=d)
            yield p, trials, _point_params(flat, T_arr, Tb_arr, p, policy), \
                dict(seed=seed, points=p, trial0=trials.start,
                     n_trials=len(trials),
                     spec=spec.take(p.to(dev)).to(d), capacity=cap,
                     n_steps=steps, compensated=policy.compensated)


def _run_sampled(flat: ParamGrid, T_arr: torch.Tensor, Tb_arr: torch.Tensor,
                 n_trials: int, seed: int, process, n_steps, dispatch,
                 policy, buckets=None) -> dict:
    """Run the event kernel with in-kernel draws, one launch a block and
    device piece, each under its device; returns flat ``(B, n_trials)``
    output tensors gathered on ``T_arr``'s device."""
    acc: dict = {}
    for p, trials, args, kw in sampled_launches(
            flat, T_arr, Tb_arr, n_trials, seed, process, n_steps, dispatch,
            policy, buckets):
        with _dispatch.on_device(p.device):
            out = event_sweep_sampled(*args, **kw)
        _scatter(acc, out, p, trials, flat.size, n_trials, T_arr.device)
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


# ---------------------------------------------------------------------------
# Multilevel (buddy + PFS) trajectories
# ---------------------------------------------------------------------------
#
# The superperiod: periods 0..m-2 end with a buddy checkpoint (cost C1,
# commits level 1), period m-1 with a deep checkpoint (cost C2, commits both
# levels).  Each failure of the schedule carries a "hard" flag (the buddy
# copy lost, probability q): a soft failure rolls back to the last level-1
# commit and resumes the period schedule where that commit left it; a hard
# one rolls back to the last deep commit and restarts the superperiod at
# period 0.  With m = 1 and degenerate levels every expression below is the
# single-level step scan's, so the scalar oracle is reproduced bit for bit.

#: device bytes per lane of the two-level scan besides its schedule: the
#: 20 carry fields and one step's temporaries, with headroom; sizes the
#: trial blocks of :func:`simulate_trajectories_ml`.
_ML_LANE_BYTES = 1024
#: the two-level scan checks whether every lane is done once per this many
#: steps (a host sync); a done lane's steps are identities, so the cadence
#: never changes a bit.
_ML_DONE_EVERY = 32


@dataclasses.dataclass(frozen=True)
class MultilevelTrajectoryBatch:
    """Per-trajectory outputs, tensors of ``grid.shape + (n_trials,)``;
    ``steps`` is the number of scan steps run (the most over the trial
    blocks), out of the budget ``n_steps``."""

    wall_time: torch.Tensor
    energy: torch.Tensor
    work_executed: torch.Tensor
    io1_time: torch.Tensor       # buddy-level I/O (writes + soft recoveries)
    io2_time: torch.Tensor       # deep-level I/O (writes + hard recoveries)
    down_time: torch.Tensor
    n_failures: torch.Tensor
    n_hard_failures: torch.Tensor
    n_ckpt1: torch.Tensor        # committed buddy checkpoints
    n_ckpt2: torch.Tensor        # committed deep checkpoints
    truncated: torch.Tensor
    gaps_exhausted: torch.Tensor
    steps: int = 0
    n_steps: int = 0


def _run_one_ml(T, m, C1, C2, R1, R2, D1, D2, omega1, omega2, T_base,
                gaps: torch.Tensor, hard: torch.Tensor, *,
                n_steps: int) -> tuple:
    """The two-level step scan over a ``(B,) x (B, N, F)`` workload, in
    f64: the reference's ``_run_one_ml`` term for term (the same ``sel``
    and ``keep`` selects, in the same order, ``hard[min(n_fail, F - 1)]``)
    as one masked update of every lane a step, modelled on
    :func:`_run_one`.  ``m`` is an int32 (B,) tensor, ``hard`` bool.

    The loop stops once every lane is done.  A done lane is kept by
    ``keep``, so the stop skips identity steps only; it is checked every
    ``_ML_DONE_EVERY`` steps (a host sync each), which changes no bit.
    Returns ``(outputs, steps run)``."""
    dt, dev = gaps.dtype, gaps.device
    B, N, F = gaps.shape
    k0 = lambda v: torch.tensor(v, dtype=dt, device=dev)
    zero, one, eps, inf = k0(0.0), k0(1.0), k0(_EPS), k0(math.inf)
    col = lambda x: x.reshape(B, 1)
    T, C1, C2, R1, R2, D1, D2, omega1, omega2, T_base = (
        col(x) for x in (T, C1, C2, R1, R2, D1, D2, omega1, omega2, T_base))
    m = col(m).to(torch.int32)
    i32 = lambda v: torch.full((B, N), v, dtype=torch.int32, device=dev)
    fz = torch.zeros((B, N), dtype=dt, device=dev)
    (wall, committed1, committed2, live, work, io1, io2, down,
     snapshot) = (fz.clone() for _ in range(9))
    next_fail = gaps[:, :, 0].clone()
    phase_left = (T - torch.where(m > 1, C1, C2)).expand(B, N).clone()
    phase, k, resume_k, n_fail, n_hard, n_ckpt1, n_ckpt2 = (
        i32(0) for _ in range(7))
    fail_idx = i32(1)
    done = torch.zeros((B, N), dtype=torch.bool, device=dev)

    steps = 0
    for steps in range(int(n_steps)):
        if steps % _ML_DONE_EVERY == 0 and bool(done.all()):
            break
        is_deep = k == m - 1
        Ck = torch.where(is_deep, C2, C1)
        in_ckpt = phase == CHECKPOINT
        omega_k = torch.where(is_deep, omega2, omega1)
        rate = torch.where(in_ckpt, omega_k, one)
        t_done = torch.where(rate > zero, (T_base - live) / torch.where(
            rate > zero, rate, one), inf)
        t_next = torch.minimum(phase_left, t_done)
        no_fail = wall + t_next < next_fail
        ck1 = in_ckpt & ~is_deep
        ck2 = in_ckpt & is_deep

        # branch A: the phase segment completes without failure
        wall_a = wall + t_next
        live_a = live + rate * t_next
        work_a = work + rate * t_next
        io1_a = io1 + torch.where(ck1, t_next, zero)
        io2_a = io2 + torch.where(ck2, t_next, zero)
        left_a = phase_left - t_next
        finished = live_a >= T_base - eps
        boundary = ~finished & (left_a <= eps)
        start_ckpt = boundary & ~in_ckpt
        end_ckpt = boundary & in_ckpt
        phase_a = torch.where(start_ckpt, CHECKPOINT,
                              torch.where(end_ckpt, COMPUTE, phase))
        k_next = torch.where(k + 1 >= m, 0, k + 1)
        C_next = torch.where(k_next == m - 1, C2, C1)
        left_a = torch.where(start_ckpt, Ck,
                             torch.where(end_ckpt, T - C_next, left_a))
        snapshot_a = torch.where(start_ckpt, live_a, snapshot)
        committed1_a = torch.where(end_ckpt, snapshot, committed1)
        committed2_a = torch.where(end_ckpt & is_deep, snapshot, committed2)
        k_a = torch.where(end_ckpt, k_next, k)
        resume_k_a = torch.where(end_ckpt, k_next, resume_k)
        n_ckpt1_a = n_ckpt1 + (end_ckpt & ~is_deep).to(torch.int32)
        n_ckpt2_a = n_ckpt2 + (end_ckpt & is_deep).to(torch.int32)

        # branch B: a failure strikes mid-segment
        hi = torch.clamp(n_fail, max=F - 1).to(torch.int64).unsqueeze(-1)
        hard_f = torch.gather(hard, 2, hi).squeeze(-1)
        dtf = next_fail - wall
        work_b = work + rate * dtf
        io1_b = io1 + torch.where(ck1, dtf, zero) \
            + torch.where(hard_f, zero, R1)
        io2_b = io2 + torch.where(ck2, dtf, zero) \
            + torch.where(hard_f, R2, zero)
        D_sel = torch.where(hard_f, D2, D1)
        R_sel = torch.where(hard_f, R2, R1)
        wall_b = next_fail + D_sel + R_sel
        down_b = down + D_sel
        gi = torch.clamp(fail_idx, max=F - 1).to(torch.int64).unsqueeze(-1)
        gap = torch.where(fail_idx < F, torch.gather(gaps, 2, gi).squeeze(-1),
                          inf)
        next_fail_b = wall_b + gap
        committed1_b = torch.where(hard_f, committed2, committed1)
        k_b = torch.where(hard_f, 0, resume_k)
        left_b = T - torch.where(k_b == m - 1, C2, C1)

        sel = lambda a, b: torch.where(no_fail, a, b)
        keep = lambda old, new: torch.where(done, old, new)
        (wall, committed1, committed2, live, work, io1, io2, down, next_fail,
         phase_left, snapshot, phase, k, resume_k, n_fail, n_hard, n_ckpt1,
         n_ckpt2, fail_idx) = (keep(o, n) for o, n in (
             (wall, sel(wall_a, wall_b)),
             (committed1, sel(committed1_a, committed1_b)),
             (committed2, sel(committed2_a, committed2)),
             (live, sel(live_a, committed1_b)),   # back to the surviving level
             (work, sel(work_a, work_b)),
             (io1, sel(io1_a, io1_b)),
             (io2, sel(io2_a, io2_b)),
             (down, sel(down, down_b)),
             (next_fail, sel(next_fail, next_fail_b)),
             (phase_left, sel(left_a, left_b)),
             (snapshot, sel(snapshot_a, snapshot)),
             (phase, sel(phase_a, COMPUTE).to(torch.int32)),
             (k, sel(k_a, k_b).to(torch.int32)),
             (resume_k, sel(resume_k_a, k_b).to(torch.int32)),
             (n_fail, sel(n_fail, n_fail + 1)),
             (n_hard, sel(n_hard, n_hard + hard_f.to(torch.int32))),
             (n_ckpt1, sel(n_ckpt1_a, n_ckpt1)),
             (n_ckpt2, sel(n_ckpt2_a, n_ckpt2)),
             (fail_idx, sel(fail_idx, fail_idx + 1))))
        done = done | (no_fail & finished)
    else:
        steps = int(n_steps)
    return {"wall_time": wall, "work_executed": work, "io1_time": io1,
            "io2_time": io2, "down_time": down, "n_failures": n_fail,
            "n_hard_failures": n_hard, "n_ckpt1": n_ckpt1,
            "n_ckpt2": n_ckpt2, "truncated": ~done,
            "gaps_exhausted": fail_idx > F}, steps


def _ml_host_terms(m, grid: MultilevelParamGrid) -> tuple:
    """Host f64 arrays ``(a_m, b_m, mu_m, mu)`` of the flat ``grid`` at
    cadences ``m`` (int32, as the reference's budget arithmetic)."""
    g = grid.to("cpu")
    mt = torch.as_tensor(np.array(_host(m), dtype=np.int32))
    return tuple(x.numpy() for x in (g.a(mt), g.b(mt), g.mu_eff(mt), g.mu))


def _expected_failures_ml(T, m, grid: MultilevelParamGrid,
                          T_base) -> np.ndarray:
    """E[#failures] from the two-level closed form, clipped like the
    single-level estimator (host numpy)."""
    a, b, mu_m, mu = _ml_host_terms(m, grid)
    T, T_base = _host(T), _host(T_base)
    denom = (T - a) * (b - T / (2.0 * mu_m))
    with np.errstate(divide="ignore", invalid="ignore"):
        tf = np.where(denom > 1e-12, T_base * T / denom, np.inf)
    tf = np.where(np.isfinite(tf) & (tf > 0), tf, 50.0 * T_base)
    return tf / mu


def default_fail_capacity_ml(T, m, grid: MultilevelParamGrid, T_base) -> int:
    """Failures sampled per trajectory: mean + 10 sigma margin."""
    nf = _expected_failures_ml(T, m, grid, T_base)
    return int(np.max(np.ceil(nf + 10.0 * np.sqrt(nf + 1.0) + 10.0)))


def default_step_budget_ml(T, m, grid: MultilevelParamGrid, T_base) -> int:
    """Scan length: a hard failure re-executes up to a whole superperiod
    (m periods, 2 events each), so the margin per failure scales with m."""
    a = _ml_host_terms(m, grid)[0]
    T, m = _host(T), np.array(_host(m), dtype=np.int32)
    work_per_period = np.maximum(T - a, 1e-9)
    periods = _host(T_base) / work_per_period
    nf = _expected_failures_ml(T, m, grid, T_base)
    per_fail = 2.0 * np.maximum(m * T / work_per_period, 1.0) + 4.0
    events = 2.0 * periods + 2.0 + nf * per_fail
    margin = 10.0 * np.sqrt(nf + 1.0) * per_fail
    return int(np.max(np.ceil(2.0 * events + margin + 64.0)))


def presample_failures(grid: MultilevelParamGrid, n_trials: int,
                       capacity: int, rng: np.random.Generator) -> tuple:
    """Host ``(gaps, hard)``: exponential(mu) inter-failure gaps and
    Bernoulli(q) level-loss flags, each ``(grid.size, n_trials,
    capacity)``, drawn from the caller's generator in the reference's order
    (``np.random.default_rng(s)`` gives its ``seed=s`` schedule bit for
    bit)."""
    flat = grid.ravel()
    size = (grid.size, n_trials, capacity)
    gaps = rng.exponential(scale=_host(flat.mu)[:, None, None], size=size)
    hard = rng.random(size=size) < _host(flat.q)[:, None, None]
    return gaps, hard


def _ml_energy(out: dict, grid: MultilevelParamGrid, n_trials: int
               ) -> torch.Tensor:
    """The energy integral of every trajectory, ``grid.shape +
    (n_trials,)``: the per-level I/O times at their own powers."""
    shp = grid.shape + (n_trials,)
    dev = out["wall_time"].device
    bc = lambda x: x.to(dev).reshape(grid.shape + (1,))
    r = lambda k: out[k].reshape(shp)
    return (bc(grid.P_static) * r("wall_time")
            + bc(grid.P_cal) * r("work_executed")
            + bc(grid.P_io1) * r("io1_time") + bc(grid.P_io2) * r("io2_time")
            + bc(grid.P_down) * r("down_time"))


def simulate_trajectories_ml(T, m, grid: MultilevelParamGrid,
                             T_base: float = 1.0, n_trials: int = 200,
                             rng: Optional[np.random.Generator] = None,
                             gaps=None, hard=None,
                             n_steps: Optional[int] = None, dispatch=None,
                             device="cuda") -> MultilevelTrajectoryBatch:
    """Simulate every two-level (grid point x trial) trajectory on
    ``device``, through the step scan :func:`_run_one_ml` in f64.

    ``T`` and ``m`` broadcast against ``grid.shape``.  ``gaps`` and ``hard``
    (numpy or tensors, ``(grid.size, n_trials, F)``, or 1-D/2-D broadcast)
    override the schedule; otherwise it is drawn on the host from the
    caller's ``rng`` by :func:`presample_failures`.  The schedule goes to
    the device once; the trials are cut into one piece a device of the
    sweep mesh (``dispatch``; one piece on the CPU), each piece into blocks
    under the memory budget on its device, and the outputs are gathered on
    ``device`` (lanes are independent, so neither changes a bit).  ``n_steps`` caps the scan (default
    :func:`default_step_budget_ml`), rounded up to a power of two.
    """
    dev = resolve_device(device)
    flat = grid.ravel().to(dev)
    B = flat.size
    bshape = lambda x, dt: np.broadcast_to(np.asarray(_host(x), dtype=dt),
                                           grid.shape).ravel()
    T_arr = bshape(T, np.float64)
    m_arr = bshape(m, np.int32)
    Tb_arr = bshape(T_base, np.float64)
    if np.any(m_arr < 1):
        raise ValueError("deep-checkpoint cadence m must be >= 1")
    if np.any(T_arr < np.maximum(_host(flat.C1), _host(flat.C2))):
        raise ValueError("period too short: T must cover the checkpoint")
    if np.any(T_arr <= _ml_host_terms(m_arr, flat)[0]):
        raise ValueError("period too short: no work progress per period")

    if gaps is None or hard is None:
        if rng is None:
            raise ValueError("simulate_trajectories_ml needs rng= (a numpy "
                             "Generator) or both gaps= and hard=")
        cap = default_fail_capacity_ml(T_arr, m_arr, flat, Tb_arr)
        g, h = presample_failures(flat, int(n_trials), cap, rng)
        gaps = g if gaps is None else gaps
        hard = h if hard is None else hard
    gaps = _normalize_gaps(gaps, B, dev)
    hard = _normalize_gaps(hard, B, dev, torch.bool)
    if gaps.shape != hard.shape:
        raise ValueError(f"gaps {tuple(gaps.shape)} and hard flags "
                         f"{tuple(hard.shape)} schedules disagree")
    n_trials = int(gaps.shape[1])
    if n_steps is None:
        n_steps = default_step_budget_ml(T_arr, m_arr, flat, Tb_arr)
    n_steps = _scan_len(n_steps)

    t = lambda x: torch.tensor(x, device=dev)
    params = (t(T_arr), t(m_arr), flat.C1, flat.C2, flat.R1, flat.R2,
              flat.D1, flat.D2, flat.omega1, flat.omega2, t(Tb_arr))
    acc: dict = {}
    steps = 0
    tc = _dispatch.trial_chunk(n_trials, B * _ML_LANE_BYTES, dispatch)
    for d, lo, hi in _dispatch.pieces(
            n_trials, _dispatch.split_devices(dispatch, dev)):
        on_d = tuple(x.to(d) for x in params)
        for t0 in range(lo, hi, tc):
            trials = range(t0, min(t0 + tc, hi))
            sl = slice(trials.start, trials.stop)
            with _dispatch.on_device(d):
                out, ran = _run_one_ml(
                    *on_d, _dispatch.to_device(gaps[:, sl], d),
                    _dispatch.to_device(hard[:, sl], d), n_steps=n_steps)
            steps = max(steps, ran)
            _scatter(acc, out, slice(None), trials, B, n_trials, dev)

    shp = grid.shape + (n_trials,)
    r = lambda k: acc[k].reshape(shp)
    return MultilevelTrajectoryBatch(
        wall_time=r("wall_time"), energy=_ml_energy(acc, flat.reshape(
            grid.shape), n_trials),
        work_executed=r("work_executed"), io1_time=r("io1_time"),
        io2_time=r("io2_time"), down_time=r("down_time"),
        n_failures=r("n_failures"), n_hard_failures=r("n_hard_failures"),
        n_ckpt1=r("n_ckpt1"), n_ckpt2=r("n_ckpt2"),
        truncated=r("truncated"), gaps_exhausted=r("gaps_exhausted"),
        steps=steps, n_steps=n_steps)


def simulate_grid_ml(T, m, grid: MultilevelParamGrid, T_base: float = 1.0,
                     n_trials: int = 200,
                     rng: Optional[np.random.Generator] = None, gaps=None,
                     hard=None, n_steps: Optional[int] = None,
                     dispatch=None, device="cuda") -> dict:
    """Mean/SE tensors of ``grid.shape`` of the two-level Monte Carlo
    ("T_final", "E_final", "T_cal", "T_io1", "T_io2", "T_down",
    "n_failures", "n_hard", each with "_se"); the check of the multilevel
    closed forms.  Raises when a trajectory was truncated or ran out of
    schedule."""
    tb = simulate_trajectories_ml(T, m, grid, T_base, n_trials=n_trials,
                                  rng=rng, gaps=gaps, hard=hard,
                                  n_steps=n_steps, dispatch=dispatch,
                                  device=device)
    n_trunc = int(tb.truncated.sum())
    if n_trunc:
        raise RuntimeError(
            f"{n_trunc} trajectories exceeded the scan budget; pass a "
            f"larger n_steps (check params)")
    n_dry = int(tb.gaps_exhausted.sum())
    if n_dry:
        raise RuntimeError(
            f"{n_dry} trajectories exhausted their failure schedule (tail "
            f"simulated failure-free); pass gaps/hard arrays with larger "
            f"capacity")
    out = {}
    n = tb.wall_time.shape[-1]
    for key, arr in (("T_final", tb.wall_time), ("E_final", tb.energy),
                     ("T_cal", tb.work_executed), ("T_io1", tb.io1_time),
                     ("T_io2", tb.io2_time), ("T_down", tb.down_time),
                     ("n_failures", tb.n_failures.to(F64)),
                     ("n_hard", tb.n_hard_failures.to(F64))):
        out[key] = arr.mean(dim=-1)
        out[key + "_se"] = arr.std(dim=-1, correction=1) / math.sqrt(n)
    return out
