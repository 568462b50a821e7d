"""Batched Monte-Carlo trajectory engine (event level, on the device).

The scalar event loop of ``core.simulator.simulate_once`` rewritten to jump
from failure to failure in closed form, for every (grid point, trial)
lane at once: the work goes through the event kernel
(:mod:`repro_torch.kernels.event_sweep`, CUDA on the card, its plain
PyTorch version on the CPU).  The reference's ``engine_kind="event"`` is
the only kind.

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
  outputs.  On the CPU the schedule is drawn block by block
  (:func:`sampled_schedules`, the plain version of those draws) and swept
  by the kernel's plain version.  Grid points are grouped into
  power-of-two capacity buckets (:func:`fail_capacity_points`): a lane's
  capacity is the length of its schedule, past which it runs failure-free
  and is flagged; the trials and grid axes are cut into blocks under the
  device-memory budget.  Buckets, chunk size and memory budget are
  therefore bit-exact no-ops on a given device, as in the reference (the
  draws do not match JAX's threefry streams; they are held statistically).

Precision follows :func:`~repro_torch.sim.dispatch.resolve_precision`:
gaps are drawn in f64 and cast to the policy's compute dtype before the
sweep; outputs are f64.  Results stay on the device as tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import numpy as np
import torch

from .._device import F64, resolve_device
from ..core.failures import as_process
from ..core.philox import CounterKey
from ..kernels.event_sweep import event_sweep, event_sweep_sampled
from . import dispatch as _dispatch
from .scenarios import ParamGrid

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
             n_steps: Optional[int]):
    """(capacity, step budget, raveled point indices) of every pow2
    capacity bucket, split by step budget, in the engine's order."""
    caps = fail_capacity_points(T_arr, flat, Tb_arr, process=process)
    budgets = (np.full(flat.size, _scan_len(n_steps), dtype=np.int64)
               if n_steps is not None else caps + 1)
    for cap in np.unique(caps):
        in_bucket = caps == cap
        for b in np.unique(budgets[in_bucket]):
            yield int(cap), int(b), np.nonzero(in_bucket & (budgets == b))[0]


def _process_mean(proc, flat: ParamGrid, dev) -> torch.Tensor:
    """The (B,) f64 mean each point's gaps are drawn at."""
    return torch.as_tensor(proc.resolve_mean(_host(flat.mu)), dtype=F64,
                           device=dev).broadcast_to((flat.size,))


def sampled_schedules(T, grid: ParamGrid, T_base: float = 1.0,
                      n_trials: int = 200, seed: int = 0, process=None,
                      n_steps: Optional[int] = None, dispatch=None,
                      device="cuda") -> Iterator[ScheduleBlock]:
    """The auto-sampled schedules of :func:`simulate_trajectories`, drawn
    in PyTorch: one pow2 capacity bucket at a time, each cut into (trial,
    point) blocks under the memory budget, every block drawn on ``device``
    from the counter-based stream of its lanes.  A lane's gaps depend on
    (``seed``, point, trial, gap index, process) only, so another
    ``dispatch`` yields the same gaps in other blocks.  The engine sweeps
    these on the CPU; on a CUDA device its kernel draws the same lanes
    itself, and these are the plain version of those draws."""
    dev = resolve_device(device)
    flat, T_arr, Tb_arr = _flat_inputs(T, grid, T_base, dev)
    proc = as_process(process).ravel()
    mean = _process_mean(proc, flat, dev)
    for cap, steps, idx in _buckets(T_arr, flat, Tb_arr, process, n_steps):
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


def _run_blocks(blocks, flat: ParamGrid, T_arr: torch.Tensor,
                Tb_arr: torch.Tensor, n_trials: int, policy) -> dict:
    """Run the event kernel over every block of a stored schedule; returns
    flat ``(B, n_trials)`` output tensors on the grid's device."""
    acc: dict = {}
    for blk in blocks:
        p = blk.points
        out = event_sweep(*_point_params(flat, T_arr, Tb_arr, p, policy),
                          policy.cast(blk.gaps), n_steps=blk.n_steps,
                          compensated=policy.compensated)
        _scatter(acc, out, p, blk.trials, flat.size, n_trials)
    return acc


def sampled_launches(flat: ParamGrid, T_arr: torch.Tensor,
                     Tb_arr: torch.Tensor, n_trials: int, seed: int,
                     process, n_steps, dispatch, policy):
    """The ``event_sweep_sampled`` calls of an auto-sampled run, one per
    block of every (capacity, budget) bucket: ``(points, trials, args,
    kwargs)``, in the engine's order."""
    dev = T_arr.device
    proc = as_process(process).ravel()
    spec = proc.gap_spec(_process_mean(proc, flat, dev), flat.size, dev)
    for cap, steps, idx in _buckets(T_arr, flat, Tb_arr, process, n_steps):
        for pts, trials in _blocks(idx, n_trials,
                                   _lane_bytes(cap, stored=False), dispatch):
            p = torch.as_tensor(pts, dtype=torch.int64, device=dev)
            yield p, trials, _point_params(flat, T_arr, Tb_arr, p, policy), \
                dict(seed=seed, points=p, trial0=trials.start,
                     n_trials=len(trials), spec=spec.take(p), capacity=cap,
                     n_steps=steps, compensated=policy.compensated)


def _run_sampled(flat: ParamGrid, T_arr: torch.Tensor, Tb_arr: torch.Tensor,
                 n_trials: int, seed: int, process, n_steps, dispatch,
                 policy) -> dict:
    """Run the event kernel with in-kernel draws, one launch a block;
    returns flat ``(B, n_trials)`` output tensors."""
    acc: dict = {}
    for p, trials, args, kw in sampled_launches(
            flat, T_arr, Tb_arr, n_trials, seed, process, n_steps, dispatch,
            policy):
        _scatter(acc, event_sweep_sampled(*args, **kw), p, trials, flat.size,
                 n_trials)
    return acc


def _assemble_batch(out: dict, grid: ParamGrid,
                    n_trials: int) -> TrajectoryBatch:
    """Reshape flat outputs to ``grid.shape + (n_trials,)`` and attach the
    energy integral."""
    shp = grid.shape + (n_trials,)
    dev = out["wall_time"].device
    bc = lambda x: x.to(dev).reshape(grid.shape + (1,))
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


def simulate_trajectories(T, grid: ParamGrid, T_base: float = 1.0,
                          n_trials: int = 200, seed: int = 0, gaps=None,
                          n_steps: Optional[int] = None, process=None,
                          dispatch=None, precision=None,
                          device="cuda") -> TrajectoryBatch:
    """Simulate every (grid point x trial) trajectory through the event
    kernel on ``device``.

    ``T`` broadcasts against ``grid.shape``.  ``gaps`` (grid.size,
    n_trials, F) overrides the auto-sampled schedule — pass the same
    schedule to ``simulate_once(gaps=...)`` for parity checks.  ``process``
    selects the inter-failure distribution of auto-sampled schedules.
    ``n_steps`` caps the kernel's iterations (default: the schedule
    capacity + 1, which a complete trajectory never exceeds).
    ``dispatch`` bounds the device memory of each block; ``precision``
    selects the kernel's :class:`~repro_torch.sim.precision
    .PrecisionPolicy` (None = config / env / device default).  On a CUDA
    device an auto-sampled run draws its gaps inside the kernel.
    """
    dev = resolve_device(device)
    flat, T_arr, Tb_arr = _flat_inputs(T, grid, T_base, dev)
    pol = _dispatch.resolve_precision(dispatch, precision, dev)
    if gaps is not None:
        g = _normalize_gaps(gaps, flat.size, dev)
        n_trials = int(g.shape[1])
        steps = (_scan_len(g.shape[-1]) + 1 if n_steps is None
                 else _scan_len(n_steps))
        out = _run_blocks(_explicit_schedules(g, flat.size, steps, dispatch),
                          flat, T_arr, Tb_arr, n_trials, pol)
    elif dev.type == "cuda":
        out = _run_sampled(flat, T_arr, Tb_arr, int(n_trials), seed,
                           process, n_steps, dispatch, pol)
    else:
        blocks = sampled_schedules(T_arr, flat, Tb_arr, n_trials, seed,
                                   process, n_steps, dispatch, dev)
        out = _run_blocks(blocks, flat, T_arr, Tb_arr, int(n_trials), pol)
    return _assemble_batch(out, grid, int(n_trials))


def simulate_grid(T, grid: ParamGrid, T_base: float = 1.0,
                  n_trials: int = 200, seed: int = 0, gaps=None,
                  n_steps: Optional[int] = None, process=None,
                  dispatch=None, precision=None, device="cuda") -> dict:
    """Batched analogue of ``core.simulator.simulate``: mean/SE tensors of
    ``grid.shape`` ("T_final", "T_final_se", "E_final", ...).  Raises when
    any trajectory was truncated or ran out of schedule."""
    tb = simulate_trajectories(T, grid, T_base, n_trials=n_trials, seed=seed,
                               gaps=gaps, n_steps=n_steps, process=process,
                               dispatch=dispatch, precision=precision,
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
