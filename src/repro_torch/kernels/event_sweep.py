"""The event-level MC sweep kernel: CUDA wrappers and plain PyTorch versions.

Replaces the reference's Pallas kernel
``repro/kernels/event_sweep.py::_event_kernel`` (its oracle is the scan
kernel ``repro/sim/engine.py::_run_one_event``).  For every (grid point,
trial) lane it jumps from failure to failure in closed form: the
completion time ``j*T + t_in`` is compared with the next gap; on a failure
it counts the ``k`` committed checkpoints, the wasted partial segment and
the new committed work; it keeps running sums of wall, work, I/O and down
time, ``n_fail`` and ``n_ckpt``, and the ``truncated``/``gaps_exhausted``
flags.  One kernel body (``repro_torch/csrc/event_sweep.cu``, one thread
per lane, per-lane early exit) takes its gaps from one of two sources:

* :func:`event_sweep`: an explicit ``(B, N, F)`` schedule of any
  strides, read through them (a ``(B, F, N)``-contiguous schedule viewed
  as ``(B, N, F)`` is the layout whose reads coalesce).
* :func:`event_sweep_sampled`: gaps drawn inside the kernel from the
  lanes' counter-based streams (Philox, ``core/philox.py``) and a
  process's :class:`~repro_torch.core.failures.GapSpec`, so no schedule is
  stored.  Its plain version, :func:`event_sweep_sampled_plain`, draws the
  schedule with :func:`~repro_torch.core.failures.draw_gaps` (what
  ``sample_gaps`` does) and runs :func:`event_sweep_plain` on it.

:func:`event_draws` writes the gaps the sampled kernel draws (the same
device code), so the sweep can be held bitwise against the explicit kernel
on one schedule; its plain version is ``draw_gaps``.

Each wrapper launches its kernel for CUDA tensors on the current stream,
or raises; it never falls back.  For CPU tensors it runs its plain
version.  ``<wrapper>.launches`` counts kernel launches and
``<plain>.calls`` the plain versions' calls.  :func:`event_sweep_plain`
is the kernel's arithmetic, term for term, over a batch of lanes with
``torch.gather`` on the gap index; the kernels are held bitwise against
it on the card.

All run in f64, or in f32 with Neumaier-compensated running sums
(``compensated=True``), and return f64 floats.  Drawn gaps are f64 and
cast to the compute dtype (round to nearest) before the sweep.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.failures import GapSpec, draw_gaps
from ..core.philox import CounterKey
from . import _build, cost

#: work-completion slack — matches the engine's epsilon term for term.
_EPS = 1e-12

_SOURCE = "event_sweep.cu"

_FLOAT_KEYS = ("wall_time", "work_executed", "io_time", "down_time")
_INT_KEYS = ("n_failures", "n_checkpoints")
_BOOL_KEYS = ("truncated", "gaps_exhausted")
OUTPUT_KEYS = _FLOAT_KEYS + _INT_KEYS + _BOOL_KEYS


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    i32, i64, u32, ptr = (ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
                          ctypes.c_void_p)
    lib.repro_event_sweep.argtypes = (
        [i32, i32] + [ptr] * 7 + [i64] * 7 + [ptr] * 9)
    lib.repro_event_sweep_sampled.argtypes = (
        [i32] * 3 + [ptr] * 9 + [i64, ptr, i64, u32, u32] + [i64] * 4
        + [ptr] * 9)
    lib.repro_event_draws.argtypes = (
        [i32] + [ptr] * 3 + [i64, ptr, i64, u32, u32] + [i64] * 3
        + [ptr] * 2)
    for fn in (lib.repro_event_sweep, lib.repro_event_sweep_sampled,
               lib.repro_event_draws):
        fn.restype = ctypes.c_int
    return lib


def _check_params(params, B: int, dtype, device, what: str) -> None:
    for name, x in zip(("T", "C", "R", "D", "omega", "T_base"), params):
        if x.shape != (B,):
            raise ValueError(f"{name} must have shape ({B},), "
                             f"got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, {what} {dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, {what} on {device}")


def _check(params, gaps: torch.Tensor, n_steps: int) -> None:
    if gaps.ndim != 3:
        raise ValueError(f"gaps must be (B, N, F), got {tuple(gaps.shape)}")
    if gaps.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gaps must be float32 or float64, got {gaps.dtype}")
    _check_params(params, gaps.shape[0], gaps.dtype, gaps.device,
                  "gaps are")
    if int(n_steps) < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")


def _outputs(B: int, N: int, dev) -> list:
    """Empty ``(B, N)`` outputs in ``OUTPUT_KEYS`` order."""
    return ([torch.empty((B, N), dtype=torch.float64, device=dev)
             for _ in _FLOAT_KEYS]
            + [torch.empty((B, N), dtype=torch.int32, device=dev)
               for _ in _INT_KEYS]
            + [torch.empty((B, N), dtype=torch.bool, device=dev)
               for _ in _BOOL_KEYS])


def event_sweep(T, C, R, D, omega, T_base, gaps: torch.Tensor, *,
                n_steps: int, compensated: bool = False) -> dict:
    """Run the event kernel over a ``(B,) x (B, N, F)`` workload.

    ``T``..``T_base``: per-point tensors of shape ``(B,)`` in the compute
    dtype of ``gaps`` (f64, or f32); ``gaps``: failure schedules
    ``(B, N, F)`` of any strides (the kernel reads through them; with
    trial stride 1, a ``(B, F, N)`` layout, a warp's reads coalesce).
    Returns ``{key: (B, N)}`` with f64 floats, int32 counts and bool
    flags, on the device of ``gaps``.
    """
    params = (T, C, R, D, omega, T_base)
    _check(params, gaps, n_steps)
    if gaps.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"event_sweep runs on cuda or cpu tensors (or meta "
                         f"ones, for shapes), not {gaps.device}")
    B, N, F = gaps.shape
    with cost.unit("event_sweep", lambda: _sweep_work(
            B, N, F, n_steps, compensated, gaps), (*params, gaps)):
        if cost.shape_only(gaps):
            return dict(zip(OUTPUT_KEYS, _outputs(B, N, gaps.device)))
        if gaps.device.type == "cpu":
            return event_sweep_plain(T, C, R, D, omega, T_base, gaps,
                                     n_steps=n_steps, compensated=compensated)
        lib = load_library()
        dev = gaps.device
        params = [x.contiguous() for x in params]
        outs = _outputs(B, N, dev)
        _build.launch(lib.repro_event_sweep, int(gaps.dtype == torch.float64),
                      int(bool(compensated)), *[x.data_ptr() for x in params],
                      gaps.data_ptr(), *gaps.stride(), B, N, F, int(n_steps),
                      *[o.data_ptr() for o in outs], device=dev,
                      name="event_sweep")
        event_sweep.launches += 1
        return dict(zip(OUTPUT_KEYS, outs))


def _sweep_work(B: int, N: int, F: int, n_steps: int, compensated: bool,
                gaps: torch.Tensor) -> cost.Work:
    """The explicit kernel's work from shapes alone: every lane reading
    ``min(F, n_steps)`` gaps, the most it may (what a run reads depends on
    its failures); a point stride of 0 reads one schedule row."""
    per = min(F, int(n_steps))
    rows = 1 if gaps.stride(0) == 0 else B
    return cost.event_sweep_work(B, B * N, rows * N * per, B * N * per,
                                 compensated=compensated,
                                 gap_item=gaps.element_size())


event_sweep.launches = 0


_MASK = 0xFFFFFFFF


def _key(seed: int, points: torch.Tensor, trial0: int,
         n_trials: int) -> CounterKey:
    return CounterKey(int(seed), points, torch.arange(
        int(trial0), int(trial0) + int(n_trials), dtype=torch.int64,
        device=points.device))


def _check_sampled(spec: GapSpec, points: torch.Tensor, trial0: int,
                   n_trials: int, capacity: int) -> None:
    B = int(points.numel())
    if points.shape != (B,) or points.dtype != torch.int64:
        raise ValueError(f"points must be a (B,) int64 tensor, got "
                         f"{tuple(points.shape)} {points.dtype}")
    for name, x in (("spec.a", spec.a), ("spec.b", spec.b)):
        if x.shape != (B,) or x.dtype != torch.float64:
            raise ValueError(f"{name} must be a ({B},) float64 tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != points.device:
            raise ValueError(f"{name} is on {x.device}, points on "
                             f"{points.device}")
    if spec.kind == "trace" and (
            spec.trace is None or spec.trace.device != points.device
            or spec.trace.dtype != torch.float64 or spec.trace.ndim != 1
            or spec.trace.numel() == 0):
        raise ValueError("a trace spec needs a non-empty 1-D float64 trace "
                         "on the points' device")
    if int(capacity) < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    # the Philox counter words hold the trial and the gap pair in 32 bits
    if not (0 <= int(trial0) and int(trial0) + int(n_trials) <= _MASK + 1
            and int(n_trials) >= 0 and int(capacity) <= 2 * (_MASK + 1)):
        raise ValueError(f"trials [{trial0}, {trial0} + {n_trials}) or "
                         f"capacity {capacity} outside the 32-bit counters")


def event_sweep_sampled(T, C, R, D, omega, T_base, *, seed: int,
                        points: torch.Tensor, trial0: int, n_trials: int,
                        spec: GapSpec, capacity: int, n_steps: int,
                        compensated: bool = False) -> dict:
    """Run the event kernel over ``points`` x trials ``[trial0, trial0 +
    n_trials)``, drawing each lane's gaps inside the kernel.

    ``T``..``T_base``: ``(B,)`` per-point tensors in the compute dtype (f64,
    or f32); ``points``: the ``(B,)`` int64 global grid indices of the rows
    (with the global trial and the gap pair's index they make the Philox
    counter, a point's low and high words in two of its 32-bit words,
    ``core/philox.py``, so the draws do not depend on the block);
    ``spec``:
    the process's :class:`GapSpec` of these ``B`` points; ``capacity``:
    the schedule length ``F`` (a gap index ``>= F`` is inf and flags the
    lane exhausted); ``n_steps``: the step budget.  The same outputs as
    :func:`event_sweep` on the schedule ``draw_gaps(spec, key, F)`` cast to
    the compute dtype.
    """
    params = (T, C, R, D, omega, T_base)
    if T.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"T must be float32 or float64, got {T.dtype}")
    _check_params(params, int(points.numel()), T.dtype, T.device, "T is")
    if points.device != T.device:
        raise ValueError(f"points are on {points.device}, T on {T.device}")
    _check_sampled(spec, points, trial0, n_trials, capacity)
    if int(n_steps) < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    kw = dict(seed=seed, points=points, trial0=trial0, n_trials=n_trials,
              spec=spec, capacity=capacity, n_steps=n_steps,
              compensated=compensated)
    dev = points.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"event_sweep_sampled runs on cuda or cpu tensors "
                         f"(or meta ones, for shapes), not {dev}")
    B, N = int(points.numel()), int(n_trials)
    per = min(int(capacity), int(n_steps))
    work = lambda: cost.event_sweep_sampled_work(B, B * N, B * N * per,
                                                 compensated=compensated)
    with cost.unit("event_sweep_sampled", work, (*params, points)):
        if cost.shape_only(points):
            return dict(zip(OUTPUT_KEYS, _outputs(B, N, dev)))
        if dev.type == "cpu":
            return event_sweep_sampled_plain(*params, **kw)
        return _sampled_kernel(params, spec, points, seed, trial0, B, N,
                               capacity, n_steps, compensated)


def _sampled_kernel(params, spec, points, seed, trial0, B, N, capacity,
                    n_steps, compensated) -> dict:
    """Launch the sampled kernel on the points' CUDA device."""
    T, dev = params[0], points.device
    lib = load_library()
    # every buffer stays referenced until the launch is queued
    params = [x.contiguous() for x in params]
    a, b, points = spec.a.contiguous(), spec.b.contiguous(), \
        points.contiguous()
    trace = spec.trace.contiguous() if spec.trace is not None else None
    outs = _outputs(B, N, dev)
    _build.launch(lib.repro_event_sweep_sampled,
                  int(T.dtype == torch.float64), int(bool(compensated)),
                  spec.kind_id, *[x.data_ptr() for x in params],
                  a.data_ptr(), b.data_ptr(),
                  trace.data_ptr() if trace is not None else None,
                  trace.numel() if trace is not None else 0,
                  points.data_ptr(), int(trial0),
                  int(seed) & _MASK, (int(seed) >> 32) & _MASK, B, N,
                  int(capacity), int(n_steps), *[o.data_ptr() for o in outs],
                  device=dev, name="event_sweep_sampled")
    event_sweep_sampled.launches += 1
    return dict(zip(OUTPUT_KEYS, outs))


event_sweep_sampled.launches = 0


def event_sweep_sampled_plain(T, C, R, D, omega, T_base, *, seed: int,
                              points: torch.Tensor, trial0: int,
                              n_trials: int, spec: GapSpec, capacity: int,
                              n_steps: int, compensated: bool = False
                              ) -> dict:
    """:func:`event_sweep_sampled` in two steps: the schedule drawn by
    ``draw_gaps`` (the draws of ``sample_gaps``), cast to the compute
    dtype, then :func:`event_sweep_plain`."""
    event_sweep_sampled_plain.calls += 1
    _check_sampled(spec, points, trial0, n_trials, capacity)
    gaps = draw_gaps(spec, _key(seed, points, trial0, n_trials),
                     int(capacity)).to(T.dtype)
    return event_sweep_plain(T, C, R, D, omega, T_base, gaps,
                             n_steps=n_steps, compensated=compensated)


event_sweep_sampled_plain.calls = 0


def event_draws(spec: GapSpec, *, seed: int, points: torch.Tensor,
                trial0: int, n_trials: int, capacity: int) -> torch.Tensor:
    """The f64 gaps :func:`event_sweep_sampled` draws for these lanes,
    ``(B, N, F)``: on CUDA a view of a ``(B, F, N)``-contiguous tensor
    written by the kernel's own draw code (``repro_event_draws``); on the
    CPU ``draw_gaps``.  A check, not a path: the engine never calls it."""
    _check_sampled(spec, points, trial0, n_trials, capacity)
    dev = points.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"event_draws runs on cuda or cpu tensors (or meta "
                         f"ones, for shapes), not {dev}")
    B, N, F = int(points.numel()), int(n_trials), int(capacity)
    work = lambda: cost.event_draws_work(B, B * N, F)
    with cost.unit("event_draws", work, (points,)):
        if cost.shape_only(points):
            return torch.empty((B, F, N), dtype=torch.float64,
                               device=dev).transpose(1, 2)
        if dev.type == "cpu":
            return draw_gaps(spec, _key(seed, points, trial0, n_trials),
                             int(capacity))
        return _draws_kernel(spec, points, seed, trial0, B, N, F)


def _draws_kernel(spec, points, seed, trial0, B, N, F) -> torch.Tensor:
    """Launch the draw-only entry on the points' CUDA device."""
    dev = points.device
    lib = load_library()
    out = torch.empty((B, F, N), dtype=torch.float64, device=dev)
    a, b, points = spec.a.contiguous(), spec.b.contiguous(), \
        points.contiguous()
    trace = spec.trace.contiguous() if spec.trace is not None else None
    _build.launch(lib.repro_event_draws, spec.kind_id, a.data_ptr(),
                  b.data_ptr(),
                  trace.data_ptr() if trace is not None else None,
                  trace.numel() if trace is not None else 0,
                  points.data_ptr(), int(trial0),
                  int(seed) & _MASK, (int(seed) >> 32) & _MASK, B, N, F,
                  out.data_ptr(), device=dev, name="event_draws")
    event_draws.launches += 1
    return out.transpose(1, 2)


event_draws.launches = 0


def _comp_add(s, c, x):
    """Neumaier step (sim/precision.py::comp_add), spelled out."""
    s2 = s + x
    bb = s2 - s
    err = (s - (s2 - bb)) + (x - bb)
    return s2, c + err


def event_sweep_plain(T, C, R, D, omega, T_base, gaps: torch.Tensor, *,
                      n_steps: int, compensated: bool = False) -> dict:
    """The kernel's arithmetic over all lanes at once, in PyTorch.

    Mirrors the reference's ``_run_one_event`` step for step: lanes that
    are done keep their state (the loop stops once every lane is done,
    which skips only identity steps).
    """
    event_sweep_plain.calls += 1
    _check((T, C, R, D, omega, T_base), gaps, n_steps)
    dt, dev = gaps.dtype, gaps.device
    B, N, F = gaps.shape
    k0 = lambda v: torch.tensor(v, dtype=dt, device=dev)
    zero, one, eps, inf = k0(0.0), k0(1.0), k0(_EPS), k0(float("inf"))
    col = lambda x: x.reshape(B, 1)
    T, C, R, D, omega, T_base = (col(x) for x in (T, C, R, D, omega, T_base))
    Tc = T - C
    w = T - (one - omega) * C
    omega_safe = torch.where(omega > zero, omega, one)

    fz = torch.zeros((B, N), dtype=dt, device=dev)
    wall, committed, work, io, down = (fz.clone() for _ in range(5))
    c_wall, c_comm, c_work, c_io, c_down = (fz.clone() for _ in range(5))
    n_fail = torch.zeros((B, N), dtype=torch.int32, device=dev)
    n_ckpt = torch.zeros((B, N), dtype=torch.int32, device=dev)
    used_inf = torch.zeros((B, N), dtype=torch.bool, device=dev)
    done = torch.zeros((B, N), dtype=torch.bool, device=dev)

    for _ in range(int(n_steps)):
        if bool(done.all()):
            break
        in_range = n_fail < F
        gi = torch.clamp(n_fail, max=F - 1).to(torch.int64)
        g = torch.where(in_range,
                        torch.gather(gaps, 2, gi.unsqueeze(-1)).squeeze(-1),
                        inf)

        committed_true = committed + c_comm if compensated else committed
        rem = T_base - committed_true
        j = torch.clamp_min(torch.floor((rem - eps) / w), 0.0)
        r = rem - j * w
        rr = r - Tc
        t_in = torch.where(rr > zero, Tc + rr / omega_safe, r)
        t_fin = j * T + t_in
        complete = t_fin < g

        s = torch.where(torch.isfinite(g), g, zero)
        k = torch.floor(s / T)
        k = torch.where((k > zero) & (k * T >= s), k - one, k)
        u = s - k * T
        uc = u - Tc

        sel = lambda a, b: torch.where(complete, a, b)
        keep = lambda old, new: torch.where(done, old, new)
        if not compensated:
            new = (sel(wall + t_fin, (wall + s) + D + R),
                   sel(committed, torch.where(
                       k >= one, committed + (k - one) * w + Tc, committed)),
                   sel(work + rem,
                       work + k * w + torch.where(uc > zero,
                                                  Tc + omega * uc, u)),
                   sel(io + j * C + torch.clamp_min(rr, 0.0) / omega_safe,
                       io + k * C + torch.clamp_min(uc, 0.0) + R),
                   sel(down, down + D))
            wall, committed, work, io, down = (
                keep(o, n) for o, n in zip((wall, committed, work, io, down),
                                           new))
        else:
            incs = (sel(t_fin, s + D + R),
                    sel(zero, torch.where(k >= one, (k - one) * w + Tc,
                                          zero)),
                    sel(rem, k * w + torch.where(uc > zero,
                                                 Tc + omega * uc, u)),
                    sel(j * C + torch.clamp_min(rr, 0.0) / omega_safe,
                        k * C + torch.clamp_min(uc, 0.0) + R),
                    sel(zero, D))
            olds = ((wall, c_wall), (committed, c_comm), (work, c_work),
                    (io, c_io), (down, c_down))
            pairs = [_comp_add(s_, c_, x_) for (s_, c_), x_ in zip(olds, incs)]
            (wall, c_wall), (committed, c_comm), (work, c_work), \
                (io, c_io), (down, c_down) = [
                    (keep(s_, p[0]), keep(c_, p[1]))
                    for (s_, c_), p in zip(olds, pairs)]
        n_fail = keep(n_fail, sel(n_fail, n_fail + 1))
        n_ckpt = keep(n_ckpt, n_ckpt + sel(j, k).to(torch.int32))
        used_inf = keep(used_inf, used_inf | ~in_range)
        done = done | complete

    if compensated:
        wall = wall + c_wall
        work = work + c_work
        io = io + c_io
        down = down + c_down
    f64 = lambda x: x.to(torch.float64)
    return dict(zip(OUTPUT_KEYS, (f64(wall), f64(work), f64(io), f64(down),
                                  n_fail, n_ckpt, ~done, used_inf)))


event_sweep_plain.calls = 0
