"""The event-level MC sweep kernel: CUDA wrapper and plain PyTorch version.

Replaces the reference's Pallas kernel
``repro/kernels/event_sweep.py::_event_kernel`` (its oracle is the scan
kernel ``repro/sim/engine.py::_run_one_event``).  For every (grid point,
trial) lane it jumps from failure to failure in closed form: the
completion time ``j*T + t_in`` is compared with the next gap; on a failure
it counts the ``k`` committed checkpoints, the wasted partial segment and
the new committed work; it keeps running sums of wall, work, I/O and down
time, ``n_fail`` and ``n_ckpt``, and the ``truncated``/``gaps_exhausted``
flags.

* :func:`event_sweep` is the wrapper.  For CUDA tensors it launches the
  hand-written kernel (``repro_torch/csrc/event_sweep.cu``, one thread per
  lane, per-lane early exit) on the current stream, or raises; it never
  falls back.  For CPU tensors it runs :func:`event_sweep_plain`.
  ``event_sweep.launches`` counts kernel launches.
* :func:`event_sweep_plain` is the same arithmetic, term for term, over a
  batch of lanes with ``torch.gather`` on the gap index; the kernel is
  held bitwise against it on the card.  ``event_sweep_plain.calls``
  counts its calls.

Both run in f64, or in f32 with Neumaier-compensated running sums
(``compensated=True``), and return f64 floats.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

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
    fn = lib.repro_event_sweep
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    return lib


def _check(params, gaps: torch.Tensor, n_steps: int) -> None:
    if gaps.ndim != 3:
        raise ValueError(f"gaps must be (B, N, F), got {tuple(gaps.shape)}")
    if gaps.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gaps must be float32 or float64, got {gaps.dtype}")
    B = gaps.shape[0]
    for name, x in zip(("T", "C", "R", "D", "omega", "T_base"), params):
        if x.shape != (B,):
            raise ValueError(f"{name} must have shape ({B},), "
                             f"got {tuple(x.shape)}")
        if x.dtype != gaps.dtype:
            raise TypeError(f"{name} is {x.dtype}, gaps are {gaps.dtype}")
        if x.device != gaps.device:
            raise ValueError(f"{name} is on {x.device}, gaps on "
                             f"{gaps.device}")
    if int(n_steps) < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")


def event_sweep(T, C, R, D, omega, T_base, gaps: torch.Tensor, *,
                n_steps: int, compensated: bool = False) -> dict:
    """Run the event kernel over a ``(B,) x (B, N, F)`` workload.

    ``T``..``T_base``: per-point tensors of shape ``(B,)`` in the compute
    dtype of ``gaps`` (f64, or f32); ``gaps``: failure schedules
    ``(B, N, F)``.  Returns ``{key: (B, N)}`` with f64 floats, int32
    counts and bool flags, on the device of ``gaps``.
    """
    params = (T, C, R, D, omega, T_base)
    _check(params, gaps, n_steps)
    if gaps.device.type == "cpu":
        return event_sweep_plain(T, C, R, D, omega, T_base, gaps,
                                 n_steps=n_steps, compensated=compensated)
    if gaps.device.type != "cuda":
        raise ValueError(f"event_sweep runs on cuda or cpu tensors, "
                         f"not {gaps.device}")
    lib = load_library()
    B, N, F = gaps.shape
    dev = gaps.device
    params = [x.contiguous() for x in params]
    gaps = gaps.contiguous()
    outs = ([torch.empty((B, N), dtype=torch.float64, device=dev)
             for _ in _FLOAT_KEYS]
            + [torch.empty((B, N), dtype=torch.int32, device=dev)
               for _ in _INT_KEYS]
            + [torch.empty((B, N), dtype=torch.bool, device=dev)
               for _ in _BOOL_KEYS])
    _build.launch(lib.repro_event_sweep, int(gaps.dtype == torch.float64),
                  int(bool(compensated)), *[x.data_ptr() for x in params],
                  gaps.data_ptr(), B, N, F, int(n_steps),
                  *[o.data_ptr() for o in outs], device=dev,
                  name="event_sweep")
    event_sweep.launches += 1
    return dict(zip(OUTPUT_KEYS, outs))


event_sweep.launches = 0


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
