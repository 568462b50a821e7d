"""The RG-LRU linear scan ``h_t = a_t * h_{t-1} + b_t``: CUDA wrapper and
plain PyTorch version.

Replaces the reference's Pallas kernel
``repro/kernels/rglru_scan.py::_rglru_kernel`` (oracle
``repro/kernels/ref.py::rglru_ref``), the inner loop of RecurrentGemma's
RG-LRU once its gates are computed.  ``a``, ``b``: ``(B, S, W)``, both
float32 or both bfloat16; ``h0``: ``(B, W)``.  The carry is float32 and is
never rounded between steps; only the stored ``h`` is cast to ``b``'s
dtype.

* :func:`rglru_scan` is the wrapper.  For CUDA tensors it launches the
  kernel of ``repro_torch/csrc/rglru_scan.cu`` on the current stream, or
  raises; for CPU tensors it runs :func:`rglru_scan_plain`.
  ``rglru_scan.launches`` counts kernel launches.  :func:`launch_plan`
  picks the kernel's route and grid: the ring route (TMA into a
  shared-memory ring, one warp per 32 lanes of a batch row) where each
  row of ``W`` elements is a multiple of 16 bytes, else the direct route
  (one thread per lane).
* :func:`rglru_scan_plain` is the same arithmetic in PyTorch, one step at
  a time (a product, then a sum, each rounded to f32); the kernel, built
  with ``-fmad=false``, is held bitwise against it.  ``.calls`` counts
  its calls.
* :class:`RGLRUScan` is the scan with a gradient.  Its backward is the
  reverse recurrence ``dh_t = g_t + a_{t+1} dh_{t+1}``, a linear scan
  too, run through :func:`rglru_scan` on the sequence flipped in time
  (:func:`reverse_scan`): on the card the kernel runs in the backward as
  well.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, cost

_SOURCE = "rglru_scan.cu"
DTYPES = (torch.float32, torch.bfloat16)
#: the ring route's block: w lanes, time steps per stage of its ring.
RING_LANES, RING_STEPS = 32, 64
#: the direct route's threads per block.
DIRECT_THREADS = 64


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    fn = lib.repro_rglru_scan
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(a, b, h0) -> None:
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must both be (B, S, W), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be {(a.shape[0], a.shape[2])}, got "
                         f"{tuple(h0.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share a dtype among {DTYPES}, got "
                        f"{a.dtype} and {b.dtype}")
    if not h0.dtype.is_floating_point:
        raise TypeError(f"h0 must be floating point, got {h0.dtype}")
    if not (a.device == b.device == h0.device):
        raise ValueError("a, b and h0 must lie on one device")
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors (or meta "
                         f"ones, for shapes), not {a.device}")


def launch_plan(B: int, S: int, W: int, dtype: torch.dtype) -> dict:
    """The kernel's route and grid for ``(B, S, W)`` inputs of ``dtype``.

    ``ring``: a block per (tile of ``RING_LANES`` w lanes, batch row), each
    walking ``tiles`` tiles of ``RING_STEPS`` time steps; TMA takes a row
    stride of a multiple of 16 bytes only (and at most 65535 rows in the
    grid's y).  ``direct``: one thread per (b, w) lane, blocks of
    ``DIRECT_THREADS``."""
    size = torch.empty((), dtype=dtype).element_size()
    if (W * size) % 16 == 0 and B <= 65535 and S < 2 ** 31:
        return {"route": "ring", "grid": (-(-W // RING_LANES), B),
                "lanes": RING_LANES, "steps": RING_STEPS,
                "tiles": -(-S // RING_STEPS)}
    return {"route": "direct", "grid": (-(-(B * W) // DIRECT_THREADS), 1),
            "lanes": DIRECT_THREADS, "steps": S, "tiles": 1}


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """``h`` of shape ``(B, S, W)`` in ``b``'s dtype."""
    _check(a, b, h0)
    work = lambda: cost.rglru_work(*a.shape, b.dtype)
    with cost.unit("rglru_scan", work, (a, b, h0)):
        if cost.shape_only(a):
            return torch.empty(b.shape, dtype=b.dtype, device=b.device)
        if a.device.type == "cpu":
            return rglru_scan_plain(a, b, h0)
        return _kernel(a, b, h0)


def _kernel(a, b, h0) -> torch.Tensor:
    """Allocate the output and launch the kernel on the inputs' device."""
    B, S, W = a.shape
    a, b = _build.aligned(a), _build.aligned(b)
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty((B, S, W), dtype=b.dtype, device=b.device)
    ring = launch_plan(B, S, W, b.dtype)["route"] == "ring"
    _build.launch(load_library().repro_rglru_scan,
                  int(b.dtype == torch.bfloat16), int(ring), a.data_ptr(),
                  b.data_ptr(), h0.data_ptr(), out.data_ptr(), B, S, W,
                  device=a.device,
                  name="rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (any device)."""
    rglru_scan_plain.calls += 1
    _check(a, b, h0)
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    h = h0.to(torch.float32)
    for t in range(a.shape[1]):
        h = a[:, t].to(torch.float32) * h + b[:, t].to(torch.float32)
        out[:, t] = h
    return out


rglru_scan_plain.calls = 0


def reverse_scan(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dh`` with ``dh_t = g_t + a_{t+1} dh_{t+1}`` (``a_S`` = 0): one
    :func:`rglru_scan` over the time-flipped ``g`` with ``a`` shifted by one
    step, from a zero state.  ``a``, ``g``: ``(B, S, W)`` of one dtype."""
    shifted = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                     device=a.device)
    return rglru_scan(shifted.flip(1), g.flip(1), h0).flip(1)


class RGLRUScan(torch.autograd.Function):
    """:func:`rglru_scan` with a gradient: ``a``, ``b`` ``(B, S, W)``, ``h0``
    ``(B, W)``; returns ``h`` in ``b``'s dtype.  Forward: the wrapper (the
    kernel on CUDA, counted in ``rglru_scan.launches``; the plain version
    on the CPU), keeping ``a``, ``h`` and ``h0``.  Backward, from the
    cotangent g of h: ``dh = reverse_scan(a, g)`` (one more launch on
    CUDA), then ``db = dh``, ``da_t = dh_t h_{t-1}`` with ``h_{-1} = h0``,
    and ``dh0 = a_0 dh_0``."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        dh = reverse_scan(a, g.to(a.dtype)).to(torch.float32)
        prev = torch.cat([h0.to(torch.float32)[:, None],
                          h[:, :-1].to(torch.float32)], dim=1)
        da = dh * prev
        dh0 = a[:, 0].to(torch.float32) * dh[:, 0]
        return da.to(a.dtype), dh.to(a.dtype), dh0.to(h0.dtype)
