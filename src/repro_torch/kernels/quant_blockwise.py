"""Blockwise int8 quantize/dequantize: CUDA wrappers and plain versions.

Replaces the reference's Pallas kernels
``repro/kernels/quant_blockwise.py::_quant_kernel`` and ``::_dequant_kernel``
(oracle ``repro/kernels/ref.py::quant_ref``/``dequant_ref``).  For an
``(N, D)`` f32 array, ``D % 128 == 0``, every (row, 128-lane group) gets
the absmax scale ``max(max|x| * float32(1/127), 1e-12)`` and
``q = int8(clip(round_half_even(x / scale), -127, 127))`` with NaN -> 0;
dequantization is ``float(q) * scale``.  That is the reference's result
bit for bit, its special values included: a group holding a NaN gets a
NaN scale and q = 0 everywhere, one holding +-inf an inf scale and q = 0.

* :func:`quantize` / :func:`dequantize` are the wrappers.  For CUDA
  tensors they launch the kernels of ``repro_torch/csrc/quant_blockwise.cu``
  on the current stream, or raise; they never fall back.  For CPU tensors
  they run the plain versions.  ``quantize.launches`` and
  ``dequantize.launches`` count kernel launches; the checkpoint store
  calls them from its flush thread, so the counts are bumped under a lock.
* :func:`quantize_plain` / :func:`dequantize_plain` are the same
  arithmetic in PyTorch; the kernels are held bitwise against them on the
  card.  ``.calls`` counts their calls.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

LANE_GROUP = 128

_SOURCE = "quant_blockwise.cu"
_COUNT_LOCK = threading.Lock()
#: float32(1/127): the constant XLA multiplies by in place of ``/ 127``.
_INV127 = 1.0 / 127.0
_FLOOR = 1e-12


def _bump(fn, attr: str) -> None:
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    for name, n_ptr in (("repro_quantize_blockwise", 3),
                        ("repro_dequantize_blockwise", 3)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int64,
                                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if x.ndim != 2 or x.shape[1] % LANE_GROUP:
        raise ValueError(f"{name} must be (N, D) with D % {LANE_GROUP} == 0, "
                         f"got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} on {x.device}: cuda or cpu tensors only")


def _check_kernel_input(x: torch.Tensor, name: str, align: int) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the kernel")
    if x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned for the "
                         f"kernel's vector loads")


def quantize(x: torch.Tensor):
    """``x`` f32 ``(N, D)`` -> (int8 ``(N, D)``, f32 scales ``(N, D/128)``)
    on the device of ``x``."""
    _check(x, torch.float32, "x")
    if x.device.type == "cpu":
        return quantize_plain(x)
    _check_kernel_input(x, "x", 16)
    N, D = x.shape
    q = torch.empty((N, D), dtype=torch.int8, device=x.device)
    s = torch.empty((N, D // LANE_GROUP), dtype=torch.float32,
                    device=x.device)
    _build.launch(load_library().repro_quantize_blockwise, x.data_ptr(),
                  q.data_ptr(), s.data_ptr(), s.numel(), device=x.device,
                  name="quantize")
    _bump(quantize, "launches")
    return q, s


quantize.launches = 0


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 ``q`` ``(N, D)`` and f32 scales ``(N, D/128)`` -> f32 ``(N, D)``."""
    _check(q, torch.int8, "q")
    if s.dtype != torch.float32 or tuple(s.shape) != (
            q.shape[0], q.shape[1] // LANE_GROUP):
        raise ValueError(f"scales must be float32 of shape "
                         f"{(q.shape[0], q.shape[1] // LANE_GROUP)}, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if s.device != q.device:
        raise ValueError(f"scales on {s.device}, q on {q.device}")
    if q.device.type == "cpu":
        return dequantize_plain(q, s)
    _check_kernel_input(q, "q", 4)
    _check_kernel_input(s, "scales", 4)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _build.launch(load_library().repro_dequantize_blockwise, q.data_ptr(),
                  s.data_ptr(), out.data_ptr(), s.numel(), device=q.device,
                  name="dequantize")
    _bump(dequantize, "launches")
    return out


dequantize.launches = 0


def quantize_plain(x: torch.Tensor):
    """The quantize kernel's arithmetic in PyTorch (any device)."""
    _bump(quantize_plain, "calls")
    _check(x, torch.float32, "x")
    N, D = x.shape
    xb = x.reshape(N, D // LANE_GROUP, LANE_GROUP)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    scale = torch.maximum(xb.abs().amax(-1) * f32(_INV127), f32(_FLOOR))
    r = torch.round(xb / scale[..., None])
    r = torch.where(torch.isnan(r), f32(0.0), r).clamp(-127.0, 127.0)
    return r.to(torch.int8).reshape(N, D), scale


quantize_plain.calls = 0


def dequantize_plain(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The dequantize kernel's arithmetic in PyTorch (any device)."""
    _bump(dequantize_plain, "calls")
    N, D = q.shape
    qb = q.reshape(N, D // LANE_GROUP, LANE_GROUP).to(torch.float32)
    return (qb * s[..., None]).reshape(N, D)


dequantize_plain.calls = 0
