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
  ``rglru_scan.launches`` counts kernel launches.
* :func:`rglru_scan_plain` is the same arithmetic in PyTorch, one step at
  a time (a product, then a sum, each rounded to f32); the kernel, built
  with ``-fmad=false``, is held bitwise against it.  ``.calls`` counts
  its calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_SOURCE = "rglru_scan.cu"
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    fn = lib.repro_rglru_scan
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
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
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not "
                         f"{a.device}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """``h`` of shape ``(B, S, W)`` in ``b``'s dtype."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    return _kernel(a, b, h0)


def _kernel(a, b, h0) -> torch.Tensor:
    """Allocate the output and launch the kernel on the inputs' device."""
    B, S, W = a.shape
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty((B, S, W), dtype=b.dtype, device=b.device)
    _build.launch(load_library().repro_rglru_scan,
                  int(b.dtype == torch.bfloat16), a.data_ptr(), b.data_ptr(),
                  h0.data_ptr(), out.data_ptr(), B, S, W, device=a.device,
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
