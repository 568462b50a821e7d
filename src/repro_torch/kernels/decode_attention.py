"""Flash-decoding: one query token against a KV cache.  CUDA wrapper and
plain PyTorch version.

Replaces the reference's Pallas kernel
``repro/kernels/decode_attention.py::_decode_kernel`` (oracle
``repro/kernels/ref.py::decode_ref``).  ``q1``: ``(BH, 1, Dh)``; cache
``k``, ``v``: ``(BH, S, Dh)``; ``length``: the number of valid cache
slots (slots at or past it are masked; ring buffers are resolved by the
caller).  f32 math, q scaled by ``float32(Dh ** -0.5)``, the sum of
weights floored at 1e-30, so ``length = 0`` gives zeros.  Output
``(BH, 1, Dh)`` in ``q1``'s dtype.

* :func:`decode_attention` is the wrapper.  For CUDA tensors it launches
  the kernel of ``repro_torch/csrc/decode_attention.cu`` on the current
  stream, or raises; for CPU tensors it runs
  :func:`decode_attention_plain`.  ``decode_attention.launches`` counts
  kernel launches.
* :func:`decode_attention_plain` computes the same function with the
  scores materialized.  The kernel is held to it within 1e-4 in f32 (the
  reference's tolerance) and 4e-3 + 1e-2 relative in bf16 (one rounding
  of the output apart): its sums run in another order.  ``.calls``
  counts its calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG_INF = -1.0e30
DTYPES = (torch.float32, torch.bfloat16)
#: head widths the kernel is compiled for.
HEAD_DIMS = (64, 128, 256)

_SOURCE = "decode_attention.cu"


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    fn = lib.repro_decode_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q1, k, v) -> None:
    if k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"k and v must both be (BH, S, Dh), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    BH, _, Dh = k.shape
    if q1.shape != (BH, 1, Dh):
        raise ValueError(f"q1 must be {(BH, 1, Dh)}, got {tuple(q1.shape)}")
    if q1.dtype not in DTYPES or not (q1.dtype == k.dtype == v.dtype):
        raise TypeError(f"q1, k, v must share a dtype among {DTYPES}")
    if not (q1.device == k.device == v.device):
        raise ValueError("q1, k and v must lie on one device")
    if q1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, "
                         f"not {q1.device}")


def decode_attention(q1: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length) -> torch.Tensor:
    """Attention of ``q1`` over the first ``length`` slots of the cache
    (``length``: an int or a 0-d integer tensor)."""
    _check(q1, k, v)
    length = int(length)
    if q1.device.type == "cpu":
        return decode_attention_plain(q1, k, v, length)
    return _kernel(q1, k, v, length)


def _kernel(q1, k, v, length: int) -> torch.Tensor:
    """Allocate the output and launch the kernel on the inputs' device."""
    BH, S, Dh = k.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes Dh in {HEAD_DIMS}, got {Dh}")
    q1, k, v = (_build.aligned(x) for x in (q1, k, v))
    out = torch.empty_like(q1)
    _build.launch(load_library().repro_decode_attention,
                  int(q1.dtype == torch.bfloat16), q1.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, Dh,
                  min(max(length, 0), S), Dh ** -0.5, device=q1.device,
                  name="decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_plain(q1: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length) -> torch.Tensor:
    """The kernel's function in PyTorch (any device), scores materialized."""
    decode_attention_plain.calls += 1
    _check(q1, k, v)
    f32 = torch.float32
    Dh = k.shape[2]
    scale = torch.tensor(Dh ** -0.5, dtype=f32).to(q1.device)
    s = torch.matmul(q1.to(f32) * scale, k.to(f32).transpose(1, 2))
    allow = torch.arange(k.shape[1], device=k.device) < int(length)
    s = torch.where(allow, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(allow, torch.exp(s - m), 0.0)
    l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    return (torch.matmul(p, v.to(f32)) / l).to(q1.dtype)


decode_attention_plain.calls = 0
