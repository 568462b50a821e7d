"""Public wrappers around the kernels: layout and padding.

Counterpart of the reference's ``repro/kernels/ops.py`` for the kernels
ported so far.  :func:`quantize_array` and :func:`dequantize_array` take
arrays of any shape to the quantize kernel's ``(rows, D)`` layout and
back, with the reference's padding (``D`` = 512 lanes for arrays of at
least 512 elements, else 128, zero-padded to a whole number of rows), so
the payloads they produce are the reference's, shape for shape.  They run
on the device of their input: the kernel on CUDA, its plain version on
the CPU.
"""
from __future__ import annotations

import torch

from .quant_blockwise import dequantize, quantize


def _pad_of(size: int) -> tuple:
    """(zero elements appended, row width D) for an array of ``size``."""
    D = 512 if size >= 512 else 128
    return (-size) % D, D


def quantize_array(x: torch.Tensor):
    """Quantize an f32 tensor of any shape; returns (int8 2-D payload,
    f32 scales, pad)."""
    pad, D = _pad_of(x.numel())
    flat = x.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    elif flat.data_ptr() % 16:          # the kernel loads float4s
        flat = flat.clone()
    q, s = quantize(flat.reshape(-1, D))
    return q, s, pad


def dequantize_array(q: torch.Tensor, s: torch.Tensor, *, shape, dtype,
                     pad: int) -> torch.Tensor:
    """Inverse layout of :func:`quantize_array`: an array of ``shape`` and
    ``dtype`` (a torch dtype or its name, e.g. ``"float32"``)."""
    flat = dequantize(q, s).reshape(-1)
    if pad:
        flat = flat[:-pad]
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return flat.reshape(tuple(shape)).to(dtype)
