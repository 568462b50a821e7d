"""Device resolution shared by every public entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``.  A CUDA request on
a machine without a usable GPU raises instead of quietly running on the
CPU; callers that want the CPU (the tests) ask for it by name.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises for an unavailable GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the host")
    return dev


def as_f64(x, device) -> torch.Tensor:
    """``x`` (scalar, sequence, numpy array or tensor) as an f64 tensor on
    ``device``."""
    return torch.as_tensor(x, dtype=F64, device=resolve_device(device))
