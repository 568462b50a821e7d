"""Production mesh definitions on ``torch.distributed`` device meshes.

Counterpart of the reference's ``repro/launch/mesh.py``.  Every mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the first ranks
of the default process group, which the caller initialises: one rank a
GPU for a real run, or the ``fake`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``) for a world
of 256 or 512 ranks in one process, the counterpart of the reference's
``--xla_force_host_platform_device_count`` (the tests do this; this
module never imports ``torch.testing``).  Building a mesh touches no
device state beyond the group's.

Meshes default to ``device="cuda"`` and raise without a GPU; the tests
pass ``device="cpu"``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .._device import resolve_device
from ..kernels.cost import PEAKS


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(n_devices: Optional[int] = None, *,
                   multi_pod: bool = False, device="cuda"):
    """A small mesh over ``n_devices`` ranks (default: the default group's
    world size)."""
    n = n_devices or _world_size()
    if multi_pod:
        if n % 2:
            raise ValueError(f"a multi-pod mesh needs an even rank count, "
                             f"got {n}")
        per_pod = n // 2
        d = _best_split(per_pod)
        return _mesh((2, d, per_pod // d), ("pod", "data", "model"), device)
    d = _best_split(n)
    return _mesh((d, n // d), ("data", "model"), device)


def _best_split(n: int) -> int:
    r = int(math.sqrt(n))
    while n % r:
        r -= 1
    return r


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def _mesh(shape, axes, device="cuda"):
    """A DeviceMesh of ``shape`` named ``axes`` over ranks 0..prod-1 of the
    default group, on ``device``'s type."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    need = math.prod(shape)
    have = _world_size()
    if have < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} ranks; the default process "
            f"group has a world size of {have}.  Initialise one first "
            f"(torch.distributed.init_process_group); for more ranks than "
            f"the machine has GPUs, use the 'fake' backend "
            f"(torch.testing._internal.distributed.fake_pg.FakeStore).")
    return DeviceMesh(dev.type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


#: One NVIDIA H100 SXM5 80 GB, per card, read from
#: ``kernels/cost.py::PEAKS["SXM"]``.  ``name`` and ``power_limit_w`` are
#: what ``nvidia-smi --query-gpu=name,power.limit`` reads on the card these
#: numbers stand for; ``hbm_bytes`` is
#: ``torch.cuda.get_device_properties(0).total_memory`` there.  The peak
#: bf16 rate (dense, no sparsity), the HBM3 bandwidth and the NVLink
#: bandwidth (fourth-generation NVLink, both directions summed) are from
#: NVIDIA's H100 Tensor Core GPU data sheet, at the 700 W limit.
H100 = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_bf16_flops": PEAKS["SXM"].bf16,           # FLOP/s
    "hbm_bandwidth": PEAKS["SXM"].hbm_bw,           # B/s
    "nvlink_bandwidth": PEAKS["SXM"].nvlink_bw,     # B/s per GPU
    "hbm_bytes": PEAKS["SXM"].hbm_bytes,            # B (79.18 GiB)
}
