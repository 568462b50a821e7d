"""Parameter specification trees: shapes + logical axes + init.

Counterpart of the reference's ``repro/models/spec.py``.  Every model
declares its parameters as a tree of :class:`ParamSpec` (dicts, tuples and
namedtuples, flattened in the reference's order by
:mod:`repro_torch.ckpt.tree`); from it come materialised parameters
(:func:`init_tree`), exact parameter counts (:func:`tree_size`) and, on a
device mesh (``launch/mesh.py``), stand-ins that allocate nothing
(:func:`abstract_tree`: meta tensors, or meta DTensors carrying the
mesh's placements) and the shardings (:func:`shardings_tree`,
:func:`pspecs_tree`).  The logical axis names are kept as the reference
declares them, so the trees compare leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..ckpt.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple                  # logical axis name (or None) per dim
    dtype: str = "float32"
    init: str = "fan_in"            # fan_in | zeros | ones | normal | lambda_lru
    fan_axis: int = -2              # which axis is fan-in for scaled init

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in length")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_size(spec_tree) -> int:
    return sum(s.size for s in tree_leaves(spec_tree) if is_spec(s))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name (``"float32"``, ``"bfloat16"``,
    ``"int8"``, ...)."""
    return getattr(torch, name)


def abstract_tree(spec_tree, mesh=None, rules=None):
    """Stand-ins of every leaf that take no memory: a meta tensor of the
    global shape and dtype, or, on ``mesh`` (a DeviceMesh), a meta
    ``DTensor`` with the resolved placements, whose ``to_local()`` has the
    local shard's shape."""
    def mk(s: ParamSpec):
        dt = torch_dtype(s.dtype)
        if mesh is None:
            return torch.empty(s.shape, dtype=dt, device="meta")
        from torch.distributed.tensor import DTensor
        sh = shd.named_sharding(s.logical, mesh, rules, s.shape)
        local = torch.empty(sh.shard_shape(s.shape), dtype=dt, device="meta")
        # resolution keeps only axes that divide a dim, so the shards are
        # even and the global shape follows from the local one
        return DTensor.from_local(local, mesh, sh.placements, run_check=False)
    return tree_map(mk, spec_tree)


def shardings_tree(spec_tree, mesh, rules=None):
    return tree_map(
        lambda s: shd.named_sharding(s.logical, mesh, rules, s.shape),
        spec_tree)


def pspecs_tree(spec_tree, mesh, rules=None):
    return tree_map(
        lambda s: shd.resolve_pspec(s.logical, mesh, rules, s.shape),
        spec_tree)


def _init_leaf(gen: torch.Generator, s: ParamSpec, dev) -> torch.Tensor:
    dt = torch_dtype(s.dtype)
    kw = dict(dtype=torch.float32, device=dev, generator=gen)
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=dev)
    if s.init == "lambda_lru":
        # RG-LRU Lambda parametrisation: a = sigmoid(L)^(c r); init so the
        # decay a^c is in [0.9, 0.999] (RecurrentGemma appendix).
        u = 0.9 + (0.999 - 0.9) * torch.rand(s.shape, **kw)
        c = 8.0
        return torch.log(torch.expm1(-torch.log(u) / c)).to(dt)
    if s.init == "normal":
        return (0.02 * torch.randn(s.shape, **kw)).to(dt)
    # fan-in scaled normal truncated to [-2, 2]
    fan = s.shape[s.fan_axis] if s.shape else 1
    w = torch.empty(s.shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(max(fan, 1))).to(dt)


def init_tree(spec_tree, generator: torch.Generator, device="cuda"):
    """Materialise parameters on ``device``, leaf by leaf in the reference's
    order, every draw from ``generator`` (which must live on ``device``'s
    type).  The rules per leaf are the reference's; the draws are not its
    (a ``jax.random`` key's), so they agree in distribution only."""
    dev = resolve_device(device)
    leaves, treedef = tree_flatten(spec_tree)
    return tree_unflatten(treedef, [_init_leaf(generator, s, dev)
                                    for s in leaves])
