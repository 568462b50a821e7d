"""Carry the reference package's state into the port.

This system's counterpart of carrying a model's weights across: the
reference's parameter grids, parameter dataclasses (single-level and
multilevel), failure schedules, state trees, advisor requests, a
model's initialised parameters and AdamW state (the weights themselves,
here), and a prefill's decode cache become the port's tensors and
dataclasses.  Everything here works by duck typing on plain mappings,
arrays and containers, so the port never imports the reference package.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ._device import F64, resolve_device
from .ckpt.tree import tree_flatten, tree_map, tree_unflatten
from .core.params import (CheckpointParams, MultilevelCheckpointParams,
                          MultilevelPowerParams, PowerParams)
from .serve.schema import AdviceRequest, StoreTier
from .sim.scenarios import _ML_FIELDS, MultilevelParamGrid, ParamGrid


def grid_from_fields(fields: Mapping[str, np.ndarray],
                     device="cuda") -> ParamGrid:
    """A :class:`ParamGrid` on ``device`` from a mapping of the nine field
    arrays (what the reference's ``ParamGrid.fields()`` returns)."""
    dev = resolve_device(device)
    return ParamGrid(**{f: torch.as_tensor(np.asarray(fields[f],
                                                      dtype=np.float64),
                                           dtype=F64, device=dev)
                        for f in ("C", "R", "D", "mu", "omega", "P_static",
                                  "P_cal", "P_io", "P_down")})


def ml_grid_from_fields(fields: Mapping[str, np.ndarray],
                        device="cuda") -> MultilevelParamGrid:
    """A :class:`MultilevelParamGrid` on ``device`` from a mapping of the
    sixteen field arrays (what the reference's
    ``MultilevelParamGrid.fields()`` returns)."""
    dev = resolve_device(device)
    return MultilevelParamGrid(**{
        f: torch.as_tensor(np.asarray(fields[f], dtype=np.float64),
                           dtype=F64, device=dev) for f in _ML_FIELDS})


def ckpt_from_fields(fields: Mapping[str, float]) -> CheckpointParams:
    """:class:`CheckpointParams` from ``dataclasses.asdict`` of the
    reference's checkpoint parameters."""
    return CheckpointParams(**{k: float(fields[k])
                               for k in ("C", "R", "D", "mu", "omega")})


def power_from_fields(fields: Mapping[str, float]) -> PowerParams:
    """:class:`PowerParams` from ``dataclasses.asdict`` of the reference's
    power parameters."""
    return PowerParams(**{k: float(fields[k])
                          for k in ("P_static", "P_cal", "P_io", "P_down")})


def schedule_to_device(gaps, device="cuda",
                       dtype: torch.dtype = F64) -> torch.Tensor:
    """A host failure schedule (numpy, any shape) as a contiguous tensor
    of ``dtype`` on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(gaps, dtype=np.float64),
                           device=resolve_device(device)).to(dtype)


def ml_ckpt_from_fields(fields: Mapping[str, Any]
                        ) -> MultilevelCheckpointParams:
    """:class:`MultilevelCheckpointParams` from ``dataclasses.asdict`` of
    the reference's multilevel checkpoint parameters."""
    opt = lambda v: None if v is None else float(v)
    return MultilevelCheckpointParams(
        **{k: float(fields[k]) for k in ("C1", "R1", "C2", "R2", "D1", "D2",
                                         "mu", "q", "omega")},
        omega1=opt(fields.get("omega1")), omega2=opt(fields.get("omega2")))


def ml_power_from_fields(fields: Mapping[str, float]
                         ) -> MultilevelPowerParams:
    """:class:`MultilevelPowerParams` from ``dataclasses.asdict`` of the
    reference's multilevel power parameters."""
    return MultilevelPowerParams(
        **{k: float(fields[k]) for k in ("P_static", "P_cal", "P_io1",
                                         "P_io2", "P_down")})


def tensor_from_array(a, device="cuda", dtype=None) -> torch.Tensor:
    """A fresh tensor on ``device`` holding the array ``a`` (numpy, or
    anything ``np.asarray`` takes).  A bfloat16 array (``ml_dtypes``'
    type, which JAX hands over and ``torch.from_numpy`` refuses; known by
    its dtype's name) is carried bit for bit through a 16-bit view.
    ``dtype``, if given, converts after the transfer."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(resolve_device(device))
    return t if dtype is None else t.to(dtype)


def array_from_tensor(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host.  A bfloat16 tensor comes back
    bit for bit as numpy's ``bfloat16`` dtype, which exists once
    ``ml_dtypes`` (or JAX) has registered it; without it this raises."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError("numpy has no bfloat16 dtype registered (import "
                        "ml_dtypes or jax first)") from None
    return t.contiguous().view(torch.int16).numpy().view(bf16)


def state_from_numpy(tree: Any, device="cuda") -> Any:
    """A state tree with numpy leaves (what the reference's
    ``jax.device_get`` returns: dicts, tuples, namedtuples, None) as the
    same structure of fresh tensors on ``device``.  Its leaves flatten in
    the reference's order (:mod:`repro_torch.ckpt.tree`)."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=dev), tree)


def advice_request_from_fields(fields: Mapping[str, Any]) -> AdviceRequest:
    """The port's :class:`~repro_torch.serve.schema.AdviceRequest` from
    ``dataclasses.asdict`` of the reference's (its tiers a sequence of
    mappings); the port's own validation runs on it."""
    f = dict(fields)
    f["tiers"] = tuple(StoreTier(**dict(t)) for t in f["tiers"])
    return AdviceRequest(**f)


def params_from_numpy(tree: Any, cfg, device="cuda") -> Any:
    """The reference's model parameters (``jax.device_get`` of its
    ``Model.init``: numpy leaves, dicts, the ``stages`` tuple of stacked
    dicts) as the port's parameter tree on ``device``.  Every leaf is held
    against the port's ``model_spec(cfg)``: the same structure, shapes and
    dtypes, or this raises."""
    from .models.spec import torch_dtype
    from .models.transformer import model_spec
    dev = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    specs, spec_def = tree_flatten(model_spec(cfg))
    if treedef != spec_def:
        raise ValueError(f"the tree is not {cfg.name}'s parameter tree: "
                         f"{treedef} against {spec_def}")
    out = []
    for x, s in zip(leaves, specs):
        t = tensor_from_array(x, dev)
        if tuple(t.shape) != tuple(s.shape) or t.dtype != torch_dtype(
                s.dtype):
            raise ValueError(f"a leaf of {tuple(t.shape)} {t.dtype} where "
                             f"{cfg.name} has {s.shape} {s.dtype}")
        out.append(t)
    return tree_unflatten(treedef, out)


def opt_state_from_numpy(state: Any, device="cuda"):
    """The reference's ``AdamWState`` (numpy leaves; ``v`` leaves may be
    its ``FactoredV``; ``master`` may be None) as the port's
    :class:`~repro_torch.optim.adamw.AdamWState` on ``device``."""
    from .optim.adamw import AdamWState, FactoredV
    dev = resolve_device(device)

    def conv(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple) and getattr(node, "_fields", None) == (
                "row", "col"):
            return FactoredV(row=conv(node.row), col=conv(node.col))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return tensor_from_array(node, dev)
    return AdamWState(step=tensor_from_array(state.step, dev,
                                             torch.int32),
                      m=conv(state.m), v=conv(state.v),
                      master=conv(state.master))


def cache_from_numpy(tree: Any, cfg, device="cuda") -> Any:
    """The reference's decode cache (``jax.device_get`` of its prefill's
    cache: numpy leaves, int8 payloads and bfloat16 scales included, its
    state namedtuples) as the port's, ready for ``decode_step``: the
    K/V and state leaves on ``device``, ``pos`` and ``slot_pos`` (the
    leaves without a batch axis) on the host, as the port keeps them.
    The tree is held against the port's ``cache_spec(cfg, ...)``: the same
    structure and dtypes, or this raises."""
    from .models.spec import torch_dtype
    from .models.transformer import cache_spec
    dev = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    specs, spec_def = tree_flatten(cache_spec(cfg, 1, 1))
    if str(treedef) != str(spec_def):
        raise ValueError(f"the tree is not {cfg.name}'s decode cache: "
                         f"{treedef} against {spec_def}")
    out = []
    for x, s in zip(leaves, specs):
        t = tensor_from_array(x, dev if "batch" in s.logical else "cpu")
        if t.dtype != torch_dtype(s.dtype) or t.ndim != len(s.shape):
            raise ValueError(f"a leaf of {tuple(t.shape)} {t.dtype} where "
                             f"{cfg.name}'s cache has {s.dtype} of rank "
                             f"{len(s.shape)}")
        out.append(t)
    return tree_unflatten(spec_def, out)
