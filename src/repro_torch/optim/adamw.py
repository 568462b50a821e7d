"""AdamW with decoupled weight decay, global-norm clipping and schedules.

Counterpart of the reference's ``repro/optim/adamw.py``: functional over
the models' parameter trees (dicts, tuples; leaves in the reference's
order), the same arithmetic in f32, an f32 master copy when the params are
not f32, the optional Adafactor-style factored second moment and
reduced-precision momentum.  Like the reference it decays every leaf of
two or more dimensions, the stacked (layers, d) norms included.

On DTensor parameters (a sharded train step) the state is DTensors with
each parameter's placements, the step a replicated scalar, the global norm
the norm of the whole gradients, and the elementwise update runs on each
rank's local shard; a factored second moment's means over a split dim are
reduced across it, and its update runs on each rank's shard with the
means laid out along it.  Every new leaf has the placements its old one had.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .._device import resolve_device
from ..ckpt.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..parallel import sharding as shd

F32 = torch.float32
#: elements of a leaf updated at once: a larger leaf (recurrentgemma-9b's
#: 4 GB embedding and head) is updated in slices of this many, each
#: elementwise step rounding as on the whole leaf, so that its update
#: holds a few slice-sized temporaries beside its results, not five
#: leaf-sized ones.
UPDATE_CHUNK = 2 ** 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # at-scale memory options
    factored_second_moment: bool = False   # Adafactor-style row/col v (>=2D)
    momentum_dtype: str = "float32"        # "bfloat16" halves m
    master_weights: bool = True            # f32 master when params are bf16


class FactoredV(NamedTuple):
    """Adafactor-style factored second moment for a >=2D tensor: row/col
    means over the trailing two axes (leading stack axes kept)."""
    row: torch.Tensor    # shape[:-1]           (mean over last axis)
    col: torch.Tensor    # shape[:-2] + last    (mean over second-to-last)


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: object            # tree like params (momentum_dtype)
    v: object            # tree: f32 like params, or FactoredV
    master: object       # f32 master weights when params are not f32


def _wants_factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def _is_v_leaf(x) -> bool:
    return isinstance(x, FactoredV)


def init_state(params, cfg: AdamWConfig = None, device="cuda") -> AdamWState:
    """Zero moments on ``device`` (and the f32 master copy when a param is
    not f32).  For DTensor params (which carry their device) each state
    leaf is a DTensor with its param's placements (a factored v's row and
    col with those of the dims they keep) and the step a replicated
    one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    cfg = cfg or AdamWConfig()
    leaves = tree_leaves(params)
    like = next((x for x in leaves if isinstance(x, DTensor)), None)
    dev = resolve_device(device) if like is None else like.device
    mdt = getattr(torch, cfg.momentum_dtype)
    zeros = lambda shape, dt: torch.zeros(tuple(shape), dtype=dt, device=dev)

    def zeros_of(p, dt, drop: int = None):
        """Zeros shaped as p (without dim ``drop``), p's sharding kept on
        the other dims."""
        shape = list(p.shape)
        if drop is not None:
            del shape[drop]
        if not isinstance(p, DTensor):
            return zeros(shape, dt)
        drop = None if drop is None else drop % p.ndim
        pl = [Replicate() if isinstance(q, Shard) and q.dim == drop
              else Shard(q.dim - 1) if (isinstance(q, Shard) and drop
                                        is not None and q.dim > drop)
              else q for q in p.placements]
        from torch.distributed.tensor import zeros as dzeros
        return dzeros(tuple(shape), dtype=dt, device_mesh=p.device_mesh,
                      placements=pl)
    m = tree_map(lambda p: zeros_of(p, mdt), params)

    def mk_v(p):
        if cfg.factored_second_moment and _wants_factored(p.shape):
            return FactoredV(row=zeros_of(p, F32, -1),
                             col=zeros_of(p, F32, -2))
        return zeros_of(p, F32)
    v = tree_map(mk_v, params)
    needs_master = cfg.master_weights and any(
        x.dtype != F32 for x in leaves)
    master = (tree_map(lambda p: p.to(dtype=F32).clone() if isinstance(
        p, DTensor) else p.to(device=dev, dtype=F32).clone(), params)
        if needs_master else None)
    return AdamWState(step=shd.replicated(zeros((), torch.int32), like),
                      m=m, v=v, master=master)


def state_spec(param_spec_tree, cfg: AdamWConfig = None):
    """ParamSpec tree for the optimizer state (mirrors the parameters')."""
    from ..models.spec import ParamSpec
    cfg = cfg or AdamWConfig()

    def clone(s, dtype="float32"):
        return ParamSpec(s.shape, s.logical, dtype, init="zeros")
    m = tree_map(lambda s: clone(s, cfg.momentum_dtype), param_spec_tree)

    def mk_v(s):
        if cfg.factored_second_moment and _wants_factored(s.shape):
            return FactoredV(
                row=ParamSpec(s.shape[:-1], s.logical[:-1], "float32",
                              init="zeros"),
                col=ParamSpec(s.shape[:-2] + s.shape[-1:],
                              s.logical[:-2] + s.logical[-1:], "float32",
                              init="zeros"))
        return clone(s)
    v = tree_map(mk_v, param_spec_tree)
    needs_master = cfg.master_weights and any(
        s.dtype != "float32" for s in tree_leaves(param_spec_tree))
    master = tree_map(clone, param_spec_tree) if needs_master else None
    return AdamWState(step=ParamSpec((), (), "int32", init="zeros"), m=m,
                      v=v, master=master)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (f32)."""
    s = step.to(F32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """The f32 norm of all leaves; of DTensor leaves, the norm of the
    whole tensors (each leaf's partial sums reduced to a replicated
    scalar)."""
    leaves = [shd.replicate(x.to(F32).square().sum()) for x in
              tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step.  Returns (new_params, new_state, metrics).

    Global-norm clipping is folded into the per-leaf update as a scalar
    multiply (no whole-tree clipped-gradient copy)."""
    gnorm = global_norm(grads)
    clip_scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                                 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(F32))
    bc2 = 1.0 - torch.pow(b2, step.to(F32))
    # the scalars as plain tensors: a replicated DTensor's local value
    clip_scale, lr_, bc1, bc2 = (shd.local(x) for x in (clip_scale, lr,
                                                        bc1, bc2))

    def one(decay: bool, g, m, v, w):
        """(w_new, m_new, v_new) in f32 for an unfactored leaf; w = the f32
        master (or the f32 param itself)."""
        gf = g.to(F32) * clip_scale
        m_new = b1 * m.to(F32) + (1 - b1) * gf
        v_new = b2 * v.to(F32) + (1 - b2) * gf * gf
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if decay:   # decay matrices only (1-D norms/biases exempt)
            delta = delta + cfg.weight_decay * w
        return w - lr_ * delta, m_new, v_new

    def upd(p, g, m, v, w):
        if isinstance(v, FactoredV):
            return upd_factored(p, g, m, v, w)
        # elementwise: on each rank's shard, every operand in p's placements
        g, m_, v_, w_ = (shd.local(shd.like_placements(t, p))
                         for t in (g, m, v, w))
        out = upd_local(p.ndim >= 2, p.dtype, g, m_, v_, w_)
        return tuple(shd.from_local(t, ref) for t, ref in
                     zip(out, (p, m, v, w)))

    def upd_factored(p, g, m, v, w):
        """The update of a leaf with an Adafactor-style factored second
        moment: V ~ row x col / mean(row).  On DTensors the row and column
        means are reduced across the shards and the rest runs on each
        rank's shard in p's placements, the means laid out along its rows
        and columns (a rank-1 reconstruction on DTensors would hold the
        whole leaf on every rank)."""
        from torch.distributed.tensor import Replicate, Shard
        nd = p.ndim
        gf = shd.like_placements(g, p).to(F32) * clip_scale
        g2 = gf * gf
        row_new = b2 * v.row + (1 - b2) * g2.mean(-1)
        col_new = b2 * v.col + (1 - b2) * g2.mean(-2)
        denom = torch.clamp_min(row_new.mean(-1, keepdim=True), 1e-30)

        def lay(x, dropped, moved=None):
            """x's local tensor, split as p is along the dims x keeps:
            replicated where p's split dim is one of ``dropped``, split
            along x's dim ``moved[d]`` where it is p's dim d; a plain x as
            it is."""
            if not shd.is_dtensor(p):
                return x
            pl = [Replicate() if isinstance(q, Shard) and q.dim in dropped
                  else Shard((moved or {}).get(q.dim, q.dim))
                  if isinstance(q, Shard) else Replicate()
                  for q in p.placements]
            return x.redistribute(p.device_mesh, pl).to_local()
        row = lay(row_new, (nd - 1,))
        col = lay(col_new, (nd - 2,), {nd - 1: nd - 2})
        den = lay(denom, (nd - 2, nd - 1))
        gl, ml, wl = (shd.local(shd.like_placements(t, p))
                      for t in (gf, m, w))
        m_new = b1 * ml.to(F32) + (1 - b1) * gl
        vh = (row[..., None] * col[..., None, :] / den[..., None]) / bc2
        # a factored leaf has two dims or more: it decays
        delta = (m_new / bc1) / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * wl
        w_new = wl - lr_ * delta
        return (shd.from_local(w_new.to(p.dtype), p),
                shd.from_local(m_new.to(m.dtype), m),
                FactoredV(row=shd.like_placements(row_new, v.row),
                          col=shd.like_placements(col_new, v.col)),
                shd.from_local(w_new, w))

    def upd_local(decay: bool, dtype, g, m, v, w):
        if w.numel() <= UPDATE_CHUNK:
            w_new, m_new, v_new = one(decay, g, m, v, w)
        else:
            w_new, m_new, v_new = (torch.empty(w.shape, dtype=F32,
                                               device=w.device)
                                   for _ in range(3))
            ins = [t.reshape(-1) for t in (g, m, v, w)]
            outs = [t.view(-1) for t in (w_new, m_new, v_new)]
            for i in range(0, w.numel(), UPDATE_CHUNK):
                part = [t[i:i + UPDATE_CHUNK] for t in ins]
                for out, x in zip(outs, one(decay, *part)):
                    out[i:i + UPDATE_CHUNK] = x
        return w_new.to(dtype), m_new.to(m.dtype), v_new, w_new

    flat_p, treedef = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state.m)
    flat_v = tree_leaves(state.v, _is_v_leaf)
    has_master = state.master is not None
    flat_w = (tree_leaves(state.master) if has_master
              else [p.to(F32) for p in flat_p])
    out = [upd(p, g, m, v, w) for p, g, m, v, w in
           zip(flat_p, flat_g, flat_m, flat_v, flat_w)]
    new_p = tree_unflatten(treedef, [o[0] for o in out])
    new_m = tree_unflatten(treedef, [o[1] for o in out])
    new_v = tree_unflatten(treedef, [o[2] for o in out])
    new_master = (tree_unflatten(treedef, [o[3] for o in out])
                  if has_master else None)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step=step, m=new_m, v=new_v,
                             master=new_master), metrics
