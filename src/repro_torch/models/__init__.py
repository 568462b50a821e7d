"""Model zoo public API.

Counterpart of the reference's ``repro/models/__init__.py``: ``Model``
bundles an :class:`~repro_torch.configs.ArchConfig` with its parameter
tree, init, loss, forward and an AdamW train step.  Parameters are plain
trees of tensors (dicts and tuples, leaves in the reference's order);
gradients come from ``torch.autograd``.  ``prefill`` (in waves) and
``decode_step`` serve all ten archs; ``input_specs`` gives the stand-ins
of a workload shape's inputs (with their shardings on a device mesh).

The train step also runs sharded: with parameters, optimizer state and a
batch that are DTensors (``parallel/sharding.py::place_tree``) under an
active mesh, each microbatch takes the reference's global rows (laid out
over the batch axes again), the gradients come back in their parameters'
placements (the data-parallel sums reduced there) and the loss is a
replicated scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ckpt.tree import tree_flatten, tree_unflatten
from ..configs.base import ArchConfig, ShapeConfig
from ..optim import adamw
from ..parallel import sharding as shd
from . import transformer as tfm
from .spec import (ParamSpec, abstract_tree, init_tree, is_spec,
                   shardings_tree, torch_dtype, tree_size)

__all__ = ["Model", "build", "batch_spec", "decode_input_spec",
           "input_specs", "ParamSpec", "abstract_tree", "init_tree",
           "is_spec", "shardings_tree", "tree_size"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- parameters --------------------------------------------------------
    def param_spec(self):
        return tfm.model_spec(self.cfg)

    def init(self, generator: torch.Generator, device="cuda"):
        """Parameters on ``device``, drawn from ``generator`` (a
        ``torch.Generator`` on that device's type)."""
        return init_tree(self.param_spec(), generator, device)

    def param_count(self) -> int:
        return tree_size(self.param_spec())

    # ---- pure model fns ----------------------------------------------------
    def loss(self, params, batch):
        return tfm.loss_fn(self.cfg, params, batch)

    def forward(self, params, tokens, **kw):
        return tfm.forward(self.cfg, params, tokens, **kw)

    def prefill(self, params, batch, max_cache_seq: Optional[int] = None):
        """Serving prefill: (logits (B, 1, V), cache).  With
        ``cfg.prefill_waves > 1`` (dividing the batch) the request batch is
        processed in sequential waves, which bounds live activation memory;
        each cache leaf is then merged along the axis its ``cache_spec``
        names ``batch``, and a leaf without one (``pos``, ``slot_pos``)
        takes the first wave's."""
        waves = max(1, getattr(self.cfg, "prefill_waves", 1))
        B = batch["tokens"].shape[0]
        if B % waves:
            waves = 1
        bw = B // waves
        outs = []
        for w in range(waves):
            wb = batch if waves == 1 else {
                k: (None if x is None else x[w * bw:(w + 1) * bw])
                for k, x in batch.items()}
            outs.append(tfm.forward(self.cfg, params, wb["tokens"],
                                    prefix=wb.get("prefix"),
                                    frames=wb.get("frames"),
                                    collect_cache=True,
                                    max_cache_seq=max_cache_seq))
        spec = tfm.cache_spec(self.cfg, bw, max_cache_seq
                              or batch["tokens"].shape[1])
        specs, _ = tree_flatten(spec)
        flat = [tree_flatten(cache) for _, cache in outs]
        merged = []
        for s, parts in zip(specs, zip(*(leaves for leaves, _ in flat))):
            if len(parts) == 1 or "batch" not in s.logical:
                merged.append(parts[0])
            else:
                merged.append(torch.cat(parts, dim=s.logical.index("batch")))
        logits = torch.cat([lg for lg, _ in outs], dim=0)
        return logits, tree_unflatten(flat[0][1], merged)

    def decode_step(self, params, cache, token):
        return tfm.decode_step(self.cfg, params, cache, token)

    def cache_spec(self, batch: int, max_seq: int):
        return tfm.cache_spec(self.cfg, batch, max_seq)

    # ---- training step (with AdamW) ----------------------------------------
    def make_train_step(self, opt_cfg: adamw.AdamWConfig,
                        microbatches: int = 1,
                        accum_dtype: str = "float32"):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        metrics)``.  With ``microbatches = k`` the batch's rows are split
        into k sequential micro-steps whose gradients are summed in
        ``accum_dtype`` and divided by k (the reference's accumulation);
        the loss is the micro-steps' mean."""
        cfg = self.cfg
        k = microbatches
        adt = torch_dtype(accum_dtype)

        def train_step(params, opt_state, batch):
            if k == 1:
                loss, grads, td = value_and_grad(cfg, params, batch)
            else:
                parts = {key: _microbatches(x, k)
                         for key, x in batch.items()}
                mbs = [{key: p[i] for key, p in parts.items()}
                       for i in range(k)]
                acc, losses = None, []
                for mb in mbs:
                    l, g, td = value_and_grad(cfg, params, mb)
                    g = [gi.to(adt) for gi in g]
                    acc = g if acc is None else [a + gi for a, gi in
                                                 zip(acc, g)]
                    losses.append(l)
                # stay in the accumulation dtype; the optimizer casts per
                # leaf
                grads = [a / k for a in acc]
                loss = torch.stack(losses).mean()
            new_params, new_state, metrics = adamw.apply_updates(
                opt_cfg, params, tree_unflatten(td, list(grads)), opt_state)
            return new_params, new_state, dict(metrics, loss=loss)

        return train_step


def value_and_grad(cfg: ArchConfig, params, batch):
    """``(loss, grads, treedef)`` of the mean next-token loss: the grads a
    flat list in the parameters' leaf order, each in its parameter's
    placements when the parameters are DTensors (where a parameter is
    replicated, its gradient's partial sums are reduced there), and the
    loss a replicated scalar then."""
    leaves, td = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = tfm.loss_fn(cfg, tree_unflatten(td, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    grads = [shd.like_placements(g, p) for g, p in zip(grads, leaves)]
    return shd.replicate(loss.detach()), grads, td


def _microbatches(x, k: int) -> list:
    """The ``k`` microbatches of a batch leaf, as the reference splits it:
    microbatch ``i`` holds global rows ``[i B/k, (i+1) B/k)``.  Of a
    batch-sharded DTensor, the rows are gathered once (a few MB of ints)
    and each microbatch is laid out as the leaf was, its rows split over
    the same mesh axes where they divide them (else replicated there)."""
    B = x.shape[0]
    if B % k:
        raise ValueError(f"a batch of {B} rows does not split into {k} "
                         f"microbatches")
    if not shd.is_dtensor(x):
        return list(x.chunk(k, dim=0))
    from torch.distributed.tensor import DTensor, Replicate
    mesh, rows = x.device_mesh, B // k
    split = [d for d, p in enumerate(x.placements) if p.is_shard(0)]
    keep = rows % math.prod(mesh.size(d) for d in split) == 0
    pl = tuple(Replicate() if p.is_shard(0) and not keep else p
               for p in x.placements)
    whole = shd.replicate(x).to_local()
    return [DTensor.from_local(part, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False).redistribute(mesh, pl)
            for part in whole.chunk(k, dim=0)]


def build(cfg: ArchConfig) -> Model:
    return Model(cfg)


def batch_spec(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """ParamSpec tree for one data batch of the given workload shape."""
    B, S = shape.global_batch, shape.seq_len
    out = {
        "tokens": ParamSpec((B, S), ("batch", "seq_sp" if B == 1 else "seq"),
                            "int32"),
        "labels": ParamSpec((B, S), ("batch", "seq_sp" if B == 1 else "seq"),
                            "int32"),
    }
    if cfg.n_prefix_tokens:
        out["prefix"] = ParamSpec((B, cfg.n_prefix_tokens, cfg.d_model),
                                  ("batch", None, "act_embed"), "float32")
    if cfg.is_encoder_decoder:
        out["frames"] = ParamSpec((B, cfg.encoder_seq, cfg.d_model),
                                  ("batch", None, "act_embed"), "float32")
    return out


def decode_input_spec(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """ParamSpec tree of one decode step's input token (B, 1)."""
    B = shape.global_batch
    out = {"token": ParamSpec((B, 1), ("batch", None), "int32")}
    if B == 1:
        out["token"] = ParamSpec((B, 1), (None, None), "int32")
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None, rules=None):
    """Stand-ins (meta tensors, or meta DTensors on ``mesh``) of one
    workload shape's inputs: the batch of a train or prefill shape, the
    cache and the token of a decode shape."""
    if shape.kind in ("train", "prefill"):
        spec = batch_spec(cfg, shape)
    else:
        spec = {
            "cache": tfm.cache_spec(cfg, shape.global_batch, shape.seq_len),
            **decode_input_spec(cfg, shape),
        }
    return abstract_tree(spec, mesh, rules)
