"""Mixture-of-Experts FFN (counterpart of the reference's
``repro/models/moe.py``).

Two implementations (``cfg.moe_impl``), as the reference's:

* ``dense`` -- every expert processes every token; the top-k combine
  weights zero out the experts not selected.  The reference's scan over
  1024-token chunks (which bounds the (E, B, Sc, d_ff) transient) is a
  Python loop here.
* ``capacity`` -- GShard-style fixed capacity with groups = batch rows:
  each expert takes at most C = S * top_k / E * capacity_factor tokens of
  a row, picked by combine weight; over-capacity tokens are dropped,
  under-capacity slots carry weight 0.

The router computes in f32.  Ties break as ``jax.lax.top_k`` breaks them,
lowest index first (:func:`_top`): a stable descending sort, then the
first k.  ``torch.topk`` orders ties otherwise, and ties decide real
outcomes: with top-1 every selected token's combine weight is exactly 1,
so an expert over capacity keeps its lowest-index tokens.

The expert weights are cast to the compute dtype once a call (the
reference casts them at each use inside its scans, the same values).  The
reference's sharding constraints stand at its points
(``parallel/sharding.py::constrain``), and the tensors each path makes
(the top-1 inverse index, the top-k scatter target) are made on the
input's mesh when it is a DTensor.  The expert products are plain large
GEMMs, which the reference also computes outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import (constrain, hold_layout, on_local_shards,
                                 replicated, sharded_full)
from .layers import act_fn
from .spec import ParamSpec

F32 = torch.float32
#: the reference's token chunk of the dense path and slot chunk of the
#: capacity path.
TOKEN_CHUNK = 1024
CAPACITY_CHUNK = 512


def moe_spec(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype
    spec = {
        "router": ParamSpec((d, e), (None, None), dt),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dt),
        "wu": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dt),
        "wd": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"), dt),
    }
    if cfg.shared_expert:
        spec["shared"] = {
            "wg": ParamSpec((d, f), ("embed", "mlp"), dt),
            "wu": ParamSpec((d, f), ("embed", "mlp"), dt),
            "wd": ParamSpec((f, d), ("mlp", "embed"), dt),
        }
    return spec


def _top(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values and
    their indices, equal values in increasing index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg, p, x):
    """Top-k routing.  Returns combine weights (B, S, E) in f32.

    x stays in compute dtype; its products with the router (cast to x's
    dtype) accumulate in f32, as the reference's
    ``preferred_element_type``: bf16 products are exact in f32."""
    logits = x.to(F32) @ p["router"].to(x.dtype).to(F32)
    probs = torch.softmax(logits, dim=-1)
    if cfg.top_k >= cfg.n_experts:
        return probs
    vals, idx = _top(probs, cfg.top_k)                   # (B, S, k)
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    # the combine's gradient comes back split over ``experts``; the
    # scatter's backward gathers it along the experts, which DTensor makes a
    # masked partial sum that the two uses of ``vals`` would reduce twice:
    # it takes the combine's layout (experts whole) first
    return hold_layout(torch.zeros_like(probs).scatter(-1, idx, vals))


def _cast_experts(p, compute_dtype) -> tuple:
    return tuple(p[w].to(compute_dtype) for w in ("wg", "wu", "wd"))


def _glu(cfg, wg, wu, wd, x, combine, compute_dtype):
    """Experts over every token: x (B, Sc, d), combine (B, Sc, E) ->
    (B, Sc, d).  ``wg``/``wu``/``wd`` are already in the compute dtype.
    The down projection contracts experts and hidden units in one product,
    as the reference's ``einsum("ebsf,efd->bsd")``."""
    a = act_fn(cfg.act)
    B, Sc, d = x.shape
    E, _, f = wg.shape
    xf = x.reshape(1, B * Sc, d)
    h = a(xf @ wg) * (xf @ wu)                           # (E, B*Sc, f)
    h = h * combine.permute(2, 0, 1).reshape(E, B * Sc, 1).to(compute_dtype)
    y = h.permute(1, 0, 2).reshape(B * Sc, E * f) @ wd.reshape(E * f, d)
    return y.reshape(B, Sc, d)


def _shared(cfg, p, x, compute_dtype):
    sp = p["shared"]
    a = act_fn(cfg.act)
    cd = compute_dtype
    h = a(x @ sp["wg"].to(cd)) * (x @ sp["wu"].to(cd))
    return constrain(h, ("batch", "seq", "mlp")) @ sp["wd"].to(cd)


def moe_dense(cfg, p: dict, x: torch.Tensor, compute_dtype,
              token_chunk: int = TOKEN_CHUNK) -> torch.Tensor:
    """Dense-compute MoE with sequence chunking.  x: (B, S, d)."""
    B, S, d = x.shape
    decode = S == 1
    if decode:
        # weight-stationary decode: the tokens replicated, the experts stay
        x = constrain(x, (None, "seq", "act_embed"))
    combine = _router(cfg, p, x)
    sc = min(token_chunk, S)
    if S % sc:
        sc = S
    w = _cast_experts(p, compute_dtype)
    y = torch.cat([_glu(cfg, *w, x[:, i:i + sc], combine[:, i:i + sc],
                        compute_dtype) for i in range(0, S, sc)], dim=1)
    if cfg.shared_expert:
        y = y + _shared(cfg, p, x, compute_dtype)
    return constrain(y, ("batch", "seq", "act_embed"))


def moe_capacity(cfg, p: dict, x: torch.Tensor, compute_dtype,
                 capacity_factor: float = 1.25) -> torch.Tensor:
    """Fixed-capacity MoE (active FLOPs only), groups = batch rows: each
    row picks its top-C tokens per expert along the sequence.  Over-capacity
    tokens are dropped; the combine weight re-weights the survivors."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cd = compute_dtype
    combine = _router(cfg, p, x)                          # (B, S, E) f32

    C = int(S * k / E * capacity_factor)
    C = min(max(C, 1), S)

    # per-(row, expert) top-C token selection by combine weight
    top_w, top_idx = _top(combine.transpose(1, 2), C)     # (B, E, C)
    idx_flat = top_idx.reshape(B, E * C)
    gathered = torch.gather(x, 1, idx_flat[..., None].expand(B, E * C, d))
    gathered = constrain(gathered.reshape(B, E, C, d),
                         ("batch", "experts", None, "act_embed"))

    a = act_fn(cfg.act)
    wg, wu, wd = _cast_experts(p, cd)

    def expert_glu(xc, wc):                  # (B, E, c, d), (B, E, c)
        c = xc.shape[2]
        xe = xc.transpose(0, 1).reshape(E, B * c, d)
        h = a(xe @ wg) * (xe @ wu)                        # (E, B*c, f)
        h = h * wc.transpose(0, 1).reshape(E, B * c, 1).to(cd)
        return (h @ wd).reshape(E, B, c, d).transpose(0, 1)

    cc = CAPACITY_CHUNK          # capacity chunk bounds the transients
    if C > cc and C % cc == 0:
        out = torch.cat([expert_glu(gathered[:, :, i:i + cc],
                                    top_w[:, :, i:i + cc])
                         for i in range(0, C, cc)], dim=2)
    else:
        out = expert_glu(gathered, top_w)

    vals = out.reshape(B, E * C, d)
    if cfg.remat == "none":
        # serving: the slot values gathered before the combine
        vals = constrain(vals, ("batch", None, "act_embed"))
    if k == 1:
        # top-1: a token holds at most one nonzero-weight slot, so the
        # combine is an inverse gather.  Zero-weight slots (the padding of
        # other experts) point at a scratch column S, cut off after.
        idx_inv = torch.where(top_w.reshape(B, E * C) > 0, idx_flat, S)
        slots = replicated(torch.arange(E * C, device=x.device),
                           x).expand(B, E * C)
        inv = sharded_full((B, S + 1), -1, ("batch", None), x, slots.dtype)
        # DTensor has no rule for scatter_reduce: each rank scatters its
        # own rows
        inv = on_local_shards(
            lambda t, i, s: t.scatter_reduce(1, i, s, "amax"),
            (inv, idx_inv, slots), (("batch", None),) * 3,
            "moe combine")[:, :S]
        y = torch.gather(vals, 1, inv.clamp_min(0)[..., None].expand(
            B, S, d))
        y = torch.where((inv >= 0)[..., None], y, torch.zeros((), dtype=cd,
                                                              device=x.device))
    else:
        y = sharded_full((B, S, d), 0, ("batch", None, "act_embed"), x,
                         cd).scatter_add(
            1, idx_flat[..., None].expand(B, E * C, d), vals)

    if cfg.shared_expert:
        y = y + _shared(cfg, p, x, cd)
    return constrain(y, ("batch", "seq", "act_embed"))


def moe_ffn(cfg, p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    impl = getattr(cfg, "moe_impl", "dense")
    # decode (S == 1): the dense path is exact and cheap
    if impl == "capacity" and x.shape[1] > 1:
        return moe_capacity(cfg, p, x, compute_dtype)
    return moe_dense(cfg, p, x, compute_dtype)
