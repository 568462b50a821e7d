"""Shared neural-net layers (functional PyTorch, explicit dtypes).

Counterpart of the reference's ``repro/models/layers.py``: the same specs,
the same math and dtypes at each step, and the reference's sharding
constraints (``parallel/sharding.py::constrain``: a DTensor is
redistributed there under an active mesh, anything else passes as it is).
Fresh tensors that meet DTensors (``rope``'s tables and positions, the
tokens) enter as replicated DTensors (``sharding.replicated``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import (constrain, embedding, on_local_shards,
                                 replicated)
from .spec import ParamSpec

F32 = torch.float32


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def norm_spec(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), ("act_embed",), init="ones")}
    return {"scale": ParamSpec((d,), ("act_embed",), init="ones"),
            "bias": ParamSpec((d,), ("act_embed",), init="zeros")}


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """Norms with f32 reductions and the elementwise math in the input
    dtype, as the reference computes them."""
    x32 = x.to(F32)
    if kind == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * p["scale"].to(x.dtype)
    mean32 = x32.mean(-1, keepdim=True)
    var = x32.square().mean(-1, keepdim=True) - mean32.square()
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mean32.to(x.dtype)) * inv * p["scale"].to(x.dtype)
            + p["bias"].to(x.dtype))


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# MLP (dense 2-matrix or GLU 3-matrix)
# ---------------------------------------------------------------------------

def mlp_spec(d: int, f: int, kind: str, dtype: str,
             mlp_axis: str = "mlp") -> dict:
    if kind == "glu":
        return {
            "wg": ParamSpec((d, f), ("embed", mlp_axis), dtype),
            "wu": ParamSpec((d, f), ("embed", mlp_axis), dtype),
            "wd": ParamSpec((f, d), (mlp_axis, "embed"), dtype),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", mlp_axis), dtype),
        "wo": ParamSpec((f, d), (mlp_axis, "embed"), dtype),
    }


def apply_mlp(p: dict, x: torch.Tensor, kind: str, act: str,
              compute_dtype: torch.dtype) -> torch.Tensor:
    a = act_fn(act)
    cd = compute_dtype
    decode = x.shape[1] == 1
    if decode:
        # weight-stationary decode: the token replicated, the weights stay
        x = constrain(x, (None, "seq", "act_embed"))
    if kind == "glu":
        h = a(x @ p["wg"].to(cd)) * (x @ p["wu"].to(cd))
        out = constrain(h, ("batch", "seq", "mlp")) @ p["wd"].to(cd)
    else:
        h = a(x @ p["wi"].to(cd))
        out = constrain(h, ("batch", "seq", "mlp")) @ p["wo"].to(cd)
    return constrain(out, ("batch", "seq", "act_embed")) if decode else out


# ---------------------------------------------------------------------------
# Rotary and sinusoidal position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Hkv, G, Dh); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = (1.0 / theta) ** (torch.arange(half, dtype=F32,
                                           device=x.device) / half)
    freqs, positions = replicated(freqs, x), replicated(positions, x)
    ang = positions[..., None].to(F32) * freqs        # (..., S, half)
    for _ in range(x.ndim - ang.ndim - 1):            # over the head axes
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, offset=0,
                         device=None) -> torch.Tensor:
    """Classic transformer sinusoidal embeddings (whisper), f32.

    Computed in f64 and rounded once: the reference's f32 angles (up to
    1500 rad for whisper's frames) carry ~1e-4 of rounding into each sine,
    and f32 ``sin`` differs between the CPU and the card by as much, which
    whisper's random full-width model amplifies to O(1) in its logits.
    Rounded from f64, the table is the same on either device and within
    an f32 rounding of the exact values."""
    f64 = torch.float64
    pos = (torch.arange(seq, dtype=f64, device=device) + offset)[:, None]
    half = d // 2
    freqs = (1.0 / 10_000.0) ** (torch.arange(half, dtype=f64,
                                              device=device) / half)
    ang = pos * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(F32)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_spec(vocab: int, d: int, dtype: str) -> ParamSpec:
    return ParamSpec((vocab, d), ("vocab", None), dtype, init="normal")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    # on a vocab-split DTensor table each rank looks up the rows it holds
    # and the lookups sum over ``model`` (an index would all-gather the
    # whole table first)
    out = embedding(table, tokens).to(compute_dtype)
    return constrain(out, ("batch", "seq", "act_embed"))


def unembed(table_or_head: torch.Tensor, x: torch.Tensor,
            compute_dtype: torch.dtype, transpose: bool) -> torch.Tensor:
    """Logits = x @ W^T (tied) or x @ W (untied head)."""
    w = table_or_head.to(compute_dtype)
    return constrain(x @ (w.t() if transpose else w),
                     ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  real_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32; positions of the padded vocab
    masked.  The label's logit is picked with ``gather`` and the padded
    columns are left out of the log-sum-exp: the reference sums the logit
    with zeros over the vocab axis and adds exp(-1e30 - max) = 0 for each
    padded column, the same values, through full-vocab boolean and
    ``where`` temporaries that this version does not make.

    Vocab-sharded logits (a DTensor) are gathered over the vocab first
    (an all-gather of the logits over ``model``, the ``vocab`` axis's mesh
    axis); each rank then takes its own rows' losses
    (``sharding.on_local_shards``: DTensor would run the gather's
    backward on the whole batch), and the mean runs on batch-sharded
    DTensors."""
    logits = constrain(logits, ("batch", "seq", None))
    labels = replicated(labels, logits)
    mask = mask if mask is None else replicated(mask, logits)
    nll = on_local_shards(lambda lg, lb: _nll(lg, lb, real_vocab),
                          (logits, labels),
                          (("batch", "seq", None), ("batch", "seq")),
                          "cross_entropy")
    if mask is not None:
        m = mask.to(F32)
        return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)
    return nll.mean()


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         real_vocab: Optional[int]) -> torch.Tensor:
    """Each position's negative log-likelihood of its label, f32."""
    lf = logits.to(F32)
    labels = labels[..., None].long()
    picked = torch.gather(lf, -1, labels)[..., 0]
    if real_vocab is not None and real_vocab < lf.shape[-1]:
        # the padded columns hold -1e30 in the reference: exp gives 0
        lse = torch.logsumexp(lf[..., :real_vocab], dim=-1)
        picked = torch.where(labels[..., 0] < real_vocab, picked, -1e30)
    else:
        lse = torch.logsumexp(lf, dim=-1)
    return lse - picked
