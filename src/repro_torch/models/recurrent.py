"""Recurrent sequence-mixing blocks: RG-LRU (RecurrentGemma), mLSTM and
sLSTM (xLSTM).

Counterpart of the reference's ``repro/models/recurrent.py``.  All
recurrences run in float32.

* The mLSTM takes the chunkwise-parallel form.  From zero state it runs
  the whole sequence through ``kernels/ops.py::mlstm_scan_trainable``: the
  CUDA kernel on the card (its plain version on the CPU), with a gradient
  that replays :func:`_mlstm_chunk` chunk by chunk from the states the
  forward kept.  From a given state it scans :func:`_mlstm_chunk` (the
  reference's ``lax.scan`` over ``jax.checkpoint(_mlstm_chunk)``).
* The sLSTM is a sequential scan, a Python loop over time steps: neither
  package has a kernel for it.  On DTensors it runs on each rank's local
  rows.
* The RG-LRU computes its gates as the reference does and runs its
  linear scan through ``kernels/ops.py::rglru_scan`` from the state's h,
  whose gradient is the reverse scan through the same kernel (the
  reference folds h0 into the first step of a log-depth
  ``associative_scan``: the same function, other rounding).

The reference's sharding constraints stand at its points
(``parallel/sharding.py::constrain``).  On DTensors the RG-LRU's initial
state h0 and conv pad are made on the input's mesh, batch and width split as
the activations are (``sharding.sharded_full``; the zero states likewise),
and its scan runs on each rank's shard; the mLSTM kernel runs on each
rank's (batch, heads) shard, its heads kept whole on a rank from the
projections on, and the sLSTM's loop on each rank's rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..parallel.sharding import (constrain, elementwise, hold_layout,
                                 on_local_shards, replicated, sharded_full)
from .layers import act_fn
from .spec import ParamSpec

F32 = torch.float32
LRU_C = 8.0          # RG-LRU decay exponent constant (RecurrentGemma)


# ===========================================================================
# RG-LRU
# ===========================================================================

def _lru_blocks(cfg):
    """Block-diagonal gate structure (RecurrentGemma: per-head blocks)."""
    w = cfg.lru_width or cfg.d_model
    nb = cfg.n_heads
    while w % nb:
        nb //= 2
    return nb, w // nb


def rglru_spec(cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv_width
    dt = cfg.param_dtype
    nb, wb = _lru_blocks(cfg)
    return {
        "in_x": ParamSpec((d, w), ("embed", "lru"), dt),
        "in_y": ParamSpec((d, w), ("embed", "lru"), dt),
        "conv_w": ParamSpec((cw, w), ("conv", "lru"), dt),
        "conv_b": ParamSpec((w,), ("lru",), dt, init="zeros"),
        "gate_a": ParamSpec((nb, wb, wb), ("lru_blocks", None, None), dt),
        "gate_a_b": ParamSpec((w,), ("lru",), dt, init="zeros"),
        "gate_x": ParamSpec((nb, wb, wb), ("lru_blocks", None, None), dt),
        "gate_x_b": ParamSpec((w,), ("lru",), dt, init="zeros"),
        "lamb": ParamSpec((w,), ("lru",), dt, init="lambda_lru"),
        "out": ParamSpec((w, d), ("lru", "embed"), dt),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, w) recurrent state, f32
    conv: torch.Tensor    # (B, conv_width - 1, w) conv tail


def _zeros(shape, logical, dtype, device, like):
    """Zeros of ``shape``: on ``like``'s mesh under ``logical`` (each rank
    making its shard) when ``like`` is a DTensor, else on ``device`` (or
    ``like``'s)."""
    if like is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return sharded_full(shape, 0, logical, like, dtype)


def rglru_zero_state(cfg, batch: int, dtype=F32, device=None,
                     like=None) -> RGLRUState:
    """The zero state, laid out as ``cache_spec``'s: on ``like``'s mesh
    when ``like`` (an input) is a DTensor."""
    w = cfg.lru_width or cfg.d_model
    return RGLRUState(
        h=_zeros((batch, w), ("batch", "lru"), dtype, device, like),
        conv=_zeros((batch, cfg.conv_width - 1, w), ("batch", None, "lru"),
                    dtype, device, like))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time.  x: (B, S, w); w: (cw, w).
    Returns (out, the last cw - 1 inputs: the next call's ``tail``).  The
    taps' products and sums run in f32 and round once to x's dtype, where
    XLA's fusion of the reference's sum rounds them."""
    cw = w.shape[0]
    if tail is None:
        pad = sharded_full((x.shape[0], cw - 1, x.shape[2]), 0,
                           ("batch", None, "lru"), x)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+cw-1, w)
    S = x.shape[1]
    xp32, w32 = xp.to(F32), w.to(F32)
    out = xp32[:, 0:S] * w32[0][None, None]
    for i in range(1, cw):
        out = out + xp32[:, i:i + S] * w32[i][None, None]
    new_tail = xp[:, -(cw - 1):] if cw > 1 else None
    return (out + b.to(F32)[None, None]).to(x.dtype), new_tail


def _rglru_core(p, xw: torch.Tensor, h0: torch.Tensor):
    """The RG-LRU recurrence.  xw: (B, S, w) f32; h0: (B, w) f32.  Returns
    (h (B, S, w) f32, the last h).

    Gates are block-diagonal per head, computed with a batched per-block
    product, as the reference's; the scan ``h_t = a_t h_{t-1} + b_t`` from
    ``h0`` runs through ``kernels/ops.py::rglru_scan`` (the kernel on
    CUDA, the plain version on the CPU), whose backward is the reverse
    scan through the same wrapper."""
    B, S, W = xw.shape
    nb, wb, _ = p["gate_a"].shape
    # the width split by whole blocks before it unflattens, as
    # ``attention.project_heads`` splits heads
    xw = constrain(xw, ("batch", "seq", "lru_blocks"), (B, S, nb))
    x4 = constrain(xw.reshape(B, S, nb, wb),
                   ("batch", "seq", "lru_blocks", None))

    def gate(w, bias):           # einsum("bshw,hwv->bshv") + bias
        y = torch.einsum("bshw,hwv->bshv", x4, w.to(F32))
        # the gradient meets the reshape laid out as the blocks are
        return torch.sigmoid(hold_layout(y.reshape(B, S, W))
                             + bias.to(F32))

    r = gate(p["gate_a"], p["gate_a_b"])
    i = gate(p["gate_x"], p["gate_x_b"])
    log_a = -LRU_C * F.softplus(p["lamb"].to(F32)) * r
    a = torch.exp(log_a)
    gated_x = i * xw
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = beta * gated_x
    h = kops.rglru_scan(a, b, h0.to(F32))
    return h, h[:, -1]


def rglru_block(cfg, p: dict, x: torch.Tensor, compute_dtype,
                state: Optional[RGLRUState] = None):
    """Full RG-LRU temporal block: in-proj, causal conv, recurrence, gated
    out.  x: (B, S, d).  Returns (y, new_state)."""
    B = x.shape[0]
    cd = compute_dtype
    y_branch = act_fn("gelu")(x @ p["in_y"].to(cd))
    xw = constrain(x @ p["in_x"].to(cd), ("batch", "seq", "lru"))
    tail = state.conv if state is not None else None
    xw, new_tail = _causal_conv(xw, p["conv_w"].to(cd), p["conv_b"].to(cd),
                                tail)
    W = xw.shape[-1]
    h0 = (state.h if state is not None
          else sharded_full((B, W), 0, ("batch", "lru"), xw, F32))
    h, h_last = _rglru_core(p, xw.to(F32), h0)
    h = constrain(h.to(cd), ("batch", "seq", "lru"))
    out = (h * y_branch) @ p["out"].to(cd)
    new_state = RGLRUState(
        h=h_last,
        conv=(new_tail.to(F32) if new_tail is not None
              else sharded_full((B, 0, W), 0, ("batch", None, "lru"), xw,
                                F32)))
    return constrain(out, ("batch", "seq", "act_embed")), new_state


# ===========================================================================
# mLSTM (chunkwise-parallel matrix memory)
# ===========================================================================

def mlstm_spec(cfg) -> dict:
    d = cfg.d_model
    m = 2 * d                      # up-projection factor 2 (xLSTM)
    h = cfg.n_heads
    dt = cfg.param_dtype
    return {
        "up": ParamSpec((d, m), ("embed", "lru"), dt),
        "wq": ParamSpec((m, m), ("lru", None), dt),
        "wk": ParamSpec((m, m), ("lru", None), dt),
        "wv": ParamSpec((m, m), ("lru", None), dt),
        "w_if": ParamSpec((d, 2 * h), ("embed", None), dt),
        "b_if": ParamSpec((2 * h,), (None,), dt, init="zeros"),
        "w_o": ParamSpec((d, m), ("embed", "lru"), dt),
        "down": ParamSpec((m, d), ("lru", "embed"), dt),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, Dh, Dh) matrix memory, f32
    n: torch.Tensor  # (B, H, Dh) normalizer, f32
    m: torch.Tensor  # (B, H) running max exponent, f32


def mlstm_zero_state(cfg, batch: int, device=None, like=None) -> MLSTMState:
    """The zero state, laid out as ``cache_spec``'s: on ``like``'s mesh
    when ``like`` (an input) is a DTensor."""
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    z = lambda shape, logical: _zeros(shape, logical, F32, device, like)
    return MLSTMState(C=z((batch, h, dh, dh), ("batch", "heads", None, None)),
                      n=z((batch, h, dh), ("batch", "heads", None)),
                      m=z((batch, h), ("batch", "heads")))


def _mlstm_chunk(q, k, v, li, lf, state: MLSTMState):
    """One chunk of the stabilized chunkwise mLSTM, op for op the
    reference's.  q,k,v: (B,H,L,Dh) f32; li,lf: (B,H,L) f32 (log input
    gate, log forget gate).  Returns (h, the state at the chunk's end)."""
    L = q.shape[2]
    C0, n0, m0 = state
    b = torch.cumsum(lf, dim=-1)                     # (B,H,L) inclusive
    Fc = b[..., -1]                                  # (B,H)

    # per-position stabilizer
    intra_exp = b[..., :, None] - b[..., None, :] + li[..., None, :]
    causal = replicated(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device).tril(), q)
    intra_exp = torch.where(causal, intra_exp, -torch.inf)
    m_intra = intra_exp.amax(dim=-1)                 # (B,H,L)
    m_inter = m0[..., None] + b                      # (B,H,L)
    m_t = torch.maximum(m_inter, m_intra)
    m_t = torch.clamp_min(m_t, -1e30)               # never a tie: finite

    g_inter = torch.exp(m_inter - m_t)               # (B,H,L)
    w_intra = torch.exp(intra_exp - m_t[..., None])
    w_intra = torch.where(causal, w_intra, 0.0)

    scores = (q @ k.transpose(-1, -2)) * w_intra
    h_num = g_inter[..., None] * (q @ C0) + scores @ v
    n_t = g_inter * (q @ n0[..., None])[..., 0] + scores.sum(dim=-1)
    denom = torch.maximum(n_t.abs(), torch.exp(-m_t))
    h_out = h_num / denom[..., None]

    # state update to the end of the chunk
    s_exp = Fc[..., None] - b + li                   # (B,H,L)
    m_next = torch.maximum(m0 + Fc, s_exp.amax(dim=-1))
    decay_old = torch.exp(m0 + Fc - m_next)
    w_new = torch.exp(s_exp - m_next[..., None])     # (B,H,L)
    kw = k * w_new[..., None]
    C1 = decay_old[..., None, None] * C0 + kw.transpose(-1, -2) @ v
    n1 = decay_old[..., None] * n0 + kw.sum(dim=-2)
    return h_out, MLSTMState(C=C1, n=n1, m=m_next)


def _mlstm_chunks(q, k, v, li, lf, state: MLSTMState, L: int):
    """The chunk scan from ``state``: (h, the final state)."""
    hs = []
    for c0 in range(0, q.shape[2], L):
        sl = slice(c0, c0 + L)
        h, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                li[..., sl], lf[..., sl], state)
        hs.append(h)
    return torch.cat(hs, dim=2), state


def mlstm_inputs(cfg, p: dict, x: torch.Tensor, compute_dtype):
    """The mLSTM's heads and gates from x (B, S, d): q, k, v (B, H, S, Dh)
    f32 (q and k scaled by Dh^-1/2), the log input and log forget gates
    (B, H, S) f32, and the chunk length L (``cfg.mlstm_chunk``, or S where
    that does not divide S)."""
    B, S, d = x.shape
    cd = compute_dtype
    H = cfg.n_heads
    Dh = 2 * d // H
    xm = constrain(x @ p["up"].to(cd), ("batch", "seq", "lru"))

    def heads(w):        # columns split by whole heads, as project_heads
        y = constrain(xm @ w.to(cd), ("batch", "seq", "heads"), (B, S, H))
        return y.unflatten(-1, (H, Dh)).transpose(1, 2).to(F32)

    q = heads(p["wq"]) * (Dh ** -0.5)
    k = heads(p["wk"]) * (Dh ** -0.5)
    v = heads(p["wv"])
    gif = x.to(F32) @ p["w_if"].to(F32) + p["b_if"].to(F32)
    li = gif[..., :H].transpose(1, 2)                # (B,H,S) log input gate
    lf = elementwise(F.logsigmoid, gif[..., H:]).transpose(1, 2)
    L = min(cfg.mlstm_chunk, S)
    if S % L:
        L = S
    return q, k, v, li, lf, L


def mlstm_block(cfg, p: dict, x: torch.Tensor, compute_dtype,
                state: Optional[MLSTMState] = None):
    """x: (B, S, d) -> (y, new_state).  S must divide by cfg.mlstm_chunk
    (or be smaller)."""
    B, S, d = x.shape
    H = cfg.n_heads
    cd = compute_dtype
    q, k, v, li, lf, L = mlstm_inputs(cfg, p, x, cd)
    if state is None:
        h_out, last = kops.mlstm_scan_trainable(q, k, v, li, lf, chunk=L)
        # the final state: one more chunk from the last chunk's start
        sl = slice(S - L, S)
        _, st = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                             li[..., sl], lf[..., sl], last)
    else:
        h_out, st = _mlstm_chunks(q, k, v, li, lf, state, L)

    # whole heads on a rank, as ``heads`` splits them: the output gate's
    # columns split over ``model`` where the heads do not would reach this
    # reshape's backward as a split no (H, Dh) unflatten takes
    h_seq = constrain(h_out.transpose(1, 2).reshape(B, S, 2 * d).to(cd),
                      ("batch", "seq", "heads"), (B, S, H))
    o = torch.sigmoid(x @ p["w_o"].to(cd))
    y = (h_seq * o) @ p["down"].to(cd)
    return constrain(y, ("batch", "seq", "act_embed")), st


# ===========================================================================
# sLSTM (scalar memory, exponential gating; sequential scan)
# ===========================================================================

def slstm_spec(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    dt = cfg.param_dtype
    f = cfg.d_ff if cfg.d_ff else ((4 * d // 3 + 127) // 128) * 128
    return {
        "w": ParamSpec((d, 4 * d), ("embed", "lru"), dt),       # z,i,f,o
        "r": ParamSpec((h, dh, 4 * dh), (None, None, None), dt),
        "b": ParamSpec((4 * d,), ("lru",), dt, init="zeros"),
        "ffn_g": ParamSpec((d, f), ("embed", "mlp"), dt),
        "ffn_u": ParamSpec((d, f), ("embed", "mlp"), dt),
        "ffn_d": ParamSpec((f, d), ("mlp", "embed"), dt),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d) cell, f32
    n: torch.Tensor  # (B, d) normalizer, f32
    m: torch.Tensor  # (B, d) stabilizer, f32
    h: torch.Tensor  # (B, d) hidden, f32


def slstm_zero_state(cfg, batch: int, device=None, like=None) -> SLSTMState:
    """The zero state, laid out as ``cache_spec``'s: on ``like``'s mesh
    when ``like`` (an input) is a DTensor."""
    z = _zeros((batch, cfg.d_model), ("batch", "lru"), F32, device, like)
    return SLSTMState(c=z, n=z, m=z, h=z)


def _slstm_step(cfg, p, state: SLSTMState, wx_t: torch.Tensor,
                r32: Optional[torch.Tensor] = None,
                one: Optional[torch.Tensor] = None) -> SLSTMState:
    """wx_t: (B, 4d) precomputed input projection at time t.  The caller's
    loop may pass ``p["r"]`` in f32 (``r32``) and a 0-d f32 one on the
    device (``one``), made once rather than at every step."""
    B = wx_t.shape[0]
    d = cfg.d_model
    H = cfg.n_heads
    c, n, m, h = state
    r = p["r"].to(F32) if r32 is None else r32
    one = wx_t.new_ones(()) if one is None else one
    # recurrent projection, block-diagonal per head: (H, B, Dh) @ (H, Dh,
    # 4Dh), then (B, H, 4Dh) flattened as the reference's einsum lays it
    rec = torch.bmm(h.reshape(B, H, d // H).transpose(0, 1), r)
    pre = wx_t + rec.transpose(0, 1).reshape(B, 4 * d)
    z_, i_, f_, o_ = pre.split(d, dim=-1)
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    # stabilized exponential gating
    log_f = F.logsigmoid(f_)
    m_new = torch.maximum(log_f + m, i_)
    i = torch.exp(i_ - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * z
    n_new = f * n + i
    # torch.maximum, as jnp.maximum, halves the gradient at a tie (|n| is
    # exactly 1 wherever the input gate sets the stabilizer)
    h_new = o * c_new / torch.maximum(n_new.abs(), one)
    return SLSTMState(c=c_new, n=n_new, m=m_new, h=h_new)


def _slstm_scan(cfg, wx, r32, *state):
    """The time loop from ``state`` (c, n, m, h) over ``wx`` (B, S, 4d), on
    plain tensors: (h_seq (B, S, d) f32, c, n, m, h)."""
    st = SLSTMState(*state)
    one = wx.new_ones(())
    hs = []
    for t in range(wx.shape[1]):
        st = _slstm_step(cfg, None, st, wx[:, t], r32, one)
        hs.append(st.h)
    return (torch.stack(hs, dim=1), *st)


def slstm_block(cfg, p: dict, x: torch.Tensor, compute_dtype,
                state: Optional[SLSTMState] = None):
    """x: (B, S, d) -> (y, new_state).  On DTensors the time loop runs on
    each rank's batch rows with ``wx`` whole over its ``4d`` axis (one
    redistribution a block: the z, i, f, o gates of a unit lie on
    different ranks of ``model`` otherwise), so its steps pay no DTensor
    dispatch; the state then takes ``cache_spec``'s layout."""
    B, S, d = x.shape
    cd = compute_dtype
    wx = x.to(F32) @ p["w"].to(F32) + p["b"].to(F32)
    st = state if state is not None else slstm_zero_state(cfg, B, like=x)
    row = ("batch", None)
    out = on_local_shards(
        lambda *a: _slstm_scan(cfg, *a), (wx, p["r"].to(F32), *st),
        (("batch", "seq", None), (None, None, None)) + (row,) * 4, "slstm",
        n_out=5)
    st = SLSTMState(*(constrain(t, ("batch", "lru")) for t in out[1:]))
    h_seq = constrain(out[0], ("batch", "seq", "act_embed")).to(cd)
    a = act_fn(cfg.act)
    g = h_seq @ p["ffn_g"].to(cd)
    u = h_seq @ p["ffn_u"].to(cd)
    y = (a(g) * u) @ p["ffn_d"].to(cd)
    return constrain(y, ("batch", "seq", "act_embed")), st
