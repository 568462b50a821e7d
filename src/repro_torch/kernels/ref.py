"""The oracles of every kernel, in PyTorch: the port's own copy of the
reference's ``repro/kernels/ref.py``.

Deliberately the simplest implementations (materialized attention,
stepwise recurrences), independent of the blocked and chunkwise forms of
the kernels and their plain versions, so a disagreement points at the
optimized code.  Same layouts as the reference, f32 math,
``NEG_INF = -1e30``.  ``quant_ref`` divides by 127 as the reference's
oracle does; the kernel multiplies by float32(1/127), as XLA compiles the
reference's kernel (``quant_blockwise.py``).
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30
F32 = torch.float32


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_ref(q, k, v, *, causal=True, window=0, chunk=0):
    """Naive softmax attention.  q,k,v: (B, H, S, Dh); f32 math."""
    Sq, Dh = q.shape[2], q.shape[3]
    Skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32)) * (Dh ** -0.5)
    jq = torch.arange(Sq, device=q.device)[:, None]
    jk = torch.arange(Skv, device=q.device)[None, :]
    allow = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        allow &= jk <= jq
    if window:
        allow &= jk > jq - window
    if chunk:
        allow &= (jk // chunk) == (jq // chunk)
    s = torch.where(allow, s, NEG_INF)
    p = torch.where(allow, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)


def decode_ref(q1, k, v, *, length):
    """Single-token decode: q1 (B, H, Dh), cache k/v (B, H, S, Dh), attend
    to the first ``length`` positions."""
    s = torch.einsum("bhd,bhkd->bhk", q1.to(F32), k.to(F32)) * (
        q1.shape[-1] ** -0.5)
    mask = torch.arange(k.shape[2], device=k.device) < length
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, v.to(F32)).to(q1.dtype)


# ---------------------------------------------------------------------------
# RG-LRU linear scan:  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------

def rglru_ref(a, b, h0):
    """a, b: (B, S, W); h0: (B, W).  Stepwise oracle; f32 (B, S, W)."""
    h = h0.to(F32)
    a, b = a.to(F32), b.to(F32)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


# ---------------------------------------------------------------------------
# mLSTM: stepwise stabilized matrix-memory recurrence
# ---------------------------------------------------------------------------

def mlstm_ref(q, k, v, li, lf):
    """q,k,v: (B, H, S, Dh) (q,k pre-scaled); li/lf: (B, H, S) log gates.
    Stepwise oracle of the stabilized mLSTM (xLSTM paper); f32."""
    B, H, S, Dh = q.shape
    q, k, v, li, lf = (x.to(F32) for x in (q, k, v, li, lf))
    C = q.new_zeros((B, H, Dh, Dh))
    n = q.new_zeros((B, H, Dh))
    m = q.new_zeros((B, H))
    hs = []
    for t in range(S):
        qt, kt, vt, lit, lft = q[:, :, t], k[:, :, t], v[:, :, t], \
            li[:, :, t], lf[:, :, t]
        m_new = torch.maximum(lft + m, lit)
        f = torch.exp(lft + m - m_new)
        i = torch.exp(lit - m_new)
        C = f[..., None, None] * C + i[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f[..., None] * n + i[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2)


# ---------------------------------------------------------------------------
# Blockwise int8 quantization
# ---------------------------------------------------------------------------

def quant_ref(x, block: int = 128):
    """x: (N, D), D % block == 0.  Returns (int8 vals, f32 scales
    (N, D/block))."""
    N, D = x.shape
    xb = x.to(F32).reshape(N, D // block, block)
    scale = xb.abs().amax(-1) / 127.0
    scale = torch.maximum(scale, scale.new_tensor(1e-12))
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(N, D), scale


def dequant_ref(q, scale, block: int = 128, dtype=F32):
    N, D = q.shape
    xb = q.reshape(N, D // block, block).to(F32)
    return (xb * scale[..., None]).reshape(N, D).to(dtype)
