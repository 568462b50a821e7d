"""Attention's parameter tree (counterpart of the reference's
``repro/models/attention.py``, its specs only).

q/k/v use a flat head axis padded to ``cfg.head_pad_multiple``; the padded
heads carry zero projections in the reference and are output-masked.  The
forwards (online and banded attention, decode, the KV cache) wait for the
port of the attention archs (ROADMAP A9c).
"""
from __future__ import annotations

from .spec import ParamSpec


def padded_heads(cfg) -> int:
    m = getattr(cfg, "head_pad_multiple", 1) or 1
    return ((cfg.n_heads + m - 1) // m) * m


def attn_spec(cfg, cross: bool = False) -> dict:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = padded_heads(cfg), cfg.n_kv_heads
    dt = cfg.param_dtype
    return {
        "wq": ParamSpec((d, hq, dh), ("embed", "heads", "head_dim"), dt),
        "wk": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim"), dt),
        "wv": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim"), dt),
        "wo": ParamSpec((hq, dh, d), ("heads", "head_dim", "embed"), dt),
    }
