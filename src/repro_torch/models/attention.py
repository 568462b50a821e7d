"""Attention: GQA projections, memory-bounded softmax attention, decode.

Counterpart of the reference's ``repro/models/attention.py``.  q/k/v use a
flat head axis padded to ``cfg.head_pad_multiple``; the padded heads carry
zero projections in the reference and are output-masked.  KV is stored
un-expanded ``(B, S, Hkv, Dh)`` and expanded to the q heads where a kernel
reads it.

* :func:`attention` keeps the reference's dispatch (banded for a
  sliding-window or chunked mask narrower than the sequence, online
  softmax otherwise).  Both bodies are one call of
  ``kernels/ops.py::flash_attention`` in the mask's mode: the flash kernel
  on CUDA, its plain version on the CPU, and on either device a blocked
  backward in PyTorch (``kernels/flash_attention.py::FlashAttention``).
  The masks are the kernel's (the reference's ``_block_mask`` is
  ``kernels/flash_attention.py::allowed``).
* :func:`decode_attention` maps the reference's ``slot_pos`` mask to the
  number of leading cache slots it allows (:func:`decode_length`, worked
  out on the host) and launches ``kernels/ops.py::decode_attention`` on
  the KV cache expanded to the q heads; a cache split over ``model``
  along its slots (the reference's ``kv_seq_mp``) is read where it lies
  and the ranks' pieces merged (flash-decoding across ranks).
* :func:`cross_attention` (whisper's decoder over the encoder output) is
  flash in the ``bidir`` mode with Sq != Skv; its decode
  (:func:`cross_decode_attention`) reads all of the cross cache.

The reference's sharding constraints stand at its points
(``parallel/sharding.py::constrain``): the expanded K/V, q and the output
projection.  On DTensors the heads stay split over ``model`` through
``expand_kv`` and into the kernel, which runs on each rank's shard.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..parallel.sharding import constrain, replicated
from .layers import rope
from .spec import ParamSpec

# ---------------------------------------------------------------------------
# Parameter spec
# ---------------------------------------------------------------------------

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


def _head_mask(cfg, device=None) -> torch.Tensor:
    return torch.arange(padded_heads(cfg), device=device) < cfg.n_heads


def expand_kv(cfg, kv: torch.Tensor, seq: str = "seq") -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hq_pad, Dh): the reference's per-head
    gather, KV head j serving q heads j*G .. j*G + G - 1 (G = n_heads //
    Hkv) and any head past Hkv * G (padded, or a group size that does not
    divide) the last KV head.  The result is one broadcast
    copy laid out head-major, ``(B, Hq_pad, S, Dh)`` in memory, so that
    the kernels' fold of heads (``t.transpose(1, 2).reshape(B * H, S,
    Dh)``) is a view of it (``index_select`` on the transposed cache runs
    as a gather at a quarter of the rate on the H100, PERF.md §6).  Heads
    past Hkv * G add a second copy; no config of the port has them.  The
    result is constrained as ``("batch", seq, "heads", "head_dim")``: a
    decode cache passes ``seq="kv_seq_mp"``, which keeps each rank's slots
    where they are (the heads then stay whole on a rank)."""
    B, S, Hkv, Dh = kv.shape
    G = cfg.n_heads // Hkv
    pad = padded_heads(cfg) - Hkv * G
    heads = kv.transpose(1, 2)[:, :, None].expand(B, Hkv, G, S, Dh)
    heads = heads.contiguous().view(B, Hkv * G, S, Dh)
    if pad:
        heads = torch.cat([heads, heads[:, -1:].expand(B, pad, S, Dh)], 1)
    return constrain(heads.transpose(1, 2),
                     ("batch", seq, "heads", "head_dim"))


# ---------------------------------------------------------------------------
# Core attention (flat layout: q/k/v all (B, S, H, Dh))
# ---------------------------------------------------------------------------

def attention_online(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     mode: str = "causal", window: int = 0,
                     chunk: int = 0) -> torch.Tensor:
    """Online-softmax attention (causal or bidirectional) over the whole
    sequence.  q: (B, Sq, H, Dh); k/v: (B, Skv, H, Dh)."""
    return kops.flash_attention(q, k, v, mode=mode, window=window,
                                chunk=chunk)


def attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     mode: str, window: int = 0,
                     chunk: int = 0) -> torch.Tensor:
    """Sliding-window or chunked-local self-attention (Skv == Sq); the
    kernel skips the key tiles outside the band."""
    if mode not in ("sliding", "chunked"):
        raise ValueError(mode)
    return kops.flash_attention(q, k, v, mode=mode, window=window,
                                chunk=chunk)


def attention(q, k, v, *, mode: str, window: int = 0,
              chunk: int = 0) -> torch.Tensor:
    """Dispatch: banded for sliding/chunked (when the band is a real
    subset), online-softmax otherwise."""
    Skv = k.shape[1]
    if mode == "sliding" and window < Skv:
        return attention_banded(q, k, v, mode="sliding", window=window)
    if mode == "chunked" and chunk < Skv:
        return attention_banded(q, k, v, mode="chunked", chunk=chunk)
    eff = "bidir" if mode == "bidir" else "causal"
    return attention_online(q, k, v, mode=eff)


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def decode_length(mode: str, pos: int, Sc: int, window: int = 0,
                  chunk: int = 0) -> int:
    """The reference's decode mask as a prefix length of the ring cache.

    After position ``pos`` is written, the ring of ``Sc`` slots holds the
    last ``min(pos + 1, Sc)`` positions, position p at slot p % Sc, so
    those lie in the leading slots.  The reference allows slots with
    ``0 <= slot_pos <= pos`` (and ``slot_pos > pos - window`` for sliding,
    ``slot_pos // chunk == pos // chunk`` for chunked): every held
    position for causal, and for sliding as long as ``Sc <= window`` (the
    cache's own length, ``min(window, max_seq)``); for chunked the
    current chunk's positions, which start at slot 0 when ``chunk``
    divides by ``Sc``.  A mask that is not a prefix raises."""
    n = min(pos + 1, Sc)
    if mode == "sliding" and window < n:
        raise ValueError(f"a sliding window of {window} over a ring of "
                         f"{Sc} slots is not a prefix of the cache")
    if mode == "chunked":
        start = pos - pos % chunk             # the chunk's first position
        if start > pos - n + 1:
            if start % Sc:
                raise ValueError(f"chunk {chunk} over a ring of {Sc} slots "
                                 f"at position {pos} is not a prefix of "
                                 f"the cache")
            n = pos - start + 1
    return n


def decode_attention(cfg, q1: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor, pos, *, mode: str, window: int = 0,
                     chunk: int = 0) -> torch.Tensor:
    """q1: (B, 1, Hq_pad, Dh); cache ck/cv: (B, Sc, Hkv, Dh), the ring of
    ``_to_cache``; pos: the current position, a host int (or 0-d CPU
    tensor).  Returns (B, 1, Hq_pad, Dh).  The reference masks by the
    cache's ``slot_pos``; the ring layout makes that mask a prefix of the
    cache (:func:`decode_length`), so no slot positions are read here.

    The cache is expanded to the q heads (one copy, ``expand_kv``) and
    read by the decode kernel, one query row per (batch, head).  A cache
    split over its slots (``kv_seq_mp``) stays so: each rank expands and
    reads its own slots, and ``ops.decode_attention`` merges the ranks'
    softmax pieces."""
    length = decode_length(mode, int(pos), ck.shape[1], window, chunk)
    return kops.decode_attention(q1, expand_kv(cfg, ck, "kv_seq_mp"),
                                 expand_kv(cfg, cv, "kv_seq_mp"), length)


# ---------------------------------------------------------------------------
# Full multi-head layer (projections + rope + core + output)
# ---------------------------------------------------------------------------

def project_heads(x: torch.Tensor, w: torch.Tensor, cd,
                  axis: str = "heads") -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w.astype(cd)); on DTensors the product's
    (heads x head_dim) columns are split over the mesh axes that divide
    the heads (``axis``, their logical name) before they unflatten."""
    d, h, dh = w.shape
    w2 = constrain(w.to(cd).reshape(d, h * dh), ("embed", axis), (d, h))
    y = x @ w2
    y = constrain(y, ("batch", "seq", axis), y.shape[:-1] + (h,))
    return y.unflatten(-1, (h, dh))


def project_qkv(cfg, p: dict, x: torch.Tensor, positions, *,
                use_rope: bool, compute_dtype):
    """x: (B,S,d) -> q (B,S,Hq_pad,Dh), k/v (B,S,Hkv,Dh)."""
    cd = compute_dtype
    q, k, v = (project_heads(x, p[w], cd, a) for w, a in (
        ("wq", "heads"), ("wk", "kv_heads"), ("wv", "kv_heads")))
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return constrain(q, ("batch", "seq", "heads", "head_dim")), k, v


def output_proj(cfg, p: dict, out: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    if padded_heads(cfg) != cfg.n_heads:   # a mask of ones is a no-op
        mask = replicated(_head_mask(cfg, out.device), out)
        out = out * mask[None, None, :, None].to(out.dtype)
    h, dh, d = p["wo"].shape
    wo = constrain(p["wo"].to(compute_dtype).reshape(h * dh, d),
                   ("heads", "embed"), (h, d))
    y = out.flatten(-2) @ wo
    return constrain(y, ("batch", "seq", "act_embed"))


def self_attention(cfg, p: dict, x: torch.Tensor, positions, *,
                   mode: str, use_rope: bool, compute_dtype,
                   window: int = 0, chunk: int = 0):
    """Training/prefill self-attention.  Returns (y, (k, v)), the raw KV
    for the cache."""
    q, k, v = project_qkv(cfg, p, x, positions, use_rope=use_rope,
                          compute_dtype=compute_dtype)
    ke, ve = expand_kv(cfg, k), expand_kv(cfg, v)
    out = attention(q, ke, ve, mode=mode, window=window, chunk=chunk)
    return output_proj(cfg, p, out, compute_dtype), (k, v)


def cross_kv(cfg, p: dict, enc_out: torch.Tensor, compute_dtype):
    """Project the encoder output (B, F, d) to un-expanded cross K/V
    (B, F, Hkv, Dh)."""
    return tuple(project_heads(enc_out, p[w], compute_dtype, "kv_heads")
                 for w in ("wk", "wv"))


def cross_attention(cfg, p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                    compute_dtype):
    """Decoder-to-encoder attention (whisper): every query row sees all F
    encoder positions (flash in the ``bidir`` mode, Sq != Skv).  Returns
    (y, (k, v)), the un-expanded cross K/V for the cache."""
    q = constrain(project_heads(x, p["wq"], compute_dtype),
                  ("batch", "seq", "heads", "head_dim"))
    k, v = cross_kv(cfg, p, enc_out, compute_dtype)
    out = attention(q, expand_kv(cfg, k), expand_kv(cfg, v), mode="bidir")
    return output_proj(cfg, p, out, compute_dtype), (k, v)


def cross_decode_attention(cfg, q1: torch.Tensor, xk: torch.Tensor,
                           xv: torch.Tensor) -> torch.Tensor:
    """One decode step's query (B, 1, Hq_pad, Dh) against the cross cache
    (B, F, Hkv, Dh).  The cross cache is no ring: the reference attends all
    F slots whatever the position (its ``slot_pos`` is ``arange(F)`` and
    its ``pos`` F), so the kernel reads F slots."""
    return kops.decode_attention(q1, expand_kv(cfg, xk), expand_kv(cfg, xv),
                                 xk.shape[1])
