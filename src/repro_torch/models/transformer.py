"""Model assembly, driven by :class:`~repro_torch.configs.ArchConfig`.

Counterpart of the reference's ``repro/models/transformer.py``.  Layers are
grouped into repeating **super-blocks** (xLSTM's (mlstm, slstm),
RecurrentGemma's (rglru, rglru, attn)) whose parameters are stacked along a
leading ``layers`` axis; a non-dividing tail is unrolled.  The parameter
and cache trees cover all ten archs.  The full-sequence forward runs the
recurrent stack (mLSTM, sLSTM, and the RG-LRU layer's norm/MLP wrapper);
the attention, MoE, encoder and prefix kinds, the prefill cache and
decoding wait for ROADMAP A9c and raise.  The reference's ``lax.scan``
over super-blocks is a Python loop here, with ``remat == "full"`` as one
``torch.utils.checkpoint`` a layer (the reference checkpoints each layer
of a multi-kind super-block, and the body of a one-kind one).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ckpt.tree import tree_flatten, tree_map, tree_unflatten
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec
from .layers import (apply_norm, norm_spec, mlp_spec, apply_mlp, embed_spec,
                     embed_lookup, unembed, cross_entropy)
from .spec import ParamSpec, torch_dtype

RECURRENT_KINDS = ("mlstm", "slstm", "rglru")
_LATER = "is not ported yet (ROADMAP A9c)"


def ffn_kind(kind: str) -> str:
    """'moe:chunked' -> 'moe';  'attn' -> 'attn'."""
    return kind.split(":")[0]


def attn_kind(kind: str) -> str:
    """'moe:chunked' -> 'chunked';  'moe' -> 'moe'."""
    return kind.split(":")[-1]


# ---------------------------------------------------------------------------
# Super-block structure and parameter trees
# ---------------------------------------------------------------------------

def super_block(cfg):
    """(pattern, n_repeat, tail_kinds) for the decoder stack."""
    if cfg.block_pattern:
        pat = tuple(cfg.block_pattern)
        pat = tuple("sliding" if (k == "attn" and cfg.attention == "sliding")
                    else k for k in pat)
        n = cfg.n_layers // len(pat)
        tail = tuple(pat[i] for i in range(cfg.n_layers - n * len(pat)))
        return pat, n, tail
    if cfg.attention == "chunked_global" and cfg.global_every:
        g = cfg.global_every
        pre = "moe:" if cfg.n_experts else ""
        pat = tuple([pre + "chunked"] * (g - 1) + [pre + "global_nope"])
        n = cfg.n_layers // g
        tail = tuple(pat[i] for i in range(cfg.n_layers - n * g))
        return pat, n, tail
    if cfg.is_encoder_decoder:
        return ("xattn",), cfg.n_layers, ()
    kind = ("moe" if cfg.n_experts else
            ("sliding" if cfg.attention == "sliding" else "attn"))
    return (kind,), cfg.n_layers, ()


def _kind_spec(cfg, kind: str) -> dict:
    kind = ffn_kind(kind)
    d, dt = cfg.d_model, cfg.param_dtype
    nk = cfg.norm
    if kind in ("attn", "sliding", "chunked", "global_nope", "enc"):
        return {"ln1": norm_spec(d, nk),
                "attn": attn.attn_spec(cfg),
                "ln2": norm_spec(d, nk),
                "mlp": mlp_spec(d, cfg.d_ff, cfg.mlp, dt)}
    if kind == "xattn":
        return {"ln1": norm_spec(d, nk),
                "attn": attn.attn_spec(cfg),
                "lnx": norm_spec(d, nk),
                "xattn": attn.attn_spec(cfg, cross=True),
                "ln2": norm_spec(d, nk),
                "mlp": mlp_spec(d, cfg.d_ff, cfg.mlp, dt)}
    if kind == "moe":
        return {"ln1": norm_spec(d, nk),
                "attn": attn.attn_spec(cfg),
                "ln2": norm_spec(d, nk),
                "moe": moe_mod.moe_spec(cfg)}
    if kind == "rglru":
        return {"ln1": norm_spec(d, nk),
                "rglru": rec.rglru_spec(cfg),
                "ln2": norm_spec(d, nk),
                "mlp": mlp_spec(d, cfg.d_ff, cfg.mlp, dt)}
    if kind == "mlstm":
        return {"ln1": norm_spec(d, nk), "mlstm": rec.mlstm_spec(cfg)}
    if kind == "slstm":
        return {"ln1": norm_spec(d, nk), "slstm": rec.slstm_spec(cfg)}
    raise ValueError(kind)


def _stack(spec_tree, n: int):
    def add(s: ParamSpec):
        return ParamSpec((n,) + s.shape, ("layers",) + s.logical, s.dtype,
                         s.init, fan_axis=-2 if len(s.shape) >= 2 else -1)
    return tree_map(add, spec_tree)


def model_spec(cfg) -> dict:
    """Full parameter tree of ParamSpec leaves."""
    d, dt = cfg.d_model, cfg.param_dtype
    pat, n, tail = super_block(cfg)
    spec: dict = {
        "embed": embed_spec(cfg.padded_vocab(), d, dt),
        "final_norm": norm_spec(d, cfg.norm),
        "stages": tuple(_stack(_kind_spec(cfg, k), n) for k in pat),
        "tail": tuple(_kind_spec(cfg, k) for k in tail),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((d, cfg.padded_vocab()),
                                    ("embed", "vocab"), dt)
    if cfg.is_encoder_decoder:
        spec["encoder"] = {
            "stage": _stack(_kind_spec(cfg, "enc"), cfg.n_encoder_layers),
            "final_norm": norm_spec(d, cfg.norm),
        }
    return spec


def _cache_len(cfg, kind: str, max_seq: int) -> int:
    kind = attn_kind(kind)
    if kind == "sliding":
        return min(cfg.window, max_seq)
    if kind == "chunked":
        return min(cfg.chunk, max_seq)
    return max_seq


def cache_spec(cfg, batch: int, max_seq: int) -> dict:
    """Tree of ParamSpec describing the decode cache."""
    pat, n, tail = super_block(cfg)
    cd = cfg.compute_dtype
    dh = cfg.resolved_head_dim

    def kv_entry(kind, stacked_n):
        Sc = _cache_len(cfg, kind, max_seq)
        lead = (stacked_n,) if stacked_n is not None else ()
        lg = ("layers",) if stacked_n is not None else ()
        kvd = "int8" if cfg.kv_cache_dtype == "int8" else cd
        e = {"k": ParamSpec(lead + (batch, Sc, cfg.n_kv_heads, dh),
                            lg + ("batch", "kv_seq_mp", "kv_heads",
                                  "head_dim"), kvd),
             "v": ParamSpec(lead + (batch, Sc, cfg.n_kv_heads, dh),
                            lg + ("batch", "kv_seq_mp", "kv_heads",
                                  "head_dim"), kvd)}
        if cfg.kv_cache_dtype == "int8":
            e["k_scale"] = ParamSpec(
                lead + (batch, Sc, cfg.n_kv_heads),
                lg + ("batch", "kv_seq_mp", "kv_heads"), "bfloat16")
            e["v_scale"] = ParamSpec(
                lead + (batch, Sc, cfg.n_kv_heads),
                lg + ("batch", "kv_seq_mp", "kv_heads"), "bfloat16")
        if kind == "xattn":
            F = cfg.encoder_seq
            e["xk"] = ParamSpec(lead + (batch, F, cfg.n_kv_heads, dh),
                                lg + ("batch", None, "kv_heads", "head_dim"),
                                cd)
            e["xv"] = ParamSpec(lead + (batch, F, cfg.n_kv_heads, dh),
                                lg + ("batch", None, "kv_heads", "head_dim"),
                                cd)
        return e

    def state_entry(kind, stacked_n):
        lead = (stacked_n,) if stacked_n is not None else ()
        lg = ("layers",) if stacked_n is not None else ()
        if kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            return rec.RGLRUState(
                h=ParamSpec(lead + (batch, w), lg + ("batch", "lru"),
                            "float32"),
                conv=ParamSpec(lead + (batch, cfg.conv_width - 1, w),
                               lg + ("batch", None, "lru"), "float32"))
        if kind == "mlstm":
            h = cfg.n_heads
            dhh = 2 * cfg.d_model // h
            return rec.MLSTMState(
                C=ParamSpec(lead + (batch, h, dhh, dhh),
                            lg + ("batch", "heads", None, None), "float32"),
                n=ParamSpec(lead + (batch, h, dhh),
                            lg + ("batch", "heads", None), "float32"),
                m=ParamSpec(lead + (batch, h), lg + ("batch", "heads"),
                            "float32"))
        if kind == "slstm":
            d = cfg.d_model
            z = lambda: ParamSpec(lead + (batch, d), lg + ("batch", "lru"),
                                  "float32")
            return rec.SLSTMState(c=z(), n=z(), m=z(), h=z())
        raise ValueError(kind)

    def entry(kind, stacked_n):
        if ffn_kind(kind) in RECURRENT_KINDS:
            return state_entry(kind, stacked_n)
        return kv_entry(kind, stacked_n)

    slot_pos = {}
    for kind in {attn_kind(k) for k in set(pat) | set(tail)}:
        if kind in RECURRENT_KINDS + ("enc",):
            continue
        Sc = _cache_len(cfg, kind, max_seq)
        slot_pos[kind] = ParamSpec((Sc,), (None,), "int32")

    return {
        "layers": {
            "stages": tuple(entry(k, n) for k in pat),
            "tail": tuple(entry(k, None) for k in tail),
        },
        "pos": ParamSpec((), (), "int32"),
        "slot_pos": slot_pos,
    }


# ---------------------------------------------------------------------------
# Full-sequence forward (train)
# ---------------------------------------------------------------------------

def apply_layer_full(cfg, kind: str, p: dict, x: torch.Tensor,
                     positions: torch.Tensor, *, collect_cache: bool,
                     max_seq: int, enc_kv=None):
    """One block over the full sequence.  Returns (x, cache_entry)."""
    cd = torch_dtype(cfg.compute_dtype)
    if kind not in RECURRENT_KINDS:
        raise NotImplementedError(f"the {kind!r} layer {_LATER}")
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind == "rglru":
        y, state = rec.rglru_block(cfg, p["rglru"], h, cd)
        x = x + y
        h2 = apply_norm(p["ln2"], x, cfg.norm)
        x = x + apply_mlp(p["mlp"], h2, cfg.mlp, cfg.act, cd)
    elif kind == "mlstm":
        y, state = rec.mlstm_block(cfg, p["mlstm"], h, cd)
        x = x + y
    else:
        y, state = rec.slstm_block(cfg, p["slstm"], h, cd)
        x = x + y
    return x, (state if collect_cache else None)


def _unstack(tree, n: int) -> list:
    """The ``n`` per-layer slices of a stacked tree, by ``unbind`` (whose
    gradient is one stack a leaf, not ``n`` scatters)."""
    leaves, td = tree_flatten(tree)
    parts = [x.unbind(0) for x in leaves]
    return [tree_unflatten(td, [u[i] for u in parts]) for i in range(n)]


def _run_stack(cfg, params, x, positions, *, collect_cache: bool,
               max_seq: int, enc_kv=None):
    pat, n, tail = super_block(cfg)
    g = max(1, getattr(cfg, "remat_group", 1))
    if g > 1 and n % g == 0:
        raise NotImplementedError("remat_group > 1 (two-level remat) is "
                                  "not ported yet: no ported arch sets it")

    def layer(kind, xh, psl):
        return apply_layer_full(cfg, kind, psl, xh, positions,
                                collect_cache=collect_cache, max_seq=max_seq,
                                enc_kv=enc_kv)

    def run(kind, xh, psl):
        if cfg.remat == "full" and torch.is_grad_enabled():
            return checkpoint(layer, kind, xh, psl, use_reentrant=False)
        return layer(kind, xh, psl)

    slices = [_unstack(stage, n) for stage in params["stages"]]
    stage_caches = []
    for i in range(n):
        entries = []
        for j, kind in enumerate(pat):
            x, entry = run(kind, x, slices[j][i])
            entries.append(entry)
        stage_caches.append(tuple(entries))
    tail_caches = []
    for kind, psl in zip(tail, params["tail"]):
        x, entry = layer(kind, x, psl)
        tail_caches.append(entry)
    return x, {"stages": stage_caches, "tail": tuple(tail_caches)}


def _embed_inputs(cfg, params, tokens, prefix=None):
    cd = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, cd)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cd, device=x.device)
    if prefix is not None:
        x = torch.cat([prefix.to(cd), x], dim=1)
    return x


def forward(cfg, params, tokens, *, prefix=None, frames=None,
            collect_cache: bool = False, max_cache_seq: Optional[int] = None):
    """Full-sequence forward.  Returns (logits, None).

    tokens: (B, S) integer.  The encoder (whisper) and the prefill cache
    (``collect_cache=True``) wait for ROADMAP A9c."""
    if cfg.is_encoder_decoder or frames is not None:
        raise NotImplementedError(f"the encoder-decoder forward {_LATER}")
    if collect_cache:
        raise NotImplementedError(f"prefill with a cache {_LATER}")
    cd = torch_dtype(cfg.compute_dtype)
    x = _embed_inputs(cfg, params, tokens, prefix)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, _ = _run_stack(cfg, params, x, positions, collect_cache=False,
                      max_seq=max_cache_seq or S)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cd, transpose=True)
    else:
        logits = unembed(params["lm_head"], x, cd, transpose=False)
    return logits, None


def loss_fn(cfg, params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy; prefix handled as the reference."""
    logits, _ = forward(cfg, params, batch["tokens"],
                        prefix=batch.get("prefix"),
                        frames=batch.get("frames"))
    labels = batch["labels"]
    if batch.get("prefix") is not None:
        logits = logits[:, batch["prefix"].shape[1]:]
    mask = labels >= 0
    labels = torch.clamp_min(labels, 0)
    return cross_entropy(logits, labels, mask, real_vocab=cfg.vocab_size)
