"""Model assembly, driven by :class:`~repro_torch.configs.ArchConfig`.

Counterpart of the reference's ``repro/models/transformer.py``.  Layers are
grouped into repeating **super-blocks** (xLSTM's (mlstm, slstm),
RecurrentGemma's (rglru, rglru, attn)) whose parameters are stacked along a
leading ``layers`` axis; a non-dividing tail is unrolled.  The same stacks
drive ``forward`` (train), the prefill (``collect_cache=True``: the
next-token logits and a KV/state cache) and ``decode_step`` (one token
against the cache).  The reference's ``lax.scan`` over super-blocks is a
Python loop here, with ``remat == "full"`` as one
``torch.utils.checkpoint`` a layer (the reference checkpoints each layer
of a multi-kind super-block, and the body of a one-kind one).

KV caches are ring buffers of per-kind size (the full context for full
attention, ``window`` for sliding, ``chunk`` for chunked-local) with
absolute slot positions.  The cache's ``pos`` (a 0-d int32 tensor) and
``slot_pos`` (one (Sc,) int32 tensor a cache length) stay on the host, so
a decode step works out each kind's mask there and never reads the
device; ``decode_step`` writes the new token's K/V and the recurrent
states into the cache's tensors in place.

Every kind runs: the attention kinds (causal, sliding, chunked, global
NoPE), their MoE-FFN forms (``moe:*``), whisper's encoder (``enc``) and
decoder (``xattn``: self-attention, then cross-attention over the
encoder output, whose K/V the cache keeps unquantized), and the
recurrent kinds; ``forward`` takes internvl's prefix embeddings and
whisper's frames.

The reference's sharding constraints stand at its points
(``parallel/sharding.py::constrain``); with parameters and a batch that
are DTensors (``sharding.place_tree``) under an active mesh, ``forward``
and the train step run sharded, the positions and position tables entering
as replicated DTensors.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ckpt.tree import tree_flatten, tree_map, tree_unflatten
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec
from ..parallel.sharding import (constrain, like_placements, replicated,
                                 set_index)
from .layers import (apply_norm, norm_spec, mlp_spec, apply_mlp, embed_spec,
                     embed_lookup, unembed, cross_entropy,
                     sinusoidal_positions)
from .spec import ParamSpec, torch_dtype

F32 = torch.float32

RECURRENT_KINDS = ("mlstm", "slstm", "rglru")


def _kv_quant(k: torch.Tensor):
    """Per-(batch, slot, head) absmax int8 quantization of K/V."""
    k32 = k.to(F32)
    scale = k32.abs().amax(dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(k32 / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale.to(torch.bfloat16)


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


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
# Per-kind forward (full-sequence mode: train / prefill)
# ---------------------------------------------------------------------------

def _attn_mode(kind: str) -> tuple:
    """kind -> (mode, use_rope_default)"""
    kind = attn_kind(kind)
    return {
        "attn": ("causal", True),
        "moe": ("causal", True),            # MoE blocks use standard attention
        "sliding": ("sliding", True),
        "chunked": ("chunked", True),
        "global_nope": ("causal", False),   # llama4 NoPE global layers
        "enc": ("bidir", False),
        "xattn": ("causal", False),         # whisper: sinusoidal, not rope
    }[kind]


def apply_layer_full(cfg, kind: str, p: dict, x: torch.Tensor,
                     positions: torch.Tensor, *, collect_cache: bool,
                     max_seq: int, enc_kv=None):
    """One block over the full sequence.  Returns (x, cache_entry)."""
    cd = torch_dtype(cfg.compute_dtype)
    if kind in RECURRENT_KINDS:
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

    mode, use_rope = _attn_mode(kind)
    if cfg.is_encoder_decoder:
        use_rope = False
    h = apply_norm(p["ln1"], x, cfg.norm)
    y, (k, v) = attn.self_attention(
        cfg, p["attn"], h, positions, mode=mode, use_rope=use_rope,
        compute_dtype=cd, window=cfg.window, chunk=cfg.chunk)
    x = x + y
    cross = None
    if kind == "xattn":
        hx = apply_norm(p["lnx"], x, cfg.norm)
        y, cross = attn.cross_attention(cfg, p["xattn"], hx, enc_kv, cd)
        x = x + y
    x = x + _ffn(cfg, kind, p, x, cd)
    if not collect_cache or kind == "enc":
        return x, None
    Sc = _cache_len(cfg, kind, max_seq)
    kc, vc = (constrain(_to_cache(t, Sc), ("batch", "kv_seq_mp", "kv_heads",
                                           "head_dim")) for t in (k, v))
    if cfg.kv_cache_dtype == "int8":
        kc, ks = _kv_quant(kc)
        vc, vs = _kv_quant(vc)
        entry = {"k": kc, "k_scale": ks, "v": vc, "v_scale": vs}
    else:
        entry = {"k": kc, "v": vc}
    if kind == "xattn":
        entry["xk"], entry["xv"] = cross
    return x, entry


def _ffn(cfg, kind: str, p: dict, x: torch.Tensor, cd) -> torch.Tensor:
    """The block's second residual branch: the MoE FFN or the MLP."""
    h2 = apply_norm(p["ln2"], x, cfg.norm)
    if ffn_kind(kind) == "moe":
        return moe_mod.moe_ffn(cfg, p["moe"], h2, cd)
    return apply_mlp(p["mlp"], h2, cfg.mlp, cfg.act, cd)


def _to_cache(k: torch.Tensor, Sc: int) -> torch.Tensor:
    """Lay out prefilled K/V (B, S, H, Dh) as a ring buffer of length Sc
    where absolute position p sits at slot p % Sc.  The roll is two
    slices joined (``torch.roll`` has no DTensor rule in every torch the
    port runs on)."""
    S = k.shape[1]
    if S >= Sc:
        last, r = k[:, -Sc:], (S - Sc) % Sc
        return torch.cat([last[:, Sc - r:], last[:, :Sc - r]], dim=1) \
            if r else last
    pad = k.new_zeros((k.shape[0], Sc - S) + tuple(k.shape[2:]))
    return torch.cat([k, pad], dim=1)


def _unstack(tree, n: int) -> list:
    """The ``n`` per-layer slices of a stacked tree, by ``unbind`` (whose
    gradient is one stack a leaf, not ``n`` scatters)."""
    leaves, td = tree_flatten(tree)
    parts = [x.unbind(0) for x in leaves]
    return [tree_unflatten(td, [u[i] for u in parts]) for i in range(n)]


def _carry(x: torch.Tensor) -> torch.Tensor:
    """A layer's output as the next layer takes it: the reference's
    ``lax.scan`` keeps its carry in the sharding of the carry it starts
    from, the embedding's ``("batch", "seq", "act_embed")``, so the
    partial sums of a layer's last product are reduced at its end (left
    ``Partial``, they would reach the next layer's products, where DTensor
    may split the sequence instead, unevenly where ``model`` does not
    divide it)."""
    return constrain(x, ("batch", "seq", "act_embed"))


def _run_stack(cfg, params, x, positions, *, collect_cache: bool,
               max_seq: int, enc_kv=None):
    """The stages' super-blocks, then the tail.  Under ``remat="full"``
    with grad, each layer runs under ``torch.utils.checkpoint``; with
    ``remat_group = g > 1`` dividing the super-blocks, each group of g
    super-blocks runs under one more checkpoint around those (the
    reference's two-level remat: the outer level keeps one input a group,
    the inner one, a layer's, keeps the backward's recompute to one layer,
    as the reference's per-layer checkpoints of a multi-kind super-block
    do)."""
    pat, n, tail = super_block(cfg)
    g = max(1, getattr(cfg, "remat_group", 1))
    if n % g:
        g = 1
    remat = cfg.remat == "full" and torch.is_grad_enabled()

    def layer(kind, xh, psl):
        xh, entry = apply_layer_full(cfg, kind, psl, xh, positions,
                                     collect_cache=collect_cache,
                                     max_seq=max_seq, enc_kv=enc_kv)
        return _carry(xh), entry

    def run(kind, xh, psl):
        if remat:
            return checkpoint(layer, kind, xh, psl, use_reentrant=False)
        return layer(kind, xh, psl)

    def group(xh, *psls):
        """g super-blocks, ``psls`` their layers' params in order.  Returns
        (x, their entries by kind)."""
        out = [[] for _ in pat]
        for i in range(g):
            for j, kind in enumerate(pat):
                xh, entry = run(kind, xh, psls[i * len(pat) + j])
                out[j].append(entry)
        return xh, out

    slices = [_unstack(stage, n) for stage in params["stages"]]
    entries = [[] for _ in pat]
    for i0 in range(0, n, g):
        psls = [slices[j][i] for i in range(i0, i0 + g)
                for j in range(len(pat))]
        if remat and g > 1:
            x, got = checkpoint(group, x, *psls, use_reentrant=False)
        else:
            x, got = group(x, *psls)
        for j in range(len(pat)):
            entries[j] += got[j]
    tail_caches = []
    for kind, psl in zip(tail, params["tail"]):
        x, entry = layer(kind, x, psl)
        tail_caches.append(entry)
    # the reference's scan stacks each kind's entries: leading (n,)
    if not collect_cache:
        stage_caches = ()
    elif n:
        stage_caches = tuple(_stack_trees(e) for e in entries)
    else:     # no whole super-block (llama4 cut below 4 layers): (0, ...)
        spec = cache_spec(cfg, x.shape[0], max_seq)["layers"]["stages"]
        stage_caches = tree_map(lambda s: torch.empty(
            s.shape, dtype=torch_dtype(s.dtype), device=x.device), spec)
    return x, {"stages": stage_caches, "tail": tuple(tail_caches)}


def _stack_trees(trees: list):
    """One tree whose leaves stack the ``trees``' leaves on a new axis 0."""
    flat = [tree_flatten(t) for t in trees]
    td = flat[0][1]
    return tree_unflatten(td, [torch.stack(xs) for xs in
                               zip(*(leaves for leaves, _ in flat))])


def _run_encoder(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """whisper's encoder over stub frame embeddings (B, F, d): sinusoidal
    positions, the ``enc`` layers (bidirectional, no cache), the final
    norm."""
    cd = torch_dtype(cfg.compute_dtype)
    x = frames.to(cd)
    F = x.shape[1]
    x = x + replicated(sinusoidal_positions(F, cfg.d_model,
                                            device=x.device).to(cd)[None], x)
    positions = replicated(torch.arange(F, device=x.device), x)
    stage = params["encoder"]["stage"]

    def layer(xh, psl):
        return _carry(apply_layer_full(cfg, "enc", psl, xh, positions,
                                       collect_cache=False, max_seq=F)[0])

    for psl in _unstack(stage, cfg.n_encoder_layers):
        if cfg.remat == "full" and torch.is_grad_enabled():
            x = checkpoint(layer, x, psl, use_reentrant=False)
        else:
            x = layer(x, psl)
    return apply_norm(params["encoder"]["final_norm"], x, cfg.norm)


def _embed_inputs(cfg, params, tokens, prefix=None):
    cd = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, cd)
    if cfg.scale_embed:
        # the reference's constant, rounded to cd on the host (a device
        # constant would be a host-to-device copy, which synchronises)
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cd))
    if prefix is not None:
        x = torch.cat([replicated(prefix.to(cd), x), x], dim=1)
        x = constrain(x, ("batch", "seq", "act_embed"))
    return x


def _logits(cfg, params, x):
    """The final norm and the (tied or untied) unembedding."""
    cd = torch_dtype(cfg.compute_dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, cd, transpose=True)
    return unembed(params["lm_head"], x, cd, transpose=False)


def forward(cfg, params, tokens, *, prefix=None, frames=None,
            collect_cache: bool = False, max_cache_seq: Optional[int] = None):
    """Full-sequence forward.  Returns (logits, cache_or_None).

    tokens: (B, S) integer; prefix: (B, P, d) early-fusion embeddings
    (internvl), put before the tokens; frames: (B, F, d) stub audio frame
    embeddings (whisper), run through the encoder.  With ``collect_cache``
    (serving prefill) the logits are the last position's, (B, 1, V), and
    the cache holds the ring buffers of ``max_cache_seq`` (default: the
    sequence, prefix included) positions."""
    cd = torch_dtype(cfg.compute_dtype)
    enc_kv = None
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward "
                             f"needs frames")
        enc_kv = _run_encoder(cfg, params, frames)
    x = _embed_inputs(cfg, params, tokens, prefix)
    S = x.shape[1]
    if cfg.is_encoder_decoder:
        x = x + replicated(sinusoidal_positions(
            S, cfg.d_model, device=x.device).to(cd)[None], x)
    positions = replicated(torch.arange(S, device=x.device), x)
    max_seq = max_cache_seq or S
    x, caches = _run_stack(cfg, params, x, positions,
                           collect_cache=collect_cache, max_seq=max_seq,
                           enc_kv=enc_kv)
    if collect_cache:
        # serving prefill: only the next-token logits are needed
        x = x[:, -1:]
    logits = _logits(cfg, params, x)
    if not collect_cache:
        return logits, None
    cache = {"layers": caches, "pos": torch.tensor(S, dtype=torch.int32),
             "slot_pos": _prefill_slot_pos(cfg, S, max_seq)}
    return logits, cache


def _prefill_slot_pos(cfg, S: int, max_seq: int) -> dict:
    """Absolute slot positions per distinct cache length (-1 = empty), on
    the host."""
    pat, _, tail = super_block(cfg)
    out = {}
    for kind in {attn_kind(k) for k in set(pat) | set(tail)}:
        if kind in RECURRENT_KINDS + ("enc",):
            continue
        Sc = _cache_len(cfg, kind, max_seq)
        if S >= Sc:
            pos = torch.arange(S - Sc, S, dtype=torch.int32)
            out[kind] = torch.roll(pos, (S - Sc) % Sc)
        else:
            out[kind] = torch.cat([torch.arange(S, dtype=torch.int32),
                                   torch.full((Sc - S,), -1,
                                              dtype=torch.int32)])
    return out


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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def apply_layer_decode(cfg, kind: str, p: dict, x: torch.Tensor, entry,
                       pos, enc_out=None):
    """One block for a single token.  x: (B, 1, d); pos: the host int
    position.  Returns (x, new_entry): an attention kind's new K/V are
    written into ``entry``'s tensors at slot ``pos % Sc`` (in place; of a
    cache split over its slots, by the rank that holds the slot), a
    recurrent kind's state is new.  An ``xattn`` block also attends the
    entry's cross K/V, all of it."""
    cd = torch_dtype(cfg.compute_dtype)
    if kind in RECURRENT_KINDS:
        h = apply_norm(p["ln1"], x, cfg.norm)
        if kind == "rglru":
            y, state = rec.rglru_block(cfg, p["rglru"], h, cd, state=entry)
            x = x + y
            h2 = apply_norm(p["ln2"], x, cfg.norm)
            x = x + apply_mlp(p["mlp"], h2, cfg.mlp, cfg.act, cd)
        elif kind == "mlstm":
            y, state = rec.mlstm_block(cfg, p["mlstm"], h, cd, state=entry)
            x = x + y
        else:
            y, state = rec.slstm_block(cfg, p["slstm"], h, cd, state=entry)
            x = x + y
        return x, state

    mode, use_rope = _attn_mode(kind)
    if cfg.is_encoder_decoder:
        use_rope = False
    h = apply_norm(p["ln1"], x, cfg.norm)
    positions = torch.arange(pos, pos + 1, device=x.device)
    q, k1, v1 = attn.project_qkv(cfg, p["attn"], h, positions,
                                 use_rope=use_rope, compute_dtype=cd)
    Sc = entry["k"].shape[1]
    slot = pos % Sc
    ck, cv = entry["k"], entry["v"]
    if cfg.kv_cache_dtype == "int8":
        k1q, k1s = _kv_quant(k1)
        v1q, v1s = _kv_quant(v1)
        for key, new in (("k", k1q), ("v", v1q), ("k_scale", k1s),
                         ("v_scale", v1s)):
            set_index(entry[key], 1, slot, new[:, 0])
        ck_c = _kv_dequant(ck, entry["k_scale"], cd)
        cv_c = _kv_dequant(cv, entry["v_scale"], cd)
    else:
        set_index(ck, 1, slot, k1[:, 0])
        set_index(cv, 1, slot, v1[:, 0])
        ck_c, cv_c = ck, cv
    out = attn.decode_attention(cfg, q, ck_c, cv_c, pos, mode=mode,
                                window=cfg.window, chunk=cfg.chunk)
    x = x + attn.output_proj(cfg, p["attn"], out, cd)
    if kind == "xattn":
        hx = apply_norm(p["lnx"], x, cfg.norm)
        qx = attn.project_heads(hx, p["xattn"]["wq"], cd)
        o = attn.cross_decode_attention(cfg, qx, entry["xk"], entry["xv"])
        x = x + attn.output_proj(cfg, p["xattn"], o, cd)
    x = x + _ffn(cfg, kind, p, x, cd)
    return x, entry


def decode_step(cfg, params, cache, token):
    """token: (B, 1) integer.  Returns (logits (B, 1, V), new_cache).

    The cache's K/V and state tensors are updated in place (the cache
    passed in is consumed); the new cache shares them, with ``pos`` one
    further and the current slot marked in ``slot_pos``.  Nothing here
    reads the device: ``pos`` and ``slot_pos`` live on the host.  A cache
    of DTensors (a sharded prefill's) keeps every leaf's placements."""
    pat, n, tail = super_block(cfg)
    pos = int(cache["pos"])
    # the reference's slot positions, kept in the cache's tree; the mask
    # itself is a prefix of the ring (attention.decode_length)
    slot_pos = {}
    for k, v in cache["slot_pos"].items():
        v = v.clone()
        v[pos % v.shape[0]] = pos
        slot_pos[k] = v
    x = _embed_inputs(cfg, params, token)
    if cfg.is_encoder_decoder:
        cd = torch_dtype(cfg.compute_dtype)
        x = x + replicated(sinusoidal_positions(
            1, cfg.d_model, offset=pos, device=x.device).to(cd), x)

    pslices = [_unstack(stage, n) for stage in params["stages"]]
    stages = cache["layers"]["stages"]
    cslices = [_unstack(stage, n) for stage in stages]
    for i in range(n):
        for j, kind in enumerate(pat):
            ent = cslices[j][i]
            x, ne = apply_layer_decode(cfg, kind, pslices[j][i], x, ent,
                                       pos)
            if kind in RECURRENT_KINDS:     # into the stacked state, in place
                for old, new in zip(tree_flatten(ent)[0],
                                    tree_flatten(ne)[0]):
                    old.copy_(like_placements(new, old))

    new_tail = []
    for kind, psl, ent in zip(tail, params["tail"],
                              cache["layers"]["tail"]):
        x, ne = apply_layer_decode(cfg, kind, psl, x, ent, pos)
        if kind in RECURRENT_KINDS:         # in the cache's placements
            ne = type(ne)(*(like_placements(a, b) for a, b in zip(ne, ent)))
        new_tail.append(ne)

    logits = _logits(cfg, params, x)
    new_cache = dict(cache)
    new_cache["layers"] = {"stages": stages, "tail": tuple(new_tail)}
    new_cache["pos"] = torch.tensor(pos + 1, dtype=torch.int32)
    new_cache["slot_pos"] = slot_pos
    return logits, new_cache
