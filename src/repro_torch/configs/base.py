"""Architecture + shape configuration system (the port's own copy of the
reference's ``repro/configs/base.py``: pure dataclasses, field for field).

Every assigned architecture is an :class:`ArchConfig`; every workload shape an
entry of :data:`SHAPES`.  ``applicable_shapes`` encodes the skip rules:
``long_500k`` only for sub-quadratic-attention archs; decode shapes for
everything with a decoder (all ten archs here).
"""
from __future__ import annotations

import dataclasses
import math


# ---------------------------------------------------------------------------
# Shapes (LM family: seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    # backbone dims
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention flavour
    attention: str = "full"          # full | sliding | chunked_global
    window: int = 0                  # sliding-window size (starcoder2, rg local)
    chunk: int = 0                   # local-chunk size (llama4 iRoPE)
    global_every: int = 0            # every k-th layer global (llama4: 4)
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "dense"          # dense | ragged  (perf-iteration knob)
    shared_expert: bool = False      # llama4: one always-on shared expert
    # recurrent families
    block_pattern: tuple = ()        # e.g. ("rglru","rglru","attn") repeating
    lru_width: int = 0               # RG-LRU state width
    conv_width: int = 4              # temporal conv in recurrent blocks
    mlstm_chunk: int = 256           # chunkwise-parallel mLSTM chunk
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0             # stub frontend output length (1500 frames)
    # vlm prefix (internvl)
    n_prefix_tokens: int = 0         # precomputed patch embeddings, stubbed
    # misc
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    scale_embed: bool = False        # multiply embeddings by sqrt(d) (gemma)
    act: str = "silu"                # silu | gelu
    mlp: str = "glu"                 # glu | dense (2-matrix)
    tie_embeddings: bool = False
    # numerics / implementation
    head_pad_multiple: int = 1       # pad q-head count to this multiple (TP)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"              # full | none  (activation checkpointing)
    remat_group: int = 1             # checkpoint every g super-blocks
    microbatch_rows_per_device: int = 16   # batch rows/device per micro-step
    decode_kv_shard: str = "seq"     # seq | heads  (KV-cache model-axis shard)
    kv_cache_dtype: str = "bfloat16" # bfloat16 | int8 (quantized KV cache)
    prefill_waves: int = 1           # serve prefill in sequential batch waves
    source: str = ""                 # provenance note

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        return self.n_heads // self.n_kv_heads

    def padded_vocab(self, multiple: int = 256) -> int:
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    # -- analytic parameter counts (for roofline MODEL_FLOPS & ckpt bytes) ---
    def _attn_params(self) -> int:
        dh = self.resolved_head_dim
        return (self.d_model * self.n_heads * dh          # wq
                + 2 * self.d_model * self.n_kv_heads * dh  # wk, wv
                + self.n_heads * dh * self.d_model)        # wo

    def _mlp_params(self, d_ff: int) -> int:
        if d_ff == 0:
            return 0
        n_mat = 3 if self.mlp == "glu" else 2
        return n_mat * self.d_model * d_ff

    def _layer_params(self, kind: str) -> int:
        d = self.d_model
        norms = 2 * d
        if kind == "attn":
            body = self._attn_params() + self._mlp_params(self.d_ff)
        elif kind == "moe":
            router = d * self.n_experts
            experts = self.n_experts * self._mlp_params(self.d_ff)
            if self.shared_expert:
                experts += self._mlp_params(self.d_ff)
            body = self._attn_params() + router + experts
        elif kind == "rglru":
            w = self.lru_width or d
            # in/out projections, conv, block-diagonal gates (per head),
            # lambda + gated-mlp block
            body = (2 * d * w + w * d + self.conv_width * w
                    + 2 * w * w // max(self.n_heads, 1)
                    + 2 * w + self._mlp_params(self.d_ff))
        elif kind == "mlstm":
            w = 2 * d   # up-projection factor 2 (xLSTM paper)
            body = (d * 2 * w + w * d        # up (x2), down
                    + 3 * w * w // 1         # q,k,v within inner dim
                    + 3 * w)                 # i,f,o gate projections (scalar per head simplified)
        elif kind == "slstm":
            body = 4 * d * d + 4 * d * d + self._mlp_params(
                int(4 * d / 3) if self.d_ff == 0 else self.d_ff)
        else:
            raise ValueError(kind)
        return body + norms

    def layer_kinds(self) -> list:
        """Per-layer block kind, honoring block_pattern / moe / global_every."""
        kinds = []
        for i in range(self.n_layers):
            if self.block_pattern:
                kinds.append(self.block_pattern[i % len(self.block_pattern)])
            elif self.n_experts:
                kinds.append("moe")
            else:
                kinds.append("attn")
        return kinds

    def param_count(self) -> int:
        emb = self.padded_vocab() * self.d_model
        out = 0 if self.tie_embeddings else emb
        body = sum(self._layer_params(k) for k in self.layer_kinds())
        if self.is_encoder_decoder:
            # encoder stack (self-attn + mlp) + decoder cross-attn extra
            enc = self.n_encoder_layers * self._layer_params("attn")
            cross = self.n_layers * (self._attn_params() + self.d_model)
            body += enc + cross
        return emb + out + body + self.d_model  # final norm

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        expert_p = self._mlp_params(self.d_ff)
        inactive = (self.n_experts - self.top_k) * expert_p * sum(
            1 for k in self.layer_kinds() if k == "moe")
        return full - inactive

    def checkpoint_bytes(self, optimizer_slots: int = 2,
                         param_bytes: int = 4) -> int:
        """Bytes of a full training checkpoint: params + optimizer state.

        Default: fp32 params + 2 AdamW slots (m, v) in fp32.
        """
        return self.param_count() * param_bytes * (1 + optimizer_slots)

    def applicable_shapes(self) -> list:
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long_context():
            names.append("long_500k")
        return [SHAPES[n] for n in names]

    def supports_long_context(self) -> bool:
        """Sub-quadratic attention state -> long_500k runs."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.attention == "sliding" and self.window > 0:
            return True
        if self.attention == "chunked_global":
            return True      # llama4: bounded local KV; global layers seq-sharded
        return False


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # populate registry lazily
    from . import ALL_ARCHS  # noqa: F401  (import side effect registers all)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 64,
            n_heads: int = 4, seq_hint: int = 64) -> ArchConfig:
    """A tiny same-family config: few layers, small width, tiny vocab."""
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if n_heads % n_kv:
        n_kv = 1
    pattern = cfg.block_pattern
    if pattern:
        n_layers = max(n_layers, len(pattern))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=0 if cfg.d_ff == 0 else 4 * d_model,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=min(cfg.window, seq_hint // 2) if cfg.window else 0,
        chunk=min(cfg.chunk, seq_hint // 2) if cfg.chunk else 0,
        lru_width=d_model if cfg.lru_width else 0,
        mlstm_chunk=16,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 32) if cfg.encoder_seq else 0,
        n_prefix_tokens=min(cfg.n_prefix_tokens, 16) if cfg.n_prefix_tokens else 0,
        remat="none",
    )
