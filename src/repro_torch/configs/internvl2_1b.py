"""InternVL2-1B: Qwen2-0.5B LM backbone + InternViT frontend STUBBED —
input_specs provides precomputed patch embeddings prepended to the token
sequence (early fusion).  [arXiv:2404.16821]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,       # padded to 151680 for TP sharding
    n_prefix_tokens=256,     # ViT patch embeddings (stub)
    attention="full",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    mlp="glu",
    tie_embeddings=True,
    microbatch_rows_per_device=16,
    source="arXiv:2404.16821 (hf)",
))
