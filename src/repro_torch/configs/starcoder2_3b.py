"""StarCoder2-3B: GQA kv=2, RoPE, sliding-window 4096 attention.
[arXiv:2402.19173]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    attention="sliding",
    window=4096,
    rope_theta=999_999.0,
    norm="layernorm",
    act="gelu",
    mlp="dense",
    microbatch_rows_per_device=4,
    source="arXiv:2402.19173 (hf)",
))
