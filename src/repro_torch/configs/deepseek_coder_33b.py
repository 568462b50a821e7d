"""DeepSeek-Coder-33B: llama-arch GQA kv=8.  [arXiv:2401.14196]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    attention="full",
    rope_theta=100_000.0,
    norm="rmsnorm",
    act="silu",
    mlp="glu",
    microbatch_rows_per_device=1,
    source="arXiv:2401.14196 (hf)",
))
