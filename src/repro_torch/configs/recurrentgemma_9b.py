"""RecurrentGemma-9B: RG-LRU recurrent blocks + local attention (window
2048), repeating pattern (recurrent, recurrent, attention).  [arXiv:2402.19427]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,            # MQA in the local-attention blocks
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=4096,
    conv_width=4,
    attention="sliding",
    window=2048,
    norm="rmsnorm",
    scale_embed=True,
    act="gelu",
    mlp="glu",
    microbatch_rows_per_device=2,
    source="arXiv:2402.19427 (unverified)",
))
