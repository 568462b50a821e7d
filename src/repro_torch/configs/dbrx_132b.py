"""DBRX-132B: fine-grained MoE, 16 experts top-4.  [hf:databricks/dbrx-base]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,           # GQA
    d_ff=10752,             # per-expert GLU hidden
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    attention="full",
    rope_theta=500_000.0,
    norm="layernorm",
    act="silu",
    mlp="glu",
    microbatch_rows_per_device=1,
    source="hf:databricks/dbrx-base (unverified)",
))
