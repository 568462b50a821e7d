"""Granite-20B code: MQA (kv=1), llama-arch.  [arXiv:2405.04324]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    attention="full",
    norm="layernorm",
    act="gelu",
    mlp="dense",
    microbatch_rows_per_device=1,
    source="arXiv:2405.04324 (hf)",
))
