"""Llama-4 Scout 17B-active/16E: MoE top-1 + shared expert, iRoPE
(3/4 layers chunked-local attention, every 4th layer global NoPE).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    shared_expert=True,
    attention="chunked_global",
    chunk=8192,
    global_every=4,
    rope_theta=500_000.0,
    norm="rmsnorm",
    act="silu",
    mlp="glu",
    microbatch_rows_per_device=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
))
