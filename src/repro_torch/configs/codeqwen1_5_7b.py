"""CodeQwen1.5-7B: qwen1.5 arch, full MHA (kv=32).  [hf:Qwen/CodeQwen1.5-7B]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    attention="full",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    mlp="glu",
    decode_kv_shard="heads",    # 32 kv heads shard cleanly over model=16
    microbatch_rows_per_device=2,
    source="hf:Qwen/CodeQwen1.5-7B (hf)",
))
