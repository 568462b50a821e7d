"""xLSTM-125M: alternating mLSTM/sLSTM blocks, no separate FFN (d_ff=0,
projections live inside the blocks).  [arXiv:2405.04517]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    mlstm_chunk=256,
    attention="full",        # unused; recurrence is sub-quadratic
    norm="layernorm",
    act="gelu",
    microbatch_rows_per_device=8,
    source="arXiv:2405.04517 (unverified)",
))
