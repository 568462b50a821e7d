"""Whisper-tiny: encoder-decoder, conv audio frontend STUBBED — input_specs
provides precomputed (batch, 1500, d_model) frame embeddings.  [arXiv:2212.04356]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,        # padded to 51968 for TP sharding
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
    attention="full",
    norm="layernorm",
    act="gelu",
    mlp="dense",
    tie_embeddings=True,
    microbatch_rows_per_device=16,
    source="arXiv:2212.04356 (unverified)",
))
