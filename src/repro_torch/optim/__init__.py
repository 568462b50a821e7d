"""Optimizers: AdamW (``adamw``) and int8 gradient compression with error
feedback (``grad_compress``)."""
from . import adamw, grad_compress
from .adamw import AdamWConfig, AdamWState, init_state, state_spec, \
    apply_updates, schedule, global_norm, clip_by_global_norm
