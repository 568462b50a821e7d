"""Deterministic synthetic LM data pipeline with checkpointable state.

Counterpart of the reference's ``repro/data/synthetic.py``.  Batches are a
pure function of (seed, step), drawn on the host by the reference's numpy
stream, so a restored iterator resumes the exact token stream and every
(seed, step) gives the reference's tokens bit for bit; they are moved to
the caller's device once a batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_prefix_tokens: int = 0
    prefix_dim: int = 0
    encoder_seq: int = 0
    encoder_dim: int = 0


class SyntheticLM:
    """Zipf-ish token stream; next-token labels; optional stub modalities.
    Batches land on ``device`` (``peek`` may name another)."""

    def __init__(self, cfg: DataConfig, step: int = 0, device="cuda"):
        self.cfg = cfg
        self.step = step
        self.device = device

    # --- checkpointable state -------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"data seed mismatch: {state['seed']} against "
                             f"{self.cfg.seed}")
        self.step = int(state["step"])

    # --- batches -----------------------------------------------------------
    def _tokens(self, rng: np.random.Generator, shape) -> np.ndarray:
        # Zipf-like marginal over the vocab (heavier head than uniform).
        u = rng.random(shape)
        z = (self.cfg.vocab_size ** u - 1.0) / (self.cfg.vocab_size - 1.0)
        return np.minimum((z * self.cfg.vocab_size).astype(np.int32),
                          self.cfg.vocab_size - 1)

    def peek(self, step: Optional[int] = None, device=None) -> dict:
        """The batch of ``step`` (default: the current one): int32
        ``tokens`` and ``labels`` (B, S), and f32 stub modalities."""
        c = self.cfg
        dev = resolve_device(self.device if device is None else device)
        s = self.step if step is None else step
        # reprolint: disable=RPL001 (the data stream must stay a pure function of (config seed, step), the reference's stream bit for bit, so that a resumed run replays it; the reference seeds at the same line)
        rng = np.random.default_rng((c.seed << 20) ^ s)
        toks = self._tokens(rng, (c.batch, c.seq_len + 1))
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        batch = {"tokens": put(toks[:, :-1]), "labels": put(toks[:, 1:])}
        if c.n_prefix_tokens:
            batch["prefix"] = put((0.02 * rng.standard_normal(
                (c.batch, c.n_prefix_tokens, c.prefix_dim))).astype(
                    np.float32))
        if c.encoder_seq:
            batch["frames"] = put((0.02 * rng.standard_normal(
                (c.batch, c.encoder_seq, c.encoder_dim))).astype(np.float32))
        return batch

    def __next__(self) -> dict:
        b = self.peek()
        self.step += 1
        return b

    def __iter__(self):
        return self


def for_arch(arch_cfg, batch: int, seq_len: int, seed: int = 0,
             device="cuda") -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=arch_cfg.vocab_size, batch=batch, seq_len=seq_len,
        seed=seed,
        n_prefix_tokens=arch_cfg.n_prefix_tokens,
        prefix_dim=arch_cfg.d_model if arch_cfg.n_prefix_tokens else 0,
        encoder_seq=arch_cfg.encoder_seq,
        encoder_dim=arch_cfg.d_model if arch_cfg.encoder_seq else 0,
    ), device=device)
