"""Counter-based uniforms: Philox-4x32-10 (Salmon et al., SC'11) in PyTorch.

The auto-sampled Monte-Carlo schedules draw gap ``j`` of grid point ``i``
and trial ``t`` as a function of ``(seed, i, t, j)`` alone, the property
the reference gets from ``fold_in(fold_in(key, i), t)``.  Chunk size,
memory budget and capacity buckets then only decide which lanes are drawn
together, never what they draw.

One Philox call maps a 128-bit counter and a 64-bit key to four 32-bit
words.  Here the counter is ``(j // 2, t, i mod 2^32, i div 2^32)`` (the
point's low and high words; ``(j // 2, t, i, 0)`` for any grid below 2^32
points) and the key the seed's two 32-bit halves; words 0-1 make uniform
``2p`` and words 2-3 uniform ``2p + 1``.  Each uniform keeps 52 bits: ``u = (x + 1/2) 2^-52`` lies in
``[2^-53, 1 - 2^-53]``, so it is never 0 or 1.

The words live in int64 tensors.  Every value stays in ``[0, 2^32)``, so
the arithmetic right shift acts as a logical one; the 32 x 32-bit product
is split into 16-bit halves so that no partial product reaches 2^63.
Integer operations give the same bits on the CPU and on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from .._device import F64

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
ROUNDS = 10


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * b`` for a 32-bit constant ``m`` and
    32-bit words ``b``."""
    p_hi = (b >> 16) * m                 # < 2^48
    s = (b & 0xFFFF) * m                 # < 2^48
    s = s + ((p_hi & 0xFFFF) << 16)      # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = ROUNDS):
    """Philox-4x32 of counter words ``c0..c3`` (int64 tensors holding
    32-bit values, broadcastable) under key ``(k0, k1)``; returns the four
    output words, broadcast to a common shape."""
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return torch.broadcast_tensors(c0, c1, c2, c3)


def _unit(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two 32-bit words -> one f64 uniform in (0, 1) from 52 bits."""
    x = ((a >> 6) << 26) | (b >> 6)
    return (x.to(F64) + 0.5) * 2.0 ** -52


@dataclasses.dataclass(frozen=True)
class CounterKey:
    """The random stream of a block of lanes: raveled grid points
    ``points`` x trials ``trials`` (int64 tensors on one device) under
    ``seed``.  Uniform ``j`` of lane ``(points[a], trials[b])`` depends on
    ``(seed, points[a], trials[b], j)`` and nothing else."""

    seed: int
    points: torch.Tensor
    trials: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def shape(self) -> tuple:
        return (int(self.points.numel()), int(self.trials.numel()))

    def uniforms(self, n: int) -> torch.Tensor:
        """``(len(points), len(trials), n)`` f64 uniforms in (0, 1)."""
        dev = self.device
        i64 = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev)
        pair = torch.arange((n + 1) // 2, dtype=torch.int64, device=dev)
        pts = i64(self.points).reshape(-1, 1, 1)
        w0, w1, w2, w3 = philox4x32(
            pair.reshape(1, 1, -1), i64(self.trials).reshape(1, -1, 1),
            pts & _MASK, (pts >> 32) & _MASK,
            self.seed & _MASK, (self.seed >> 32) & _MASK)
        u = torch.stack((_unit(w0, w1), _unit(w2, w3)), dim=-1)
        return u.reshape(u.shape[:-2] + (-1,))[..., :n]
