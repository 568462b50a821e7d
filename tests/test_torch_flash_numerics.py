"""The bf16 flash kernel's rounding points, modelled on the CPU.

The bf16 kernel of ``repro_torch/csrc/flash_attention.cu`` (wgmma fed by
TMA) runs only on the card.  Its arithmetic differs from the plain version
at three points, which :func:`bf16_kernel_model` repeats in PyTorch on the
CPU:

* the scores are the unscaled product of the bf16 q and k, accumulated in
  f32, then scaled in f32 (the plain version scales q first);
* the softmax runs online over tiles of keys (64 in the kernel; 128 is
  modelled too), rescaling the running sum and output at every tile;
* the weights P are rounded to bf16 for P V (the tensor cores take bf16
  operands), while the sum l is taken from the f32 weights.

The model is held against the reference's Pallas kernel in interpret mode
on the same numpy-seeded inputs, within the gate ``chip_smoke.py`` holds
the kernel to on the card: every element within 4e-3 + 1e-2 |y| and a
relative Frobenius error of at most 4e-3 (``ZOO_TOL["bf16"]`` and
``ZOO_BF16_FROB``).  Rounding P to bf16 costs about 2e-3 of it, so the
model must also stay under 3e-3: a change of design that eats the margin
shows here before it reaches the card.
"""
from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention as r_flash

from repro_torch import interop
from repro_torch.kernels import flash_attention as PF

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ATOL, RTOL = chip_smoke.ZOO_TOL["bf16"]
FROB = chip_smoke.ZOO_BF16_FROB
#: the margin this design keeps under the Frobenius gate.
FROB_MARGIN = 3e-3
NEG_INF = -1.0e30

#: (S, the reference kernel's q and kv block, window, chunk): blocks must
#: divide S and the chunk (the reference's asserts).
SHAPES = [(333, 37, 100, 111), (1024, 128, 512, 256)]
BH = 2


def bf16_kernel_model(q, k, v, *, mode: str, window: int, chunk: int,
                      tile: int) -> torch.Tensor:
    """The bf16 kernel's function with its rounding points, on (BH, S, Dh)
    bf16 tensors; returns bf16."""
    f32 = torch.float32
    BH_, Sq, Dh = q.shape
    Skv = k.shape[1]
    scale = torch.tensor(Dh ** -0.5, dtype=f32)
    allow = PF.allowed(mode, Sq, Skv, window, chunk, q.device)
    m = torch.full((BH_, Sq, 1), NEG_INF)
    l = torch.zeros((BH_, Sq, 1))
    o = torch.zeros((BH_, Sq, Dh))
    for j0 in range(0, Skv, tile):
        a = allow[:, j0:j0 + tile]
        s = torch.matmul(q.to(f32), k[:, j0:j0 + tile].to(f32).transpose(1, 2))
        s = torch.where(a, s * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(a, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.matmul(p.to(torch.bfloat16).to(f32),
                                    v[:, j0:j0 + tile].to(f32))
        m = m_new
    return (o / torch.clamp_min(l, 1e-30)).to(torch.bfloat16)


@functools.lru_cache(maxsize=16)   # every (mode, shape, Dh) case
def _case(mode: str, S: int, blk: int, window: int, chunk: int, Dh: int):
    """Seeded bf16 inputs and the reference kernel's output on them."""
    rng = np.random.default_rng(1000 * S + Dh)
    arrs = [np.array(jnp.asarray(rng.standard_normal((BH, S, Dh))
                                 .astype(np.float32), jnp.bfloat16))
            for _ in range(3)]
    want = r_flash(*(jnp.asarray(a) for a in arrs), mode=mode,
                   window=window, chunk=chunk, qb=blk, kb=blk,
                   interpret=True)
    return ([interop.tensor_from_array(a, "cpu") for a in arrs],
            np.asarray(want, np.float64))


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("Dh", [128, 256])
@pytest.mark.parametrize("S,blk,window,chunk", SHAPES)
@pytest.mark.parametrize("mode", PF.MODES)
def test_bf16_kernel_model_within_the_gate(mode, S, blk, window, chunk, Dh,
                                           tile):
    window = window if mode == "sliding" else 0
    chunk = chunk if mode == "chunked" else 0
    (q, k, v), want = _case(mode, S, blk, window, chunk, Dh)
    got = bf16_kernel_model(q, k, v, mode=mode, window=window, chunk=chunk,
                            tile=tile).double().numpy()
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert (d <= ATOL + RTOL * np.abs(want)).all(), float(d.max())
    frob = np.linalg.norm(d) / np.linalg.norm(want)
    assert frob <= FROB
    assert frob < FROB_MARGIN, frob
