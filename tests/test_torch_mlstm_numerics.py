"""The mLSTM kernel's rounding points, modelled on the CPU.

The kernels of ``repro_torch/csrc/mlstm_scan.cu`` run their products on the
tensor cores (wgmma with TF32 operands) and only on the card.  Their
arithmetic differs from the plain version at the points that
:func:`kernel_model` repeats in PyTorch on the CPU:

* every operand x of the four products (q k^T, the gated scores times v,
  q C0 and the state update (w k)^T v) is split into hi = tf32(x) and
  lo = tf32(x - hi), rounded as ``cvt.rna.tf32.f32`` rounds (10 mantissa
  bits, to nearest, ties away from zero; the kernel adds half a unit of
  the 13 dropped bits and clears them), and each product is hi.hi +
  hi.lo + lo.hi, added to the f32 accumulator one k8 step at a time;
* the gates pass forms b = cumsum(lf) in each lane's run of the chunk
  serially, then adds the exclusive warp scan (Hillis-Steele over the 32
  lanes) of the runs' totals.

The model is held against the reference's Pallas kernel in interpret mode
on numpy-seeded inputs, in f32 within a third of the gate that
``chip_smoke.py`` holds the kernel to on the card (1e-4 + 1e-3 |y|), and in
bf16 within the bf16 gate and its Frobenius bound.  The same model with one
TF32 product (hi.hi alone) breaks the f32 gate at Dh 384, chunk 256: that
is why the kernel pays for three.
"""
from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.mlstm_scan import mlstm_scan as r_mlstm

from repro_torch import interop
from repro_torch.kernels import mlstm_scan as PM

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ATOL, RTOL = chip_smoke.ZOO_TOL["mlstm_scan"]
BF16_ATOL, BF16_RTOL = chip_smoke.ZOO_TOL["bf16"]
FROB = chip_smoke.ZOO_BF16_FROB
NEG_INF = -1.0e30
BH = 2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as the kernel rounds it (and as
    ``cvt.rna.tf32.f32`` does): add half a unit of the 13 dropped bits to
    the magnitude, then clear them."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(
        torch.float32)


def split(x: torch.Tensor) -> tuple:
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(acc, a, b, *, single: bool = False):
    """``acc + a @ b`` as the kernel forms it: k8 steps in order, each
    adding hi.hi, hi.lo and lo.hi (hi.hi alone when ``single``)."""
    ah, al = split(a)
    bh, bl = split(b)
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        acc = acc + ah[..., s] @ bh[..., s, :]
        if not single:
            acc = acc + ah[..., s] @ bl[..., s, :]
            acc = acc + al[..., s] @ bh[..., s, :]
    return acc


def gates_b(lf: torch.Tensor) -> torch.Tensor:
    """b = cumsum(lf) over one chunk (BH, L) in the gates pass's order."""
    L = lf.shape[1]
    runs = PM.gate_runs(L)
    part = torch.empty_like(lf)
    tot = lf.new_zeros((lf.shape[0], 32))
    for lane, (lo, hi) in enumerate(runs):
        run = lf.new_zeros(lf.shape[0])
        for j in range(lo, hi):
            run = run + lf[:, j]
            part[:, j] = run
        tot[:, lane] = run
    incl = tot
    lanes = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        shifted = torch.cat([incl.new_zeros((incl.shape[0], off)),
                             incl[:, :-off]], dim=1)
        incl = torch.where(lanes >= off, shifted + incl, incl)
    excl = torch.cat([incl.new_zeros((incl.shape[0], 1)), incl[:, :-1]], 1)
    lane_of = torch.tensor([lane for lane, (lo, hi) in enumerate(runs)
                            for _ in range(lo, hi)])
    return excl[:, lane_of] + part


def kernel_model(q, k, v, li, lf, *, chunk: int,
                 single: bool = False) -> torch.Tensor:
    """The kernels' function with their rounding points, on (BH, S, Dh)
    CPU tensors; returns ``q``'s dtype."""
    f32, dtype = torch.float32, q.dtype
    q, k, v, li, lf = (x.to(f32) for x in (q, k, v, li, lf))
    B_, S, Dh = q.shape
    L = min(chunk, S)
    C = q.new_zeros((B_, Dh, Dh))
    n = q.new_zeros((B_, Dh))
    m = q.new_zeros((B_,))
    causal = torch.ones((L, L), dtype=torch.bool).tril()
    out = torch.empty((B_, S, Dh))
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        qc, kc, vc, lic = q[:, sl], k[:, sl], v[:, sl], li[:, sl]
        b = gates_b(lf[:, sl])
        F = b[:, -1]
        s_exp = (F[:, None] - b) + lic
        m_next = torch.maximum(m + F, s_exp.amax(-1))
        decay = torch.exp((m + F) - m_next)
        w = torch.exp(s_exp - m_next[:, None])

        intra = torch.where(causal, (b[:, :, None] - b[:, None, :])
                            + lic[:, None, :], NEG_INF)
        m_inter = m[:, None] + b
        m_t = torch.clamp_min(torch.maximum(m_inter, intra.amax(-1)),
                              NEG_INF)
        g = torch.exp(m_inter - m_t)
        h = mm(torch.zeros((B_, L, Dh)), qc, C, single=single) * g[..., None]
        sc = mm(torch.zeros((B_, L, L)), qc, kc.transpose(1, 2),
                single=single)
        sc = torch.where(causal, sc * torch.exp(intra - m_t[..., None]), 0.0)
        h = mm(h, sc, vc, single=single)
        n_t = g * (qc @ n[:, :, None])[..., 0] + sc.sum(-1)
        den = torch.maximum(n_t.abs(), torch.exp(-m_t))
        out[:, sl] = h / den[..., None]

        kw = kc * w[..., None]
        C = mm(C * decay[:, None, None], kw.transpose(1, 2), vc,
               single=single)
        n = n * decay[:, None] + kw.sum(1)
        m = m_next
    return out.to(dtype)


@functools.lru_cache(maxsize=16)
def _case(S: int, Dh: int, chunk: int, dtype: str):
    """chip_smoke-style inputs (q, k scaled by Dh^-0.5, v standard normal,
    li * 0.5, lf = log sigmoid(x + 2)) from a numpy seed, and the
    reference kernel's output on them."""
    rng = np.random.default_rng(7 * S + Dh + chunk)
    f32 = np.float32
    arrs = [(rng.standard_normal((BH, S, Dh)) * Dh ** -0.5).astype(f32),
            (rng.standard_normal((BH, S, Dh)) * Dh ** -0.5).astype(f32),
            rng.standard_normal((BH, S, Dh)).astype(f32),
            (rng.standard_normal((BH, S)) * 0.5).astype(f32),
            np.asarray(jax.nn.log_sigmoid(jnp.asarray(
                rng.standard_normal((BH, S)).astype(f32) + 2.0)))]
    if dtype == "bfloat16":
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    want = r_mlstm(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                   interpret=True)
    return ([interop.tensor_from_array(a, "cpu") for a in arrs],
            np.asarray(want.astype(jnp.float32), np.float64))


def _ratio(got: torch.Tensor, want: np.ndarray) -> float:
    """The largest |got - want| over the f32 gate's allowance."""
    d = np.abs(got.double().numpy() - want)
    return float((d / (ATOL + RTOL * np.abs(want))).max())


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("Dh", [128, 256, 384])
def test_3xtf32_model_within_a_third_of_the_gate(Dh, chunk):
    xs, want = _case(512, Dh, chunk, "float32")
    got = kernel_model(*xs, chunk=chunk)
    assert torch.isfinite(got).all()
    assert _ratio(got, want) <= 1 / 3


def test_bf16_model_within_the_bf16_gate():
    xs, want = _case(512, 128, 64, "bfloat16")
    got = kernel_model(*xs, chunk=64).double().numpy()
    d = np.abs(got - want)
    assert (d <= BF16_ATOL + BF16_RTOL * np.abs(want)).all(), float(d.max())
    assert np.linalg.norm(d) / np.linalg.norm(want) <= FROB


def test_one_tf32_product_breaks_the_gate():
    """hi.hi alone (one TF32 product) misses the f32 gate at xLSTM-125M's
    head width and chunk: the design's reason for 3xTF32."""
    xs, want = _case(512, 384, 256, "float32")
    assert _ratio(kernel_model(*xs, chunk=256, single=True), want) > 1


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                         # a TF32 value
    x = torch.tensor([1.0 + 2.0 ** -11,            # tie: away from zero
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23,  # below the tie
                      one], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one]
    hi, lo = split(torch.tensor([1.0 / 3.0]))
    assert hi.item() + lo.item() == pytest.approx(1.0 / 3.0, rel=2 ** -21)


def test_gates_scan_matches_cumsum():
    rng = np.random.default_rng(3)
    for L in (1, 31, 64, 100, 256):
        lf = torch.from_numpy(rng.standard_normal((2, L)).astype(np.float32))
        torch.testing.assert_close(gates_b(lf), torch.cumsum(lf, 1),
                                   atol=1e-5, rtol=1e-5)
