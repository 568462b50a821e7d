"""The port's model-zoo kernel layer against the JAX package's.

Flash attention, flash-decoding, the RG-LRU scan and the chunkwise mLSTM:
the port's plain versions (what its wrappers run on CPU tensors) against
the reference's Pallas kernels, run as ``tests/test_kernels.py`` runs them
(``interpret=True`` / ``force_interpret=True``), with the same
parametrisation; the port's oracles (``kernels/ref.py``) against the
reference's; the model-layout wrappers (``kernels/ops.py``) against the
reference's; the ``bench_kernels`` entry point; and the bf16 interop.

Inputs are made with numpy from a seed and handed to both packages (bf16
through ``interop.tensor_from_array``).  Tolerances, per test: the
reference's own kernel-vs-oracle tolerances (flash 2e-5 in f32, decode
1e-4, mLSTM 1e-4 absolute plus 1e-3 relative, RG-LRU 1e-5), and 2e-2 in
bf16 (one bf16 rounding of the output apart), compared in f32.
"""
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as RO
from repro.kernels import ref as RREF
from repro.kernels.decode_attention import decode_attention as r_decode
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.mlstm_scan import mlstm_scan as r_mlstm
from repro.kernels.rglru_scan import rglru_scan as r_rglru

from repro_torch import interop
from repro_torch.benchmarks import bench_kernels
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as PD
from repro_torch.kernels import flash_attention as PF
from repro_torch.kernels import mlstm_scan as PM
from repro_torch.kernels import ops as PO
from repro_torch.kernels import ref as PREF
from repro_torch.kernels import rglru_scan as PR

I = dict(force_interpret=True)
F32_TOL = {"flash": 2e-5, "decode": 1e-4, "rglru": 1e-5}
BF16_TOL = 2e-2


def _arr(rng, shape, dtype=np.float32, scale=1.0, shift=0.0):
    """A numpy array of ``dtype`` (np.float32 or "bfloat16")."""
    x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16)) if dtype == "bfloat16" \
        else x


def _t(a):
    return interop.tensor_from_array(a, "cpu")


def _np32(x):
    """A JAX array or a port tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return interop.array_from_tensor(x).astype(np.float32)
    return np.asarray(x, np.float32)


def _close(got, want, atol, rtol=None):
    np.testing.assert_allclose(_np32(got), _np32(want), atol=atol,
                               rtol=atol if rtol is None else rtol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

class TestFlashAttention:
    @pytest.mark.parametrize("S,Dh,dtype", [
        (256, 128, np.float32), (512, 128, np.float32),
        (256, 256, np.float32), (256, 128, "bfloat16")])
    @pytest.mark.parametrize("mode,w,c", [
        ("causal", 0, 0), ("sliding", 128, 0), ("chunked", 0, 128),
        ("bidir", 0, 0)])
    def test_plain_matches_reference_kernel(self, S, Dh, dtype, mode, w, c):
        rng = np.random.default_rng(S + Dh)
        q, k, v = (_arr(rng, (3, S, Dh), dtype) for _ in range(3))
        want = r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mode=mode, window=w, chunk=c, qb=128, kb=128,
                       interpret=True)
        before = (PF.flash_attention.launches,
                  PF.flash_attention_plain.calls)
        got = PF.flash_attention(_t(q), _t(k), _t(v), mode=mode, window=w,
                                 chunk=c)
        assert (PF.flash_attention.launches,
                PF.flash_attention_plain.calls) == (before[0],
                                                    before[1] + 1)
        assert got.dtype == _t(q).dtype and got.shape == (3, S, Dh)
        _close(got, want, BF16_TOL if dtype == "bfloat16" else F32_TOL[
            "flash"])

    def test_ragged_and_uneven_lengths(self):
        """S not a multiple of any tile, and Sq != Skv: the plain version
        against the oracle (the Pallas kernel needs whole blocks)."""
        rng = np.random.default_rng(1)
        for Sq, Skv in ((333, 333), (70, 130)):
            q = _arr(rng, (2, Sq, 128))
            k, v = (_arr(rng, (2, Skv, 128)) for _ in range(2))
            for mode, w, c in (("causal", 0, 0), ("sliding", 100, 0),
                               ("chunked", 0, 64), ("bidir", 0, 0)):
                got = PF.flash_attention(_t(q), _t(k), _t(v), mode=mode,
                                         window=w, chunk=c)
                want = RREF.attention_ref(
                    jnp.asarray(q)[None], jnp.asarray(k)[None],
                    jnp.asarray(v)[None], causal=mode != "bidir", window=w,
                    chunk=c)[0]
                _close(got, want, F32_TOL["flash"])

    def test_rejects_what_the_kernel_does_not_take(self):
        q = torch.zeros((2, 8, 128))
        with pytest.raises(TypeError):
            PF.flash_attention(q, q.double(), q)
        with pytest.raises(ValueError):
            PF.flash_attention(q, q, q, mode="local")
        with pytest.raises(ValueError):
            PF.flash_attention(q, q, q, mode="chunked", chunk=0)
        with pytest.raises(ValueError):
            PF.flash_attention(q, q[:, :, :64], q[:, :, :64])


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def _rglru_inputs(rng, B, S, W, dtype):
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((B, S, W)) - 1.0)))
    a = a.astype(np.float32)
    if dtype == "bfloat16":
        a = np.asarray(jnp.asarray(a, jnp.bfloat16))
    return a, _arr(rng, (B, S, W), dtype), _arr(rng, (B, W))


class TestRGLRU:
    @pytest.mark.parametrize("B,S,W", [(4, 512, 256), (8, 256, 128),
                                       (2, 1024, 512)])
    @pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
    def test_plain_matches_reference_kernel(self, B, S, W, dtype):
        rng = np.random.default_rng(B * S + W)
        a, b, h0 = _rglru_inputs(rng, B, S, W, dtype)
        want = RO.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(h0), **I)
        before = PR.rglru_scan.launches
        got = PR.rglru_scan(_t(a), _t(b), _t(h0))
        assert PR.rglru_scan.launches == before
        assert got.dtype == _t(b).dtype
        _close(got, want, BF16_TOL if dtype == "bfloat16" else F32_TOL[
            "rglru"])

    def test_carry_across_time_blocks(self):
        """The reference with sb < S (the carry crosses grid steps) and the
        port's single loop agree."""
        B, S, W = 2, 512, 128
        a = np.full((B, S, W), 0.9, np.float32)
        b = np.full((B, S, W), 0.1, np.float32)
        h0 = np.zeros((B, W), np.float32)
        want = r_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                       bb=2, sb=64, wb=128, interpret=True)
        got = PR.rglru_scan(_t(a), _t(b), _t(h0))
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-5)

    @pytest.mark.parametrize("B,S,W,dtype", [
        (2, 4096, 4096, torch.float32), (3, 300, 200, torch.float32),
        (2, 1000, 4104, torch.bfloat16), (5, 77, 333, torch.float32),
        (1, 64, 8, torch.bfloat16), (1, 65, 1, torch.float32)])
    def test_launch_plan_covers_every_lane_and_step(self, B, S, W, dtype):
        """The ring route where a row of W elements is a multiple of 16
        bytes (TMA's rule), else the direct route; either way every (b, w)
        lane and every step is some block's."""
        plan = PR.launch_plan(B, S, W, dtype)
        size = torch.empty((), dtype=dtype).element_size()
        assert plan["route"] == ("ring" if (W * size) % 16 == 0
                                 else "direct")
        gx, gy = plan["grid"]
        if plan["route"] == "ring":
            assert gy == B and gx * plan["lanes"] >= W > (gx - 1) * plan[
                "lanes"]
            assert plan["tiles"] * plan["steps"] >= S > (
                plan["tiles"] - 1) * plan["steps"]
        else:
            assert gy == 1 and gx * plan["lanes"] >= B * W > (gx - 1) * plan[
                "lanes"]
            assert plan["steps"] == S

    @pytest.mark.parametrize("B,S,W", [(3, 300, 200), (5, 77, 333)])
    def test_ragged_shapes_against_the_reference_oracle(self, B, S, W):
        """Shapes the reference's kernel does not tile (S, W off its
        blocks) against its oracle, f32 and bf16."""
        rng = np.random.default_rng(B + S + W)
        for dtype in (np.float32, "bfloat16"):
            a, b, h0 = _rglru_inputs(rng, B, S, W, dtype)
            got = PR.rglru_scan(_t(a), _t(b), _t(h0))
            want = RREF.rglru_ref(*(jnp.asarray(x) for x in (a, b, h0)))
            _close(got, want, BF16_TOL if dtype == "bfloat16" else F32_TOL[
                "rglru"])

    def test_bf16_carry_is_never_rounded(self):
        """Only the stored h is rounded to bf16: the carry stays f32."""
        rng = np.random.default_rng(3)
        a, b, h0 = _rglru_inputs(rng, 2, 300, 64, "bfloat16")
        got = PR.rglru_scan(_t(a), _t(b), _t(h0))
        f32 = PR.rglru_scan(_t(a).float(), _t(b).float(), _t(h0))
        assert torch.equal(got, f32.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, B, H, S, Dh, li_scale=0.5, lf_shift=2.0,
                  dtype=np.float32):
    q = _arr(rng, (B, H, S, Dh), dtype, Dh ** -0.5)
    k = _arr(rng, (B, H, S, Dh), dtype, Dh ** -0.5)
    v = _arr(rng, (B, H, S, Dh), dtype)
    li = _arr(rng, (B, H, S), dtype, li_scale)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        _arr(rng, (B, H, S), np.float32, 1.0, lf_shift))))
    if dtype == "bfloat16":
        lf = np.asarray(jnp.asarray(lf, jnp.bfloat16))
    return q, k, v, li, lf


def _fold(*xs):
    return [x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]) for x in xs]


class TestMLSTM:
    @pytest.mark.parametrize("S,Dh,chunk", [(512, 128, 128), (256, 128, 256),
                                            (512, 256, 64)])
    def test_plain_matches_reference_kernel(self, S, Dh, chunk):
        rng = np.random.default_rng(S + Dh + chunk)
        xs = _fold(*_mlstm_inputs(rng, 2, 2, S, Dh))
        want = r_mlstm(*(jnp.asarray(x) for x in xs), chunk=chunk,
                       interpret=True)
        before = PM.mlstm_scan.launches
        got = PM.mlstm_scan(*(_t(x) for x in xs), chunk=chunk)
        assert PM.mlstm_scan.launches == before
        _close(got, want, 1e-4, 1e-3)

    def test_chunk_invariance(self):
        """Different chunk lengths give the same function, in both
        packages."""
        rng = np.random.default_rng(4)
        xs = _fold(*_mlstm_inputs(rng, 1, 2, 256, 128, li_scale=1.0,
                                  lf_shift=1.0))
        o64 = PM.mlstm_scan(*(_t(x) for x in xs), chunk=64)
        o256 = PM.mlstm_scan(*(_t(x) for x in xs), chunk=256)
        want = r_mlstm(*(jnp.asarray(x) for x in xs), chunk=64,
                       interpret=True)
        _close(o64, o256, 1e-4, 1e-3)
        _close(o64, want, 1e-4, 1e-3)

    def test_bf16_and_dh_384_against_the_stepwise_oracle(self):
        """bf16 inputs and xLSTM-125M's head width (Dh 384) against the
        port's stepwise oracle."""
        rng = np.random.default_rng(5)
        for Dh, chunk, dtype, tol in ((384, 64, np.float32, (1e-4, 1e-3)),
                                      (128, 32, "bfloat16", (BF16_TOL,) * 2)):
            q, k, v, li, lf = (_t(x) for x in _mlstm_inputs(
                rng, 1, 2, 128, Dh, dtype=dtype))
            got = PO.mlstm_scan(q, k, v, li, lf, chunk=chunk)
            want = PREF.mlstm_ref(q, k, v, li, lf)
            assert got.dtype == q.dtype
            _close(got, want, *tol)

    def test_rejects_a_ragged_chunk(self):
        q = torch.zeros((2, 100, 128))
        g = torch.zeros((2, 100))
        with pytest.raises(ValueError):
            PM.mlstm_scan(q, q, q, g, g, chunk=64)

    def test_kernel_limits_raise_before_a_launch(self):
        """What the kernels do not take raises in the wrapper, before any
        library is built or launched."""
        g = torch.zeros((2, 256))
        q = torch.zeros((2, 256, 64))
        with pytest.raises(ValueError, match="Dh"):
            PM.launch_passes(q, q, q, g, g, 256, PM.ALL_PASSES)
        q = torch.zeros((2, 512, 128))
        g = torch.zeros((2, 512))
        with pytest.raises(ValueError, match="chunks"):
            PM.launch_passes(q, q, q, g, g, 512, PM.ALL_PASSES)
        q = torch.zeros((PM.MAX_GRID_YZ + 1, 1, 128))
        g = torch.zeros((PM.MAX_GRID_YZ + 1, 1))
        with pytest.raises(ValueError, match="65535"):
            PM.launch_passes(q, q, q, g, g, 1, PM.ALL_PASSES)

    @pytest.mark.parametrize("BH,S,Dh,L", [(32, 4096, 384, 256),
                                           (2, 300, 128, 100),
                                           (3, 64, 256, 1), (1, 200, 384, 40)])
    def test_launch_plan_covers_every_row_column_and_chunk(self, BH, S, Dh,
                                                           L):
        """The output blocks tile every (row, column) of every chunk once,
        their key tiles reach every key a row sees, the state blocks tile C
        once, and the gates lanes' runs cover a chunk once."""
        plan = PM.launch_plan(BH, S, Dh, L)
        gx, gy, gz = plan["output"]
        assert (gy, gz) == (S // L, BH)
        seen = torch.zeros((L, Dh), dtype=torch.int32)
        for x in range(gx):
            t0, e0 = PM.output_tile(plan, x)
            t_end = min(t0 + PM.ROWS, L)
            assert t0 < L
            seen[t0:t_end, e0:e0 + PM.COLS] += 1
            keys = -(-t_end // PM.KEYS) * PM.KEYS
            assert keys >= t_end
        assert bool((seen == 1).all())
        if gx > plan["slices"]:   # heaviest row tiles first
            assert PM.output_tile(plan, 0)[0] > PM.output_tile(
                plan, gx - 1)[0]
        assert plan["scores"] == (plan["row_tiles"], S // L, BH)
        assert plan["row_tiles"] * PM.ROWS >= L > (plan["row_tiles"] - 1) \
            * PM.ROWS
        sx, sy, sz = plan["state"]
        assert (sx * PM.ROWS, sy * PM.COLS, sz) == (Dh, Dh, BH)
        assert plan["gates"] == (BH, 1, 1)
        runs = PM.gate_runs(L)
        assert len(runs) == 32
        covered = [j for lo, hi in runs for j in range(lo, hi)]
        assert covered == list(range(L))

    def test_plain_matches_the_reference_kernel_on_a_ragged_chunk(self):
        """A chunk (100) that is no multiple of the kernel's row or key
        tiles, at Dh 384."""
        rng = np.random.default_rng(11)
        xs = _fold(*_mlstm_inputs(rng, 1, 2, 300, 384))
        want = r_mlstm(*(jnp.asarray(x) for x in xs), chunk=100,
                       interpret=True)
        _close(PM.mlstm_scan(*(_t(x) for x in xs), chunk=100), want, 1e-4,
               1e-3)


# ---------------------------------------------------------------------------
# flash-decoding
# ---------------------------------------------------------------------------

class TestDecodeAttention:
    @pytest.mark.parametrize("S,Dh,L", [(1024, 128, 1024), (1024, 128, 700),
                                        (512, 256, 64), (768, 128, 768)])
    def test_plain_matches_reference_kernel(self, S, Dh, L):
        rng = np.random.default_rng(S + Dh + L)
        q1 = _arr(rng, (4, 1, Dh))
        k, v = (_arr(rng, (4, S, Dh)) for _ in range(2))
        want = r_decode(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v), L,
                        kb=256, interpret=True)
        before = PD.decode_attention.launches
        got = PD.decode_attention(_t(q1), _t(k), _t(v), L)
        assert PD.decode_attention.launches == before
        assert got.shape == (4, 1, Dh)
        _close(got, want, F32_TOL["decode"], 0.0)

    def test_bf16(self):
        rng = np.random.default_rng(6)
        q1 = _arr(rng, (2, 1, 128), "bfloat16")
        k, v = (_arr(rng, (2, 512, 128), "bfloat16") for _ in range(2))
        want = r_decode(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v), 512,
                        interpret=True)
        got = PD.decode_attention(_t(q1), _t(k), _t(v), 512)
        assert got.dtype == torch.bfloat16
        _close(got, want, BF16_TOL)

    @pytest.mark.parametrize("length", [0, 1, 333])
    def test_edge_lengths(self, length):
        """length 0 gives zeros; 1 and a length off every tile match the
        reference's kernel (S = 768, not a power of two)."""
        rng = np.random.default_rng(7 + length)
        q1 = _arr(rng, (3, 1, 128))
        k, v = (_arr(rng, (3, 768, 128)) for _ in range(2))
        want = r_decode(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                        length, interpret=True)
        got = PD.decode_attention(_t(q1), _t(k), _t(v), torch.tensor(length))
        _close(got, want, F32_TOL["decode"], 0.0)
        if length == 0:
            assert not got.any()


# ---------------------------------------------------------------------------
# oracles and model-layout wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["attention", "decode", "rglru", "mlstm",
                                  "quant"])
def test_oracles_match_the_reference_oracles(case):
    rng = np.random.default_rng(8)
    J = lambda *xs: [jnp.asarray(x) for x in xs]
    T = lambda *xs: [_t(x) for x in xs]
    if case == "attention":
        xs = [_arr(rng, (2, 2, 200, 64)) for _ in range(3)]
        for kw in (dict(causal=True), dict(causal=True, window=50),
                   dict(causal=True, chunk=64), dict(causal=False)):
            _close(PREF.attention_ref(*T(*xs), **kw),
                   RREF.attention_ref(*J(*xs), **kw), 2e-5)
    elif case == "decode":
        q1 = _arr(rng, (2, 2, 64))
        k, v = (_arr(rng, (2, 2, 300, 64)) for _ in range(2))
        for length in (1, 150, 300):
            _close(PREF.decode_ref(*T(q1, k, v), length=length),
                   RREF.decode_ref(*J(q1, k, v), length=length), 1e-5)
    elif case == "rglru":
        a, b, h0 = _rglru_inputs(rng, 2, 100, 48, np.float32)
        _close(PREF.rglru_ref(*T(a, b, h0)), RREF.rglru_ref(*J(a, b, h0)),
               1e-6)
    elif case == "mlstm":
        xs = _mlstm_inputs(rng, 1, 2, 64, 32)
        _close(PREF.mlstm_ref(*T(*xs)), RREF.mlstm_ref(*J(*xs)), 1e-5, 1e-5)
    else:
        x = _arr(rng, (16, 256), scale=3.0)
        q, s = PREF.quant_ref(_t(x))
        rq, rs = RREF.quant_ref(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
        _close(PREF.dequant_ref(q, s), RREF.dequant_ref(rq, rs), 1e-6)


class TestOps:
    def test_flash_attention_model_layout(self):
        rng = np.random.default_rng(9)
        q, k, v = (_arr(rng, (2, 256, 4, 128)) for _ in range(3))
        want = RO.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  mode="sliding", window=100, **I)
        got = PO.flash_attention(_t(q), _t(k), _t(v), mode="sliding",
                                 window=100)
        assert got.shape == (2, 256, 4, 128)
        _close(got, want, F32_TOL["flash"])

    def test_rglru_model_layout(self):
        rng = np.random.default_rng(10)
        a, b, h0 = _rglru_inputs(rng, 2, 256, 256, np.float32)
        want = RO.rglru_scan(*(jnp.asarray(x) for x in (a, b, h0)), **I)
        _close(PO.rglru_scan(_t(a), _t(b), _t(h0)), want, F32_TOL["rglru"])

    def test_mlstm_model_layout(self):
        rng = np.random.default_rng(11)
        xs = _mlstm_inputs(rng, 2, 2, 256, 128)
        want = RO.mlstm_scan(*(jnp.asarray(x) for x in xs), chunk=128, **I)
        got = PO.mlstm_scan(*(_t(x) for x in xs), chunk=128)
        assert got.shape == (2, 2, 256, 128)
        _close(got, want, 1e-4, 1e-3)


# ---------------------------------------------------------------------------
# entry point, interop, build flags, the card
# ---------------------------------------------------------------------------

def test_bench_kernels_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "bench_kernels.csv"
    rows = bench_kernels.main(device="cpu", out=out, small=True)
    names = [r[0] for r in rows]
    assert len(rows) == 5 and all(r[1] > 0 for r in rows)
    for stem in ("flash_attention_", "rglru_scan_", "mlstm_scan_",
                 "quant_blockwise_", "event_sweep_"):
        assert sum(n.startswith(stem) for n in names) == 1, names
    lines = out.read_text().splitlines()
    assert lines[0] == "name,us_per_call,derived" and len(lines) == 6
    assert "_interp" not in out.read_text()
    assert len(capsys.readouterr().out.splitlines()) == 5


def test_bench_kernels_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_kernels.main()


def test_bf16_interop_round_trips_bit_for_bit():
    rng = np.random.default_rng(12)
    a = _arr(rng, (3, 5, 7), "bfloat16")
    a[0, 0, :3] = np.asarray(jnp.asarray([np.inf, -0.0, 1e-40],
                                         jnp.bfloat16))
    t = interop.tensor_from_array(a, "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == a.shape
    back = interop.array_from_tensor(t)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    x = _arr(rng, (4,))
    assert interop.tensor_from_array(x, "cpu", torch.float64).dtype == \
        torch.float64
    np.testing.assert_array_equal(interop.array_from_tensor(_t(x)), x)


def test_build_flags_per_source():
    for src in ("flash_attention.cu", "decode_attention.cu",
                "mlstm_scan.cu"):
        assert "-fmad=false" not in _build.flags(src)
    for src in ("rglru_scan.cu", "event_sweep.cu", "quant_blockwise.cu"):
        assert "-fmad=false" in _build.flags(src)
    assert _build.library_path("rglru_scan.cu").name.startswith("rglru_scan_")


def test_library_key_covers_the_headers(tmp_path, monkeypatch):
    """Editing a shared header of ``csrc/`` changes every source's library
    key, so a stale library is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    sources = ("flash_attention.cu", "decode_attention.cu", "rglru_scan.cu")
    before = {src: _build.library_path(src) for src in sources}
    assert before == {src: _build.library_path(src) for src in sources}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {src: _build.library_path(src) for src in sources}
    for src in sources:
        assert after[src] != before[src]
        assert after[src].name.startswith(src[:-3] + "_")


def test_spill_report_of_ptxas():
    """``chip_smoke.py`` reads each kernel's spill stores from the ptxas
    report kept beside a built library."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    report = (
        "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 210 registers, used 1 barriers\n"
        "ptxas info    : Function properties for _Z1bPf\n"
        "    8 bytes stack frame, 16 bytes spill stores, 16 bytes spill "
        "loads\n")
    assert chip_smoke._spills(report) == {"_Z1aPf": 0, "_Z1bPf": 16}


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this check on "
                    "the card)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    a, b, h0 = torch.sigmoid(r(3, 100, 70)), r(3, 100, 70), r(3, 70)
    assert torch.equal(PR.rglru_scan(a, b, h0), PR.rglru_scan_plain(a, b, h0))
    q, k, v = r(2, 150, 128), r(2, 150, 128), r(2, 150, 128)
    torch.testing.assert_close(PF.flash_attention(q, k, v, mode="sliding",
                                                  window=40),
                               PF.flash_attention_plain(q, k, v,
                                                        mode="sliding",
                                                        window=40),
                               atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(PD.decode_attention(q[:, :1], k, v, 77),
                               PD.decode_attention_plain(q[:, :1], k, v, 77),
                               atol=1e-4, rtol=0)
    g1, g2 = r(2, 128) * 0.5, torch.nn.functional.logsigmoid(r(2, 128) + 2)
    torch.testing.assert_close(
        PM.mlstm_scan(q[:, :128] * 0.1, k[:, :128] * 0.1, v[:, :128], g1, g2,
                      chunk=64),
        PM.mlstm_scan_plain(q[:, :128] * 0.1, k[:, :128] * 0.1, v[:, :128],
                            g1, g2, chunk=64), atol=1e-4, rtol=1e-3)
