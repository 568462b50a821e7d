"""The port's blockwise int8 quantize/dequantize against the JAX package's.

The reference's Pallas kernels run here in interpret mode
(``force_interpret=True`` / ``interpret=True``); the port's wrappers take
their plain PyTorch versions on CPU tensors.  Both are held bitwise: int8
payloads, the bits of every scale (NaN included) and the bits of every
dequantized value.  The inputs are ``chip_smoke.quant_cases()``, the same
numpy-seeded sizes and special values that ``chip_smoke.py`` gives the
CUDA kernels on the card.

One known difference is not exercised: XLA on the CPU flushes subnormal
products to zero, and PyTorch (and the card) keep them.  Dequantizing a
subnormal scale shows it, but quantize never makes one (scales are at
least 1e-12), so every payload the store writes reads back alike.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as RO
from repro.kernels import quant_blockwise as RQ
from repro.kernels import ref as RREF

from repro_torch.kernels import ops as PO
from repro_torch.kernels import quant_blockwise as PQ

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CASES = chip_smoke.quant_cases()
IDS = [name for name, _ in CASES]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _ref_array(x):
    q, s, pad = RO.quantize_array(jnp.asarray(x), force_interpret=True)
    return np.array(q), np.array(s), pad


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_quantize_array_bitwise_against_reference(i):
    _, x = CASES[i]
    rq, rs, rpad = _ref_array(x)
    before = PQ.quantize.launches
    q, s, pad = PO.quantize_array(torch.from_numpy(x))
    assert pad == rpad and PQ.quantize.launches == before
    _same(q.numpy(), rq)
    _same(s.numpy(), rs)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_dequantize_array_bitwise_against_reference(i):
    _, x = CASES[i]
    rq, rs, pad = _ref_array(x)
    want = RO.dequantize_array(jnp.asarray(rq), jnp.asarray(rs),
                               shape=x.shape, dtype="float32", pad=pad,
                               force_interpret=True)
    got = PO.dequantize_array(torch.from_numpy(rq), torch.from_numpy(rs),
                              shape=x.shape, dtype="float32", pad=pad)
    _same(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_plain_versions_against_reference_kernels(i):
    """The 2-D kernel interface: quantize_plain / dequantize_plain against
    the reference's quantize / dequantize in interpret mode."""
    _, x = CASES[i]
    pad, D = PO._pad_of(x.size)
    x2 = np.concatenate([x, np.zeros(pad, np.float32)]).reshape(-1, D)
    rq, rs = RQ.quantize(jnp.asarray(x2), bn=min(256, x2.shape[0]),
                         interpret=True)
    q, s = PQ.quantize_plain(torch.from_numpy(x2))
    _same(q.numpy(), np.asarray(rq))
    _same(s.numpy(), np.asarray(rs))
    rd = RQ.dequantize(rq, rs, bn=min(256, x2.shape[0]), interpret=True)
    _same(PQ.dequantize_plain(q, s).numpy(), np.asarray(rd))


def test_special_values_semantics():
    """What the special groups must give: NaN scale and q = 0 for the NaN
    group, inf scale and q = 0 for the +-inf groups, the 1e-12 floor for
    the zero and subnormal groups, ties to even at scale 1, and no value
    past +-127."""
    _, x = CASES[-1]
    q, s, _ = PO.quantize_array(torch.from_numpy(x))
    q, s = q.numpy().reshape(-1, 128), s.numpy().reshape(-1)
    assert np.isnan(s[0]) and not q[0].any()
    assert s[1] == np.inf and s[2] == np.inf
    assert not q[1].any() and not q[2].any()
    assert s[3] == np.float32(1e-12) and not q[3].any()
    assert s[4] == 1.0
    np.testing.assert_array_equal(q[4, :8], [127, 0, 2, -2, 126, 0, 2, -126])
    assert s[5] == np.float32(1e-12) and not q[5].any()
    assert np.abs(q.astype(np.int32)).max() <= 127
    np.testing.assert_array_equal(q[7, :4], [127, -127, 127, -127])


def test_scales_are_the_kernels_product_form():
    """The kernel multiplies max|x| by float32(1/127); the reference's
    ``ref.quant_ref`` divides by 127 and differs by one ulp on some
    scales.  The port follows the kernel."""
    _, x = CASES[2]
    x2 = x[:2**20].reshape(-1, 512)
    _, s = PQ.quantize_plain(torch.from_numpy(x2))
    amax = np.abs(x2.reshape(-1, 4, 128)).max(-1)
    prod = np.maximum(amax * np.float32(1.0 / 127.0), np.float32(1e-12))
    _same(s.numpy(), prod)
    _, rs = RREF.quant_ref(jnp.asarray(x2))
    assert np.count_nonzero(_bits(np.asarray(rs)) != _bits(prod)) > 0


class TestWrappers:
    def test_cpu_tensors_take_the_plain_versions(self):
        x = torch.from_numpy(CASES[0][1]).reshape(-1, 512)
        k0, d0 = PQ.quantize.launches, PQ.dequantize.launches
        p0, r0 = PQ.quantize_plain.calls, PQ.dequantize_plain.calls
        q, s = PQ.quantize(x)
        out = PQ.dequantize(q, s)
        assert (PQ.quantize.launches, PQ.dequantize.launches) == (k0, d0)
        assert PQ.quantize_plain.calls == p0 + 1
        assert PQ.dequantize_plain.calls == r0 + 1
        assert q.dtype == torch.int8 and q.shape == x.shape
        assert s.dtype == torch.float32 and s.shape == (x.shape[0], 4)
        assert out.dtype == torch.float32 and out.shape == x.shape

    def test_counts_survive_concurrent_callers(self):
        """The store quantizes from its flush thread while the main thread
        may dequantize: no count may be lost (more threads than cores,
        a short switch interval)."""
        import os
        import threading
        x = torch.zeros((2, 128))
        n_threads, per = 2 * (os.cpu_count() or 2) + 2, 50
        before = PQ.quantize_plain.calls
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(
                target=lambda: [PQ.quantize(x) for _ in range(per)])
                for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert PQ.quantize_plain.calls == before + n_threads * per

    def test_validation(self):
        x = torch.zeros((4, 256))
        with pytest.raises(ValueError, match="D % 128"):
            PQ.quantize(torch.zeros((4, 100)))
        with pytest.raises(TypeError, match="float32"):
            PQ.quantize(x.double())
        q, s = PQ.quantize(x)
        with pytest.raises(TypeError, match="int8"):
            PQ.dequantize(q.to(torch.int16), s)
        with pytest.raises(ValueError, match="scales"):
            PQ.dequantize(q, s[:, :1])

    def test_roundtrip_error_bound(self):
        """|x - dequant(quant(x))| <= scale/2 + 1e-6 max|x| per group (the
        bound chip_smoke.py gates the full-width checkpoint with)."""
        x = CASES[2][1]
        q, s, pad = PO.quantize_array(torch.from_numpy(x))
        y = PO.dequantize_array(q, s, shape=x.shape, dtype=torch.float32,
                                pad=pad).numpy()
        xs = np.concatenate([x, np.zeros(pad, np.float32)]).reshape(-1, 128)
        ys = np.concatenate([y, np.zeros(pad, np.float32)]).reshape(-1, 128)
        sc = s.numpy().reshape(-1, 1).astype(np.float64)
        amax = np.abs(xs).max(-1, keepdims=True).astype(np.float64)
        err = np.abs(xs.astype(np.float64) - ys)
        assert np.all(err <= 0.5 * sc + 1e-6 * amax)

    @pytest.mark.gpu
    def test_kernels_match_plain_versions_on_the_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (chip_smoke.py runs this check "
                        "on the card)")
        for _, x in CASES:
            t = torch.from_numpy(x).to("cuda")
            before = PQ.quantize.launches
            q, s, pad = PO.quantize_array(t)
            assert PQ.quantize.launches == before + 1
            x2 = torch.cat([t, t.new_zeros(pad)]).reshape(q.shape)
            pq, ps = PQ.quantize_plain(x2)
            assert torch.equal(q, pq)
            assert torch.equal(s.isnan(), ps.isnan())
            assert torch.equal(torch.nan_to_num(s), torch.nan_to_num(ps))
            d, pd = PQ.dequantize(q, s), PQ.dequantize_plain(q, s)
            assert torch.equal(d.isnan(), pd.isnan())
            assert torch.equal(torch.nan_to_num(d), torch.nan_to_num(pd))

    @pytest.mark.gpu
    def test_grouped_kernels_match_plain_versions_on_the_card(self):
        """All cases in one launch each way, in order and reversed, and
        each alone (a one-row table, passed by value), against the grouped
        plain versions (the same table and arenas)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (chip_smoke.py runs this check "
                        "on the card)")
        same = lambda a, b: (torch.equal(a.isnan(), b.isnan()) and
                             torch.equal(torch.nan_to_num(a),
                                         torch.nan_to_num(b)))
        xs = [torch.from_numpy(x).to("cuda") for _, x in CASES]
        for order in (xs, xs[::-1], *([x] for x in xs)):
            before = (PQ.quantize_leaves.launches,
                      PQ.dequantize_leaves.launches)
            q, s, views = PQ.quantize_leaves(order)
            pq, ps, _ = PQ.quantize_leaves_plain(order)
            assert torch.equal(q, pq) and same(s, ps)
            args = ([v[0] for v in views], [v[1] for v in views],
                    [x.shape for x in order], [v[2] for v in views])
            for a, b in zip(PQ.dequantize_leaves(*args),
                            PQ.dequantize_leaves_plain(*args)):
                assert same(a, b)
            assert (PQ.quantize_leaves.launches,
                    PQ.dequantize_leaves.launches) == (before[0] + 1,
                                                       before[1] + 1)
