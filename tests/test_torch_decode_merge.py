"""The decode kernel's log-sum-exp and the merge of partial decodes, which
let decode run on a KV cache split over ranks along its slots.

* ``decode_attention_plain`` (the kernel's plain version, what the wrapper
  runs on the CPU) against the reference's ``repro.kernels.ref.decode_ref``
  on seeded numpy inputs, and its ``lse`` against a float64 log-sum-exp of
  the scaled scores (``NEG_INF`` at length 0);
* ``merge_partials`` of the plain version over M in {1, 2, 3, 4, 8} slot
  slices (each slice's valid slots a prefix: ``clamp(length - r Sc / M, 0,
  Sc / M)``, so slices past the length are empty) against the whole-cache
  plain version (1e-6 in f32) and the reference (1e-5), also as a
  hypothesis property over lengths and M.  At length 0 the merge and the
  kernel give zeros and the reference the mean of V (ROADMAP, known
  difference 5);
* the shape-only path, the work model's extra bytes and ``merge_across``
  with no group (one piece);
* on a mesh of 8 ranks of the ``fake`` backend (no values move): the zero
  states of the RG-LRU, mLSTM and sLSTM laid out as ``cache_spec``'s, a
  microbatch's layout, and the caches ``ops.decode_attention`` refuses.

The kernel itself runs on the card (``chip_smoke.py`` phase 19 (d)).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention as da

SC, DH, BH = 24, 16, 6          # SC divides by every M below
SLICES = (1, 2, 3, 4, 8)
F32_TOL, REF_TOL = 1e-6, 1e-5


def _inputs(seed: int, dtype=torch.float32, BH=BH, S=SC, Dh=DH):
    rng = np.random.default_rng(seed)
    q1, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (BH, 1, Dh), (BH, S, Dh), (BH, S, Dh)))
    return q1, k, v, tuple(torch.from_numpy(x).to(dtype) for x in (q1, k, v))


def _ref(q1, k, v, length: int) -> np.ndarray:
    """The reference's oracle on (B=1, H=BH) heads."""
    import jax.numpy as jnp
    from repro.kernels.ref import decode_ref
    out = decode_ref(jnp.asarray(q1[:, 0][None]), jnp.asarray(k[None]),
                     jnp.asarray(v[None]), length=length)
    return np.asarray(out, np.float32)[0][:, None]


def _lse64(q1, k, length: int) -> np.ndarray:
    s = np.einsum("bd,bsd->bs", q1[:, 0].astype(np.float64),
                  k[:, :length].astype(np.float64)) * np.float32(DH ** -0.5)
    top = s.max(-1)
    return top + np.log(np.exp(s - top[:, None]).sum(-1))


def _sliced(q, k, v, length: int, M: int):
    """The plain version on each of M slot slices, then merged."""
    n = SC // M
    outs, lses = [], []
    for r in range(M):
        local = min(max(length - r * n, 0), n)
        o, l = da.decode_attention_plain(q, k[:, r * n:(r + 1) * n],
                                         v[:, r * n:(r + 1) * n], local,
                                         return_lse=True)
        outs.append(o)
        lses.append(l)
    return da.merge_partials(outs, lses)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 7, 13, SC])
def test_plain_output_and_lse_against_the_reference(dtype, length):
    q1, k, v, (tq, tk, tv) = _inputs(length, dtype)
    out, lse = da.decode_attention_plain(tq, tk, tv, length, return_lse=True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (BH,)
    assert torch.equal(out, da.decode_attention_plain(tq, tk, tv, length))
    if dtype == torch.float32:
        want = _ref(q1, k, v, length)
        np.testing.assert_allclose(out.numpy(), want, atol=REF_TOL)
        np.testing.assert_allclose(lse.numpy(), _lse64(q1, k, length),
                                   rtol=REF_TOL)
    else:       # bf16 inputs: the reference on the same bf16 values
        f = lambda t: t.float().numpy()
        want = _ref(f(tq), f(tk), f(tv), length)
        np.testing.assert_allclose(out.float().numpy(), want, atol=4e-3,
                                   rtol=1e-2)
        np.testing.assert_allclose(lse.numpy(), _lse64(f(tq), f(tk), length),
                                   rtol=REF_TOL)


def test_length_zero_gives_zeros_and_neg_inf():
    """Known difference 5: the reference's oracle averages V there."""
    q1, k, v, (tq, tk, tv) = _inputs(0)
    out, lse = da.decode_attention_plain(tq, tk, tv, 0, return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(lse, torch.full((BH,), da.NEG_INF))
    for M in SLICES:
        merged, L = _sliced(tq, tk, tv, 0, M)
        assert torch.equal(merged, torch.zeros_like(merged))
        assert torch.equal(L, torch.full((BH,), da.NEG_INF))
    assert not np.allclose(_ref(q1, k, v, 0), 0.0)


@pytest.mark.parametrize("M", SLICES)
@pytest.mark.parametrize("length", [1, 2, 5, 12, 17, 23, SC])
def test_merged_slices_equal_the_whole_cache(M, length):
    """Slices past ``length`` are empty (``NEG_INF``) and weigh nothing."""
    q1, k, v, (tq, tk, tv) = _inputs(100 + length)
    whole, lse = da.decode_attention_plain(tq, tk, tv, length,
                                           return_lse=True)
    merged, L = _sliced(tq, tk, tv, length, M)
    assert merged.dtype == torch.float32
    assert float((merged - whole).abs().max()) <= F32_TOL
    np.testing.assert_allclose(L.numpy(), lse.numpy(), rtol=F32_TOL)
    np.testing.assert_allclose(merged.numpy(), _ref(q1, k, v, length),
                               atol=REF_TOL)


@settings(max_examples=40, deadline=None)
@given(length=st.integers(0, SC), M=st.sampled_from(SLICES),
       seed=st.integers(0, 2 ** 16))
def test_merge_property(length, M, seed):
    q1, k, v, (tq, tk, tv) = _inputs(seed)
    merged, _ = _sliced(tq, tk, tv, length, M)
    whole = da.decode_attention_plain(tq, tk, tv, length)
    assert float((merged - whole).abs().max()) <= F32_TOL
    if length:
        np.testing.assert_allclose(merged.numpy(), _ref(q1, k, v, length),
                                   atol=REF_TOL)
    else:
        assert torch.equal(merged, torch.zeros_like(merged))


def test_bf16_merge_rounds_once():
    """bf16 slices merge in f32 and round once: within a bf16 rounding of
    the whole-cache plain version."""
    _, _, _, (tq, tk, tv) = _inputs(7, torch.bfloat16)
    merged, _ = _sliced(tq, tk, tv, 19, 4)
    whole = da.decode_attention_plain(tq, tk, tv, 19)
    assert merged.dtype == torch.bfloat16
    d = (merged.float() - whole.float()).abs()
    assert bool((d <= 4e-3 + 1e-2 * whole.float().abs()).all())


def test_merge_across_no_group_is_the_piece():
    _, _, _, (tq, tk, tv) = _inputs(3)
    out, lse = da.decode_attention_plain(tq, tk, tv, 9, return_lse=True)
    assert torch.equal(da.merge_across(out, lse, []), out)
    empty = da.merge_across(out, torch.full_like(lse, da.NEG_INF), [])
    assert torch.equal(empty, torch.zeros_like(out))


def test_shape_only_path_and_work_carry_the_lse():
    q = torch.empty((BH, 1, DH), device="meta")
    k = torch.empty((BH, SC, DH), device="meta")
    out, lse = da.decode_attention(q, k, k, 5, return_lse=True)
    assert out.shape == (BH, 1, DH) and out.device.type == "meta"
    assert lse.shape == (BH,) and lse.dtype == torch.float32
    assert da.decode_attention(q, k, k, 5).shape == (BH, 1, DH)
    bf16 = torch.bfloat16
    plain = cost.decode_work(3, 7, 8, bf16)
    with_lse = cost.decode_work(3, 7, 8, bf16, lse=True)
    assert with_lse.bytes == plain.bytes + 4 * 3
    assert with_lse.ops == plain.ops and with_lse.flops == plain.flops


def test_wrapper_on_the_cpu_runs_the_plain_version():
    _, _, _, (tq, tk, tv) = _inputs(11)
    calls = da.decode_attention_plain.calls
    out, lse = da.decode_attention(tq, tk, tv, 10, return_lse=True)
    want, want_lse = da.decode_attention_plain(tq, tk, tv, 10,
                                               return_lse=True)
    assert da.decode_attention_plain.calls == calls + 2
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


# ---------------------------------------------------------------------------
# layouts on a mesh of the fake backend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    """data 2 x model 4 on a fake process group of 8 ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_test_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield make_test_mesh(8, device="cpu")
    dist.destroy_process_group()


def _like(mesh, shape, logical):
    """A DTensor of ``shape`` laid out as ``logical`` resolves to (its local
    shard made here, no value moved)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel import sharding as shd
    sh = shd.named_sharding(logical, mesh, shape=shape)
    return DTensor.from_local(torch.zeros(sh.shard_shape(shape)), mesh,
                              sh.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape).stride())


def _reduced(name: str):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(name)), head_pad_multiple=4)


@pytest.mark.parametrize("name,kind", [("recurrentgemma-9b", "rglru"),
                                       ("xlstm-125m", "mlstm"),
                                       ("xlstm-125m", "slstm")])
def test_zero_states_take_the_cache_layout_on_a_mesh(mesh, name, kind):
    """Each zero state built on an input's mesh has the placements and
    shapes ``cache_spec`` gives its kind; without ``like`` it is a plain
    f32 tensor of zeros as before."""
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.models import recurrent as rec
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd
    cfg, B = _reduced(name), 8
    make = {"rglru": rec.rglru_zero_state, "mlstm": rec.mlstm_zero_state,
            "slstm": rec.slstm_zero_state}[kind]
    x = _like(mesh, (B, 64, cfg.d_model), ("batch", "seq", "act_embed"))
    got = tree_leaves(make(cfg, B, like=x))
    pat = tfm.super_block(cfg)[0]
    spec = tfm.cache_spec(cfg, B, 64)["layers"]["stages"][pat.index(kind)]
    want = [shd.named_sharding(s.logical[1:], mesh, shape=s.shape[1:])
            for s in tree_leaves(spec)]
    assert len(got) == len(want) > 0
    for g, w, s in zip(got, want, tree_leaves(spec)):
        assert tuple(g.shape) == s.shape[1:] and g.dtype == torch.float32
        assert tuple(g.placements) == tuple(w.placements)
    assert any(p.is_shard() for g in got for p in g.placements)
    for t in tree_leaves(make(cfg, B)):
        assert not shd.is_dtensor(t) and not t.any()


@pytest.mark.parametrize("B,k,split", [(8, 2, True), (4, 2, True),
                                       (2, 2, False)])
def test_microbatches_are_global_rows_laid_out_over_data(mesh, B, k, split):
    """Each microbatch is laid out as the batch was, its rows split over
    ``data`` where they divide (else whole there)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import _microbatches
    x = _like(mesh, (B, 16), ("batch", "seq"))
    parts = _microbatches(x, k)
    assert len(parts) == k
    for p in parts:
        assert tuple(p.shape) == (B // k, 16)
        assert tuple(p.placements) == ((Shard(0) if split else Replicate()),
                                       Replicate())


def test_a_batch_that_k_does_not_divide_raises():
    from repro_torch.models import _microbatches
    with pytest.raises(ValueError, match="5 rows does not split into 2"):
        _microbatches(torch.zeros(5, 3), 2)


@pytest.mark.parametrize("split,match", [
    ((0, 3), "whole head vectors"),        # head_dim over model
    ((0, 1), "do not divide")])            # 20 slots over 4 ranks
def test_decode_refuses_a_cache_it_cannot_merge(mesh, split, match):
    """A cache split along ``head_dim``, or along its slots unevenly,
    raises before any value moves."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.kernels import ops
    B, S, H, Dh = 8, 18, 4, 16
    pl = tuple(Shard(d) for d in split)
    local = [B // 2, S, H, Dh]
    local[split[1]] = -(-local[split[1]] // 4)
    k = DTensor.from_local(torch.zeros(local), mesh, pl, run_check=False,
                           shape=torch.Size((B, S, H, Dh)),
                           stride=(S * H * Dh, H * Dh, Dh, 1))
    with pytest.raises(ValueError, match=match):
        ops.decode_attention(torch.zeros(B, 1, H, Dh), k, k, S)
