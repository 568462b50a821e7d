"""AdamW, the synthetic data stream and int8 gradient compression: the
port against the reference on the same inputs (numpy from a seed).

AdamW's updates at 1e-6 relative, v at 2e-6 (full and factored v, f32
master weights under bf16 params, bf16 momentum), its schedule and clipping, and weight
decay on every leaf of two or more dimensions (the stacked norms too);
``SyntheticLM``'s tokens, labels and stub modalities bitwise for several
(seed, step); ``compress_grads`` bitwise against the reference's run with
its Pallas kernels in interpret mode (payloads, what the receiver sees,
the residuals, ``stats``), and its error-feedback telescoping.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.data import synthetic as ref_data
from repro.kernels import ops as ref_ops
from repro.optim import adamw as ref_adamw
from repro.optim import grad_compress as ref_gc

from repro_torch import interop
from repro_torch.ckpt.tree import tree_leaves
from repro_torch.configs import get_config, reduced
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.kernels import quant_blockwise as qb
from repro_torch.optim import adamw, grad_compress

CPU = "cpu"


def _rel_max(a, b) -> float:
    """max |a - b| / max |b| (the reference's measure)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _tree(rng, dtype=np.float32):
    """A params-like tree: matrices, a stacked (layers, d) norm, a vector,
    a 3-D stacked weight, and a tiny leaf."""
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(dtype)
    return {"w": f(32, 48), "stack": ({"ln": f(3, 64), "w3": f(3, 16, 24)},),
            "b": f(48), "tiny": f(4)}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree, dtype=None):
    return jax.tree.map(lambda x: interop.tensor_from_array(x, CPU, dtype),
                        tree)


CASES = {
    "full_v": dict(),
    "factored_v": dict(factored_second_moment=True),
    "bf16_momentum": dict(momentum_dtype="bfloat16"),
    "no_decay_warmup": dict(weight_decay=0.0, warmup_steps=3),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["bf16_params_master"])
def test_apply_updates_matches_reference(case):
    """Three steps on the same gradients from numpy; every new param, m and
    master weight at 1e-6, v (or its row/col factors) at 2e-6."""
    kw = CASES.get(case, {})
    ref_cfg = ref_adamw.AdamWConfig(lr=1e-2, total_steps=50, **kw)
    cfg = adamw.AdamWConfig(lr=1e-2, total_steps=50, **kw)
    rng = np.random.default_rng(1)
    p_np = _tree(rng)
    rp, tp = _to_jax(p_np), _to_torch(p_np)
    if case == "bf16_params_master":
        rp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), rp)
        tp = jax.tree.map(lambda x: x.to(torch.bfloat16), tp)
    rs, ts = ref_adamw.init_state(rp, ref_cfg), adamw.init_state(
        tp, cfg, device=CPU)
    assert (rs.master is None) == (ts.master is None)
    for _ in range(3):
        g_np = _tree(rng)
        g_np["w"] *= 40.0                  # the global norm clips
        rg = jax.tree.map(lambda g, p: jnp.asarray(g).astype(p.dtype),
                          g_np, rp)
        tg = jax.tree.map(lambda g, p: interop.tensor_from_array(g, CPU)
                          .to(p.dtype), g_np, tp)
        rp, rs, rmet = ref_adamw.apply_updates(ref_cfg, rp, rg, rs)
        tp, ts, tmet = adamw.apply_updates(cfg, tp, tg, ts)
        for k in ("grad_norm", "lr"):
            assert _rel_max(_np(tmet[k]), rmet[k]) <= 1e-6, k
    assert int(ts.step) == int(rs.step) == 3
    is_v = lambda x: isinstance(x, ref_adamw.FactoredV)
    # v is quadratic in the clipped gradient: twice the 1e-6 of the global
    # norm's f32 sum (summed in another order by each package)
    pairs = [(tree_leaves(tp), jax.tree.leaves(rp), 1e-6),
             (tree_leaves(ts.m), jax.tree.leaves(rs.m), 1e-6),
             (tree_leaves(ts.v), jax.tree.leaves(rs.v), 2e-6)]
    if rs.master is not None:
        pairs.append((tree_leaves(ts.master), jax.tree.leaves(rs.master),
                      1e-6))
    for got, want, tol in pairs:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == getattr(torch, str(b.dtype))
            # a bf16 leaf: one rounding of the f32 value, 2^-8 relative
            t = tol if b.dtype == jnp.float32 else 2.0 ** -8
            assert _rel_max(_np(a), np.asarray(b, np.float32)) <= t
    if case == "factored_v":
        assert isinstance(ts.v["w"], adamw.FactoredV)
        assert isinstance(ts.v["b"], torch.Tensor)
        assert any(is_v(x) for x in jax.tree.leaves(rs.v, is_leaf=is_v))
    # the state crosses over through interop, factored v included
    back = interop.opt_state_from_numpy(jax.device_get(rs), device=CPU)
    assert type(back.v["w"]) is type(ts.v["w"])
    for a, b in zip(tree_leaves(back), tree_leaves(ts)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_schedule_and_clipping_match_reference():
    for kw in (dict(), dict(warmup_steps=5, total_steps=20,
                            min_lr_ratio=0.3)):
        rc, tc = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        for s in (0, 1, 2, 5, 99, 100, 101, 5000, 10000, 12000):
            a = float(ref_adamw.schedule(rc, jnp.asarray(s, jnp.int32)))
            b = float(adamw.schedule(tc, torch.tensor(s, dtype=torch.int32)))
            assert abs(a - b) <= 1e-6 * abs(a) + 1e-12, (kw, s)
    g = _tree(np.random.default_rng(2))
    for max_norm in (0.5, 1e3):
        rc, rn = ref_adamw.clip_by_global_norm(_to_jax(g), max_norm)
        tc, tn = adamw.clip_by_global_norm(_to_torch(g), max_norm)
        assert _rel_max(_np(tn), rn) <= 1e-6
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(rc)):
            assert _rel_max(_np(a), b) <= 1e-6


def test_weight_decay_reaches_every_leaf_of_two_dims():
    """The reference decays ndim >= 2, so the stacked (layers, d) norms
    shrink and the 1-D leaves do not, under zero gradients."""
    p = _to_torch(_tree(np.random.default_rng(3)))
    zero = jax.tree.map(torch.zeros_like, p)
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    new, _, _ = adamw.apply_updates(cfg, p, zero,
                                    adamw.init_state(p, cfg, device=CPU))
    lr = float(adamw.schedule(cfg, torch.tensor(1)))
    for key in ("w",):
        assert torch.allclose(new[key], p[key] * (1 - lr * 0.5), rtol=1e-6)
    ln = new["stack"][0]["ln"]
    assert torch.allclose(ln, p["stack"][0]["ln"] * (1 - lr * 0.5),
                          rtol=1e-6)
    assert torch.equal(new["b"], p["b"]) and torch.equal(new["tiny"],
                                                         p["tiny"])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-125m", "internvl2-1b",
                                  "whisper-tiny"])
def test_synthetic_stream_bitwise_reference(arch):
    rcfg, cfg = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    for seed in (0, 3, 1234):
        ref = ref_data.for_arch(rcfg, batch=3, seq_len=40, seed=seed)
        got = synthetic.for_arch(cfg, batch=3, seq_len=40, seed=seed,
                                 device=CPU)
        for step in (0, 1, 7, 2**20 + 5):
            a, b = ref.peek(step), got.peek(step)
            assert sorted(a) == sorted(b)
            for k in a:
                x, y = np.asarray(a[k]), b[k].numpy()
                assert x.dtype == y.dtype and np.array_equal(x, y), (k, step)
        toks = got.peek(2)
        assert torch.equal(toks["tokens"][:, 1:], toks["labels"][:, :-1])


def test_synthetic_restore_resumes_the_stream():
    cfg = synthetic.DataConfig(vocab_size=100, batch=2, seq_len=8, seed=3)
    d = synthetic.SyntheticLM(cfg, device=CPU)
    next(d)
    next(d)
    st = d.state()
    b1 = next(d)["tokens"]
    d2 = synthetic.SyntheticLM(cfg, device=CPU)
    d2.restore(st)
    assert torch.equal(next(d2)["tokens"], b1)
    assert d2.state() == {"step": 3, "seed": 3}
    with pytest.raises(ValueError, match="seed"):
        d2.restore({"step": 0, "seed": 4})


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _grads_np(rng):
    return {"w": rng.standard_normal((256, 512)).astype(np.float32),
            "ragged": (3.0 * rng.standard_normal((5, 1000))).astype(
                np.float32),
            "stack": ({"ln": rng.standard_normal((3, 700)).astype(
                np.float32)},),
            "b": rng.standard_normal((1023,)).astype(np.float32),
            "tiny": rng.standard_normal((8,)).astype(np.float32)}


def test_compress_grads_bitwise_reference_interpret_mode():
    """Two steps (the second with the first's residuals): the payloads of
    every leaf of >= 1024 elements, the receiver's grads, the residuals and
    ``stats`` equal the reference's with its Pallas kernels in interpret
    mode, bit for bit."""
    rng = np.random.default_rng(4)
    g_np = [_grads_np(rng) for _ in range(2)]
    rs = ref_gc.init_state(_to_jax(g_np[0]))
    ts = grad_compress.init_state(_to_torch(g_np[0]), device=CPU)
    for g in g_np:
        targets = [np.asarray(t) for t in jax.tree.leaves(
            jax.tree.map(lambda a, e: jnp.asarray(a) + e, g, rs.error))]
        big = [t for t in targets if t.size >= 1024]
        _, _, payloads = ops.quantize_arrays(
            [torch.from_numpy(t.copy()) for t in big])
        for t, (q, s, pad) in zip(big, payloads):
            rq, rsc, rpad = ref_ops.quantize_array(jnp.asarray(t),
                                                   force_interpret=True)
            assert pad == rpad
            assert np.array_equal(q.numpy(), np.asarray(rq))
            assert np.array_equal(s.numpy().view(np.uint32),
                                  np.asarray(rsc).view(np.uint32))
        rout, rs, rstats = ref_gc.compress_grads(_to_jax(g), rs,
                                                 force_interpret=True)
        calls = qb.quantize_plain.calls
        tout, ts, tstats = grad_compress.compress_grads(_to_torch(g), ts)
        assert qb.quantize_plain.calls - calls == len(big)
        assert tstats == rstats
        for a, b in zip(tree_leaves(tout) + tree_leaves(ts.error),
                        jax.tree.leaves(rout) + jax.tree.leaves(rs.error)):
            assert np.array_equal(a.numpy().view(np.uint32),
                                  np.asarray(b).view(np.uint32))
    assert tstats["ratio"] < 0.3


def test_compress_grads_error_feedback_telescopes():
    """The reference's property: averaging two compressed sends of the
    same gradient halves-or-better the one-shot error, and tiny leaves
    pass through untouched."""
    g = {"w": torch.from_numpy(np.random.default_rng(5).standard_normal(
        (256, 512)).astype(np.float32)), "b": torch.ones(8)}
    st = grad_compress.init_state(g, device=CPU)
    b1, st, stats = grad_compress.compress_grads(g, st)
    assert stats["ratio"] < 0.3
    b2, st, _ = grad_compress.compress_grads(g, st)
    e1 = float((b1["w"] - g["w"]).abs().max())
    tele = float(((b1["w"] + b2["w"]) / 2 - g["w"]).abs().max())
    assert tele < 0.75 * e1
    assert torch.equal(b1["b"], g["b"]) and torch.equal(b2["b"], g["b"])
