"""The mixture-of-experts FFN in the port against the reference, and the
two MoE archs served, on reduced configs from the reference's parameters
carried across by ``interop.params_from_numpy``.

* ``_router``, ``moe_dense`` and ``moe_capacity`` on the same inputs: f32
  within 1e-5 (relative Frobenius), bf16 within the reference's 3e-2
  (max |a - b| / max |b|).  The capacity path in both of its branches
  (the scan over 512-slot chunks when C is a multiple of 512 above it,
  one call otherwise) and both combines (top-1's inverse gather, top-k's
  scatter-add).
* Ties: ``jax.lax.top_k`` puts equal values in increasing index order and
  ``torch.topk`` does not; with top-1 every selected token weighs exactly
  1, so an expert over capacity keeps its lowest-index tokens.  The
  tokens dropped must be the reference's.
* llama4 runs at 4 layers, one super-block (three chunked MoE layers and
  a global NoPE one): ``reduced`` gives 2, which holds no super-block and
  never runs the global layer.
* Whole models: ``tests/test_torch_serve_encdec.py``'s measures (f32
  logits row by row, the rows' median within 1e-5 and every row within
  1e-4; bf16 as ``tests/test_torch_serve.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import build as ref_build
from repro.models import moe as ref_moe

from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.models import build
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

from test_torch_serve import (_assert_cache_close, _frob, _max_rel, _rand,
                              _t)
from test_torch_serve_encdec import _assert_logits_close

CPU = "cpu"
S, NEW, B = 40, 4, 2
ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")


def _cfgs(name, cd="float32", kv="bfloat16", **kw):
    """The reference's and the port's reduced config (llama4 at 4
    layers)."""
    if name.startswith("llama4"):
        kw.setdefault("n_layers", 4)
    return [dataclasses.replace(red(get(name)), compute_dtype=cd,
                                kv_cache_dtype=kv, **kw)
            for get, red in ((ref_get_config, ref_reduced),
                             (get_config, reduced))]


@functools.lru_cache(maxsize=8)
def _ref_params(name, seed):
    """The reference's init of the reduced arch (the same whatever the
    compute dtype, cache dtype or ``moe_impl``), as numpy."""
    return jax.device_get(ref_build(_cfgs(name)[0]).init(
        jax.random.key(seed)))


def _moe_params(name, seed):
    """Layer 0's MoE parameters of the reference's init."""
    return jax.tree.map(lambda a: np.asarray(a[0]),
                        _ref_params(name, seed)["stages"][0]["moe"])


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: _t(a), tree))


def _check(got, want, dtype):
    if dtype == "float32":
        assert _frob(got, want) <= 1e-5
    else:
        assert _max_rel(got, want) <= 3e-2


def test_top_breaks_ties_as_jax():
    """``_top`` is ``jax.lax.top_k``: ones at 3, 7, 11, 20 and 33 of 40
    zeros give [3 7 11 20 33 0 1 2], where ``torch.topk`` gives another
    order."""
    x = np.zeros(40, np.float32)
    x[[3, 7, 11, 20, 33]] = 1.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 8)
    got_v, got_i = moe._top(torch.as_tensor(x), 8)
    assert got_i.tolist() == np.asarray(want_i).tolist() == [
        3, 7, 11, 20, 33, 0, 1, 2]
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    rows = np.random.default_rng(0).integers(0, 3, (64, 16)).astype(
        np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(rows), 5)
    got_v, got_i = moe._top(torch.as_tensor(rows), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_router_matches_reference(name, dtype):
    """The combine weights (f32) on the same inputs, and with tied router
    columns (experts 0 and 2 equal): the tie goes to the lower expert."""
    rcfg, cfg = _cfgs(name, dtype)
    pn = _moe_params(name, 1)
    x = _rand(np.random.default_rng(2), (B, S, cfg.d_model), dtype)
    for tied in (False, True):
        if tied:
            pn = dict(pn, router=pn["router"].copy())
            pn["router"][:, 2] = pn["router"][:, 0]
        rp, pp = _both(pn)
        want = np.asarray(ref_moe._router(rcfg, rp, jnp.asarray(x)))
        got = moe._router(cfg, pp, _t(x))
        assert got.dtype == torch.float32
        assert _frob(got, want) <= 1e-6
        np.testing.assert_array_equal(got.numpy() > 0, want > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_dense_matches_reference(name, dtype):
    """``moe_dense`` in one token chunk and in five (``token_chunk=8``;
    the reference's scan), and at S = 1 (decode)."""
    rcfg, cfg = _cfgs(name, dtype)
    rp, pp = _both(_moe_params(name, 3))
    rng = np.random.default_rng(4)
    cd = (getattr(jnp, dtype), getattr(torch, dtype))
    for s, chunk in ((S, 1024), (S, 8), (1, 1024)):
        x = _rand(rng, (B, s, cfg.d_model), dtype)
        want = ref_moe.moe_dense(rcfg, rp, jnp.asarray(x), cd[0],
                                 token_chunk=chunk)
        got = moe.moe_dense(cfg, pp, _t(x), cd[1], token_chunk=chunk)
        assert got.dtype == cd[1] and tuple(got.shape) == want.shape
        _check(got, want, dtype)


#: (arch, top_k, S): C = int(S k / E * 1.25) with E = 4 of the reduced
#: configs.  S 40 gives C 25 (top-2) or 12 (top-1): one call; S 1639 gives
#: C 1024 at top-2 and S 3277 C 1024 at top-1: the scan over two 512-slot
#: chunks.
CAPACITY = [("dbrx-132b", 2, 40), ("dbrx-132b", 2, 1639),
            ("llama4-scout-17b-a16e", 1, 40),
            ("llama4-scout-17b-a16e", 1, 3277)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,k,s", CAPACITY)
def test_moe_capacity_matches_reference(name, k, s, dtype):
    rcfg, cfg = _cfgs(name, dtype, moe_impl="capacity")
    assert cfg.top_k == k
    rp, pp = _both(_moe_params(name, 5))
    x = _rand(np.random.default_rng(6), (1, s, cfg.d_model), dtype)
    want = ref_moe.moe_capacity(rcfg, rp, jnp.asarray(x),
                                getattr(jnp, dtype))
    got = moe.moe_capacity(cfg, pp, _t(x), getattr(torch, dtype))
    assert tuple(got.shape) == want.shape
    _check(got, want, dtype)
    # moe_ffn takes the capacity path for S > 1 and the dense one at S = 1
    _check(moe.moe_ffn(cfg, pp, _t(x), getattr(torch, dtype)), want, dtype)
    x1 = x[:, :1]
    _check(moe.moe_ffn(cfg, pp, _t(x1), getattr(torch, dtype)),
           ref_moe.moe_dense(rcfg, rp, jnp.asarray(x1), getattr(jnp, dtype)),
           dtype)


@pytest.mark.parametrize("s", [40, 3277])
def test_top1_over_capacity_drops_are_the_references(s):
    """Top-1 with a router that sends every token to expert 1: every
    selected token weighs 1, so the capacity (12 or 1024 slots) keeps the
    expert's lowest-index tokens and drops the rest, as the reference does.
    Without the shared expert a dropped token's output is exactly 0."""
    rcfg, cfg = _cfgs("llama4-scout-17b-a16e", "float32",
                      moe_impl="capacity", shared_expert=False)
    pn = {k: v for k, v in _moe_params("llama4-scout-17b-a16e", 7).items()
          if k != "shared"}
    d = cfg.d_model
    router = np.zeros_like(pn["router"])
    router[0, 1] = 8.0                 # feature 0 >= 1 picks expert 1
    pn = dict(pn, router=router)
    x = np.random.default_rng(8).standard_normal((2, s, d)).astype(
        np.float32)
    x[:, :, 0] = np.abs(x[:, :, 0]) + 1.0
    rp, pp = _both(pn)
    want = np.asarray(ref_moe.moe_capacity(rcfg, rp, jnp.asarray(x),
                                           jnp.float32))
    got = moe.moe_capacity(cfg, pp, _t(x), torch.float32).numpy()
    dropped_ref = np.all(want == 0, axis=-1)
    dropped = np.all(got == 0, axis=-1)
    C = int(s / cfg.n_experts * 1.25)
    assert dropped_ref.sum(axis=1).tolist() == [s - C] * 2
    np.testing.assert_array_equal(dropped, dropped_ref)
    assert not dropped[:, :C].any()           # the lowest indices kept
    assert _frob(got, want) <= 1e-5


def test_moe_capacity_close_to_dense():
    """The reference's test (tests/test_models.py) on the port: with a
    generous capacity factor (4.0, no drops) the capacity MoE's logits
    stay within 5e-2 (max-abs relative) of the dense MoE's."""
    base = reduced(get_config("dbrx-132b"))
    m_dense = build(base)
    m_cap = build(dataclasses.replace(base, moe_impl="capacity"))
    params = m_dense.init(torch.Generator().manual_seed(0), device=CPU)
    toks = torch.randint(0, base.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    orig = moe.moe_capacity
    with torch.no_grad():
        ld, _ = m_dense.forward(params, toks)
        try:
            moe.moe_capacity = functools.partial(orig, capacity_factor=4.0)
            lc, _ = m_cap.forward(params, toks)
        finally:
            moe.moe_capacity = orig
    a, b = ld.float().numpy(), lc.float().numpy()
    err = np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)
    assert err < 0.05, err


_RIGS: dict = {}


def _rig(name, cd, kv, impl):
    """Both packages' reduced model, the reference's params in both, and
    the reference's jitted prefill of a (B, S) prompt and four
    teacher-forced decode steps, once a module."""
    key = (name, cd, kv, impl)
    if key not in _RIGS:
        rcfg, cfg = _cfgs(name, cd, kv, moe_impl=impl)
        rm = ref_build(rcfg)
        rp = _ref_params(name, 7)
        p = interop.params_from_numpy(rp, cfg, device=CPU)
        rp = jax.tree.map(jnp.asarray, rp)
        toks = np.random.default_rng(8).integers(
            0, cfg.vocab_size, (B, S + NEW)).astype(np.int32)
        prefill = jax.jit(rm.prefill, static_argnames=("max_cache_seq",))
        logits, cache = prefill(rp, {"tokens": jnp.asarray(toks[:, :S])},
                                max_cache_seq=S + NEW)
        steps = [jax.device_get((logits, cache))]
        dec = jax.jit(rm.decode_step)
        for i in range(NEW):
            logits, cache = dec(rp, cache,
                                jnp.asarray(toks[:, S + i:S + i + 1]))
            steps.append(jax.device_get((logits, cache)))
        _RIGS[key] = (cfg, p, toks, steps)
    return _RIGS[key]


#: (compute dtype, KV cache dtype, moe_impl); bf16 runs are held against
#: the reference's f32 run of the same cache dtype and impl.
MODEL_CASES = [("float32", "bfloat16", "dense"),
               ("float32", "int8", "capacity"),
               ("bfloat16", "bfloat16", "dense"),
               ("bfloat16", "int8", "capacity")]


@pytest.mark.parametrize("cd,kv,impl", MODEL_CASES)
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name, cd, kv, impl):
    """``Model.prefill`` in one wave and in two (logits and the whole cache
    tree: llama4's chunked ring of 32 slots wrapped by the 40-token prompt
    and its global layer's full cache), then four teacher-forced
    ``decode_step``s from the reference's own cache (the MoE's S = 1 runs
    the dense path whatever ``moe_impl``)."""
    cfg, p, toks, steps = _rig(name, cd, kv, impl)
    truth = _rig(name, "float32", kv, impl)[3]
    if name.startswith("llama4"):
        assert tfm.super_block(cfg) == (("moe:chunked",) * 3
                                        + ("moe:global_nope",), 1, ())
    for waves in (1, 2):
        mw = build(dataclasses.replace(cfg, prefill_waves=waves))
        with torch.no_grad():
            logits, cache = mw.prefill(p, {"tokens": _t(toks[:, :S])},
                                       max_cache_seq=S + NEW)
        _assert_logits_close(logits, steps[0][0], truth[0][0], cfg,
                             what=waves)
        _assert_cache_close(cache, steps[0][1], truth[0][1], cfg)
    m = build(cfg)
    cache = interop.cache_from_numpy(steps[0][1], cfg, device=CPU)
    f32_tol = 1 / 127 if kv == "int8" else 1e-5
    for i in range(NEW):
        with torch.no_grad():
            logits, cache = m.decode_step(p, cache,
                                          _t(toks[:, S + i:S + i + 1]))
        _assert_logits_close(logits, steps[i + 1][0], truth[i + 1][0], cfg,
                             f32_tol, what=i)
    _assert_cache_close(cache, steps[-1][1], truth[-1][1], cfg)


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_loss_and_gradients_match_reference(impl):
    """``loss_fn`` of reduced llama4 (4 layers, its shared expert) in f32:
    the loss within 1e-5, every gradient leaf within 1e-4 (relative
    Frobenius), autograd through the routing's gathers and scatters.  The
    router's gradient is zero under top-1 (a token's one weight is
    v / v = 1 whatever v), so both packages give rounding noise there
    (~1e-9): such a leaf, under 1e-6 of the largest gradient in the
    reference, must be so in the port."""
    from repro_torch.ckpt.tree import tree_flatten, tree_unflatten
    rcfg, cfg = _cfgs("llama4-scout-17b-a16e", moe_impl=impl)
    rm, m = ref_build(rcfg), build(cfg)
    rp = jax.tree.map(jnp.asarray, _ref_params("llama4-scout-17b-a16e", 9))
    rng = np.random.default_rng(10)
    toks, labs = (rng.integers(0, cfg.vocab_size, (B, 48)).astype(np.int32)
                  for _ in range(2))
    loss, grads = jax.jit(jax.value_and_grad(rm.loss))(
        rp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    p = interop.params_from_numpy(jax.device_get(rp), cfg, device=CPU)
    leaves, td = tree_flatten(p)
    leaves = [x.detach().requires_grad_() for x in leaves]
    ploss = m.loss(tree_unflatten(td, leaves),
                   {"tokens": _t(toks), "labels": _t(labs)})
    pgrads = torch.autograd.grad(ploss, leaves)
    assert abs(float(ploss.detach()) / float(loss) - 1.0) <= 1e-5
    refs = [np.asarray(r) for r in jax.tree.leaves(grads)]
    assert len(refs) == len(pgrads)
    top = max(np.linalg.norm(r) for r in refs)
    errs = []
    for g, r in zip(pgrads, refs):
        if np.linalg.norm(r) <= 1e-6 * top:
            assert float(torch.linalg.vector_norm(g)) <= 1e-6 * top
        else:
            errs.append(_frob(g.detach(), r))
    assert max(errs) <= 1e-4, errs
