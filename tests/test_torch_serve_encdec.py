"""whisper's encoder-decoder and internvl's prefix input in the port against
the reference, on reduced configs, from the reference's parameters
carried across by ``interop.params_from_numpy``.

The measures and tolerances are ``tests/test_torch_serve.py``'s: f32
compute within 1e-5 (relative Frobenius), bf16 within the reference's
3e-2 or its bf16 accuracy against its own f32 run; int8 payloads within
one step in f32.  f32 logits are held row by row (a sequence at a step):
the rows' median within 1e-5 and every row within 1e-4.  The reference's
init makes attention near one-hot, and where two keys nearly tie an ulp
of difference moves one row by more than the rest: reduced internvl's
prefill puts one of its two rows at 1.5e-5 and the other at 1.6e-6 (the
full forward's 80 rows: median 1.0e-6).  A wrong mask, position or
state moves every row by O(1).  The cross K/V the cache keeps
(``xk``/``xv``) stay in the compute dtype whatever the KV cache's dtype.
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
from repro.models import attention as ref_attn
from repro.models import build as ref_build

from repro_torch import interop
from repro_torch.ckpt.tree import tree_flatten, tree_unflatten
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as attn
from repro_torch.models import build

from test_torch_serve import (_assert_cache_close, _assert_close, _frob,
                              _rand, _t)

CPU = "cpu"
S, NEW, B = 24, 4, 2
ARCHS = ("whisper-tiny", "internvl2-1b")
CASES = [(cd, kv) for cd in ("float32", "bfloat16")
         for kv in ("bfloat16", "int8")]


def _cfgs(name, cd="float32", kv="bfloat16"):
    return [dataclasses.replace(red(get(name)), compute_dtype=cd,
                                kv_cache_dtype=kv)
            for get, red in ((ref_get_config, ref_reduced),
                             (get_config, reduced))]


def _extras(cfg, rng, batch: int) -> dict:
    """The stub inputs: frames for whisper, a prefix for internvl (0.02
    times a normal draw, as the reference's launcher makes them)."""
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = (0.02 * rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if cfg.n_prefix_tokens:
        out["prefix"] = (0.02 * rng.standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model))).astype(np.float32)
    return out


def _assert_logits_close(got, want, truth, cfg, f32_tol=1e-5, what=""):
    """Logits (B, 1, V): in f32 the rows' median within ``f32_tol`` and
    every row within the larger of 1e-4 and ``f32_tol`` (module
    docstring); in bf16 as :func:`_assert_close`."""
    if cfg.compute_dtype != "float32":
        _assert_close(got, want, truth, cfg, what=what)
        return
    errs = [_frob(g, w) for g, w in zip(got, want)]
    assert np.median(errs) <= f32_tol, (what, errs)
    assert max(errs) <= max(1e-4, f32_tol), (what, errs)


def _port_batch(batch: dict) -> dict:
    return {k: _t(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=8)
def _ref_params(name, seed):
    """The reference's init of the reduced arch (the same whatever the
    compute and cache dtypes), as numpy."""
    return jax.device_get(ref_build(_cfgs(name)[0]).init(
        jax.random.key(seed)))


_RIGS: dict = {}


def _rig(name, cd, kv):
    """The reference's params in both packages, a (B, S) prompt with its
    stub inputs, and the reference's jitted prefill and four teacher-forced
    decode steps (logits and caches), once a module."""
    key = (name, cd, kv)
    if key not in _RIGS:
        rcfg, cfg = _cfgs(name, cd, kv)
        rm = ref_build(rcfg)
        rp = _ref_params(name, 7)
        p = interop.params_from_numpy(rp, cfg, device=CPU)
        rp = jax.tree.map(jnp.asarray, rp)
        rng = np.random.default_rng(8)
        toks = rng.integers(0, cfg.vocab_size, (B, S + NEW)).astype(np.int32)
        batch = {"tokens": toks[:, :S], **_extras(cfg, rng, B)}
        total = S + (cfg.n_prefix_tokens or 0) + NEW
        prefill = jax.jit(rm.prefill, static_argnames=("max_cache_seq",))
        logits, cache = prefill(rp, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, max_cache_seq=total)
        steps = [jax.device_get((logits, cache))]
        dec = jax.jit(rm.decode_step)
        for i in range(NEW):
            logits, cache = dec(rp, cache,
                                jnp.asarray(toks[:, S + i:S + i + 1]))
            steps.append(jax.device_get((logits, cache)))
        _RIGS[key] = (cfg, p, toks, batch, total, steps)
    return _RIGS[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """``cross_kv`` and ``cross_attention`` (flash in the bidir mode, 24
    queries against 40 encoder positions) on the same inputs, whisper's
    full head count over reduced widths."""
    rcfg, cfg = _cfgs("whisper-tiny", dtype)
    xp = _ref_params("whisper-tiny", 3)["stages"][0]["xattn"]
    xp = {k: v[0] for k, v in xp.items()}          # layer 0 of the stack
    rng = np.random.default_rng(4)
    x = _rand(rng, (B, S, cfg.d_model), dtype)
    enc = _rand(rng, (B, 40, cfg.d_model), dtype)
    cd = getattr(jnp, dtype)
    want_y, (want_k, want_v) = ref_attn.cross_attention(
        rcfg, {k: jnp.asarray(v) for k, v in xp.items()}, jnp.asarray(x),
        jnp.asarray(enc), cd)
    pp = {k: _t(v) for k, v in xp.items()}
    got_k, got_v = attn.cross_kv(cfg, pp, _t(enc), getattr(torch, dtype))
    got_y, (k2, v2) = attn.cross_attention(cfg, pp, _t(x), _t(enc),
                                           getattr(torch, dtype))
    tol = 1e-6 if dtype == "float32" else 3e-2
    for got, want in ((got_k, want_k), (got_v, want_v), (k2, want_k),
                      (v2, want_v), (got_y, want_y)):
        assert tuple(got.shape) == want.shape
        assert _frob(got, want) <= tol


@pytest.mark.parametrize("cd,kv", CASES)
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name, cd, kv):
    """``Model.prefill`` in one wave and in two (the frames and the prefix
    split by wave): the next-token logits and the whole cache tree, the
    cross K/V in the compute dtype."""
    cfg, p, toks, batch, total, steps = _rig(name, cd, kv)
    truth = _rig(name, "float32", kv)[5]
    for waves in (1, 2):
        mw = build(dataclasses.replace(cfg, prefill_waves=waves))
        with torch.no_grad():
            logits, cache = mw.prefill(p, _port_batch(batch),
                                       max_cache_seq=total)
        assert logits.shape == (B, 1, cfg.padded_vocab())
        _assert_logits_close(logits, steps[0][0], truth[0][0], cfg,
                             what=waves)
        _assert_cache_close(cache, steps[0][1], truth[0][1], cfg)
        if cfg.is_encoder_decoder:
            entry = cache["layers"]["stages"][0]
            assert entry["xk"].dtype == entry["xv"].dtype == getattr(
                torch, cd)
            assert entry["xk"].shape[2] == cfg.encoder_seq


@pytest.mark.parametrize("cd,kv", CASES)
@pytest.mark.parametrize("name", ARCHS)
def test_decode_from_reference_cache_matches_reference(name, cd, kv):
    """Four teacher-forced ``decode_step``s from the reference's prefill
    cache: each step's logits (whisper: the sinusoidal offset of the
    position and the cross attention over all of the cross cache) and the
    whole cache tree after the last."""
    cfg, p, toks, batch, total, steps = _rig(name, cd, kv)
    truth = _rig(name, "float32", kv)[5]
    m = build(cfg)
    cache = interop.cache_from_numpy(steps[0][1], cfg, device=CPU)
    f32_tol = 1 / 127 if kv == "int8" else 1e-5
    for i in range(NEW):
        with torch.no_grad():
            logits, cache = m.decode_step(p, cache,
                                          _t(toks[:, S + i:S + i + 1]))
        _assert_logits_close(logits, steps[i + 1][0], truth[i + 1][0], cfg,
                             f32_tol, what=i)
    assert int(cache["pos"]) == total
    _assert_cache_close(cache, steps[-1][1], truth[-1][1], cfg)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_reference(name):
    """``loss_fn`` with whisper's frames and with internvl's prefix (its
    logits cut past the prefix) in f32 compute: the loss within 1e-5 and
    every gradient leaf within 1e-4 (relative Frobenius), autograd
    through the plain attention."""
    rcfg, cfg = _cfgs(name)
    rm, m = ref_build(rcfg), build(cfg)
    rp = jax.tree.map(jnp.asarray, _ref_params(name, 9))
    rng = np.random.default_rng(10)
    toks, labs = (rng.integers(0, cfg.vocab_size, (B, 32)).astype(np.int32)
                  for _ in range(2))
    labs[0, :5] = -1                                 # masked labels
    batch = {"tokens": toks, "labels": labs, **_extras(cfg, rng, B)}
    loss, grads = jax.jit(jax.value_and_grad(rm.loss))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    p = interop.params_from_numpy(jax.device_get(rp), cfg, device=CPU)
    leaves, td = tree_flatten(p)
    leaves = [x.detach().requires_grad_() for x in leaves]
    ploss = m.loss(tree_unflatten(td, leaves), _port_batch(batch))
    pgrads = torch.autograd.grad(ploss, leaves)
    assert abs(float(ploss.detach()) / float(loss) - 1.0) <= 1e-5
    errs = [_frob(g.detach(), np.asarray(r))
            for g, r in zip(pgrads, jax.tree.leaves(grads))]
    assert len(errs) == len(pgrads) and max(errs) <= 1e-4, errs


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_matches_full_forward(name):
    """The reference's serving check (tests/test_models.py) on the port:
    four decode steps after a prefill against the growing full forward
    (teacher-forced), within 3e-2 (max-abs relative) in bf16."""
    cfg = _cfgs(name, "bfloat16")[1]
    m = build(cfg)
    params = m.init(torch.Generator().manual_seed(3), device=CPU)
    toks = torch.randint(0, cfg.vocab_size, (1, 20),
                         generator=torch.Generator().manual_seed(3))
    extra = _port_batch(_extras(cfg, np.random.default_rng(3), 1))
    with torch.no_grad():
        _, cache = m.prefill(params, {"tokens": toks[:, :16], **extra},
                             max_cache_seq=20 + (cfg.n_prefix_tokens or 0))
        for i in range(4):
            lg, cache = m.decode_step(params, cache, toks[:, 16 + i:17 + i])
            full, _ = m.forward(params, toks[:, :17 + i], **extra)
            a, b = lg[:, 0].float().numpy(), full[:, -1].float().numpy()
            err = np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)
            assert err < 3e-2, (i, err)


def test_encoder_decoder_needs_frames():
    cfg = _cfgs("whisper-tiny")[1]
    m = build(cfg)
    params = m.init(torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError, match="frames"):
        m.forward(params, torch.zeros((1, 8), dtype=torch.int64))
