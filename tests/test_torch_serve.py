"""The serving path in the port (attention, the KV cache, prefill in waves,
decode, the RG-LRU block) against the reference on reduced configs, from
the reference's parameters carried across by ``interop.params_from_numpy``.

Measures and tolerances.

* The modules (attention in each mask mode, decode attention, the RG-LRU
  block) on the same inputs: max |a - b| / max |b| (the reference's
  measure), 1e-6 in f32 (1e-5 for the RG-LRU's log-depth scan against the
  port's sequential one) and the reference's bf16 tolerance, 3e-2 (5e-2
  for sliding-window archs).  ``_kv_quant``/``_kv_dequant`` bitwise.
* Whole models in f32 compute: a relative Frobenius error of 1e-5.  Two
  layers of attention amplify the modules' f32 rounding, so the max-abs
  measure, which reads the worst logit, can exceed 1e-5 where the
  Frobenius one, which reads them all, stays within it.  An int8 KV cache in f32: the payloads
  within one step, and logits read from a cache whose newest slot may
  have flipped a step, within one step's share, 1/127.
* Whole models in bf16 compute: within the reference's bf16 tolerance
  of the reference's bf16 run, or else held to the reference's bf16
  *accuracy*: the port's relative Frobenius error against the reference's
  f32 run on the same params and tokens may not pass the larger of that
  tolerance and twice the reference's own bf16 error against the f32 run.
  The two packages round bf16 at other points (XLA fuses elementwise
  chains and rounds them once), and bf16 rounding is chaotic on these
  random reduced models: the reference's own bf16 logits lie tenths
  (max-abs) from its f32 ones, and port and reference differ by as much
  while each is about as far from f32 as the other.  A fault (a wrong
  mask, position or state) moves the logits by O(1) in either precision;
  the f32 comparisons are the tight ones.
* Decode is compared teacher-forced, never by greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attn
from repro.models import build as ref_build
from repro.models import recurrent as ref_rec
from repro.models import transformer as ref_tfm

from repro_torch import interop
from repro_torch.ckpt.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as attn
from repro_torch.models import build
from repro_torch.models import recurrent as rec
from repro_torch.models import transformer as tfm

CPU = "cpu"
S, NEW = 40, 4                 # the prompt passes the reduced window of 32
B = 2
ARCHS = ("starcoder2-3b", "codeqwen1.5-7b", "granite-20b",
         "recurrentgemma-9b", "xlstm-125m", "chunked-global")
CASES = [(cd, kv) for cd in ("float32", "bfloat16")
         for kv in ("bfloat16", "int8")]


def _cfgs(name, cd="bfloat16", kv="bfloat16"):
    """The reference's and the port's reduced config.  ``chunked-global``
    is reduced starcoder2-3b with llama4's layer pattern without experts
    (a chunked layer of 16, then a global NoPE one): the chunked and
    global kinds of the cache."""
    arch = "starcoder2-3b" if name == "chunked-global" else name
    out = []
    for get, red in ((ref_get_config, ref_reduced), (get_config, reduced)):
        c = red(get(arch))
        if name == "chunked-global":
            c = dataclasses.replace(c, attention="chunked_global",
                                    global_every=2, chunk=16, window=0)
        out.append(dataclasses.replace(c, compute_dtype=cd,
                                       kv_cache_dtype=kv))
    return out


def _tol(cfg) -> float:
    """The reference's bf16 tolerance (tests/test_models.py)."""
    return 5e-2 if cfg.attention == "sliding" else 3e-2


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = interop.array_from_tensor(x)
    return np.asarray(x).astype(np.float64)


def _max_rel(a, b) -> float:
    a, b = _f64(a), _f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _frob(a, b) -> float:
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_close(got, want, truth, cfg, f32_tol=1e-5, what=""):
    """The port's ``got`` against the reference's ``want`` (same compute
    dtype) and, in bf16, against the reference's f32 ``truth`` (module
    docstring)."""
    if cfg.compute_dtype == "float32":
        assert _frob(got, want) <= f32_tol, what
        return
    if _max_rel(got, want) <= _tol(cfg):
        return
    bound = max(_tol(cfg), 2.0 * _frob(want, truth))
    assert _frob(got, truth) <= bound, (what, _max_rel(got, want))


def _assert_cache_close(got, want, truth, cfg):
    """Every leaf of the port's cache against the reference's: the same
    structure and dtypes; ``pos`` and ``slot_pos`` equal (on the host);
    int8 payloads within one step in f32 compute; the rest as
    :func:`_assert_close`."""
    gl, gt = tree_flatten(got)
    wl, wt = tree_flatten(jax.device_get(want))
    tl = tree_leaves(jax.device_get(truth))
    assert str(gt) == str(wt)
    specs = tree_leaves(tfm.cache_spec(cfg, 1, 1))
    for g, w, t, s in zip(gl, wl, tl, specs):
        w = np.asarray(w)
        assert interop.array_from_tensor(g).dtype == w.dtype
        assert tuple(g.shape) == w.shape
        if "batch" not in s.logical:
            assert g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), w)
        elif w.dtype == np.int8 and cfg.compute_dtype == "float32":
            assert np.abs(_f64(g) - _f64(w)).max() <= 1
        elif w.size:
            _assert_close(g, w, t, cfg, what=s)


def _rand(rng, shape, dtype="float32", scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(
        jnp.bfloat16 if dtype == "bfloat16" else np.float32)


def _t(a, dtype=None):
    return interop.tensor_from_array(a, CPU, dtype)


# ---------------------------------------------------------------------------
# Attention, decode masks, the int8 KV cache, the RG-LRU block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,window,chunk", [
    ("causal", 0, 0), ("sliding", 24, 0), ("sliding", 96, 0),
    ("chunked", 0, 16), ("bidir", 0, 0)])
def test_attention_matches_reference(mode, window, chunk, dtype):
    """``attention`` in each mask mode (a window at least the sequence
    takes the reference's causal branch) on the same inputs."""
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, (2, 64, 4, 16), dtype) for _ in range(3))
    want = ref_attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mode=mode, window=window, chunk=chunk)
    got = attn.attention(_t(q), _t(k), _t(v), mode=mode, window=window,
                         chunk=chunk)
    assert _max_rel(got, want) <= (1e-6 if dtype == "float32" else 3e-2)


def _ref_allowed(slot_pos, pos, mode, window, chunk) -> np.ndarray:
    """The slots the reference's ``decode_attention`` attends, read from
    the function itself: zero q and k give every allowed slot one weight,
    and an identity V (Dh = Sc) returns the weights."""
    Sc = slot_pos.shape[0]
    q = jnp.zeros((1, 1, 1, Sc), jnp.float32)
    ck = jnp.zeros((1, Sc, 1, Sc), jnp.float32)
    cv = jnp.eye(Sc, dtype=jnp.float32)[None, :, None, :]
    cfg = dataclasses.replace(ref_reduced(ref_get_config("starcoder2-3b")),
                              n_heads=1, n_kv_heads=1)
    w = ref_attn.decode_attention(cfg, q, ck, cv, slot_pos,
                                  jnp.asarray(pos, jnp.int32), mode=mode,
                                  window=window, chunk=chunk)
    return np.asarray(w)[0, 0, 0] > 0


@pytest.mark.parametrize("kind,max_seq,window,chunk", [
    ("attn", 24, 0, 0), ("sliding", 40, 8, 0), ("sliding", 6, 8, 0),
    ("chunked", 40, 0, 8), ("chunked", 5, 0, 8)])
def test_decode_length_is_the_reference_mask(kind, max_seq, window, chunk):
    """For each cache kind, every prompt length below ``max_seq`` and every
    decode position from it to 12 past ``max_seq`` (the ring wraps where
    the prompt or the decode passes the cache length), the prefix length
    equals the reference's ``slot_pos`` mask; where ``decode_length``
    refuses (a chunk longer than a wrapped ring), the reference's mask is
    no prefix."""
    cfg = dataclasses.replace(ref_reduced(ref_get_config("starcoder2-3b")),
                              window=window, chunk=chunk, attention="full",
                              block_pattern=(kind,))
    mode = tfm._attn_mode(kind)[0]
    Sc = ref_tfm._cache_len(cfg, kind, max_seq)
    checked = refused = 0
    for S0 in range(1, max_seq):
        sp = ref_tfm._prefill_slot_pos(cfg, S0, max_seq)[kind]
        for pos in range(S0, max_seq + 12):
            sp = sp.at[pos % Sc].set(pos)
            want = _ref_allowed(sp, pos, mode, window, chunk)
            try:
                n = attn.decode_length(mode, pos, Sc, window, chunk)
            except ValueError:
                refused += 1
                assert not np.array_equal(want, np.arange(Sc) < want.sum())
                continue
            np.testing.assert_array_equal(np.arange(Sc) < n, want,
                                          err_msg=f"S0 {S0} pos {pos}")
            checked += 1
    assert checked + refused == (max_seq - 1) * (max_seq + 24) // 2
    assert refused == 0 or (kind == "chunked" and Sc < chunk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,Sc,pos", [
    ("causal", 48, 30), ("sliding", 32, 20), ("sliding", 32, 75),
    ("chunked", 16, 37), ("chunked", 16, 47)])
def test_decode_attention_matches_reference(mode, Sc, pos, dtype):
    """``decode_attention`` on a GQA cache (4 q heads over 2 KV heads)
    against the reference's grouped einsum with its ``slot_pos`` mask,
    before and after the ring wraps."""
    cfg = dataclasses.replace(ref_reduced(ref_get_config("starcoder2-3b")),
                              n_heads=4, n_kv_heads=2, window=32, chunk=16)
    pcfg = dataclasses.replace(reduced(get_config("starcoder2-3b")),
                               n_heads=4, n_kv_heads=2, window=32, chunk=16)
    rng = np.random.default_rng(pos)
    q = _rand(rng, (2, 1, 4, 16), dtype)
    ck, cv = (_rand(rng, (2, Sc, 2, 16), dtype) for _ in range(2))
    held = np.arange(pos - min(pos + 1, Sc) + 1, pos + 1)
    sp = np.full(Sc, -1, np.int32)
    sp[held % Sc] = held
    want = ref_attn.decode_attention(
        cfg, jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(sp), jnp.asarray(pos, jnp.int32), mode=mode,
        window=cfg.window, chunk=cfg.chunk)
    got = attn.decode_attention(pcfg, _t(q), _t(ck), _t(cv), pos,
                                mode=mode, window=pcfg.window,
                                chunk=pcfg.chunk)
    assert got.shape == (2, 1, 4, 16)
    assert _max_rel(got, want) <= (1e-6 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("n_heads,n_kv,pad,hq", [
    (6, 2, 4, 8), (6, 2, 1, 6), (4, 1, 1, 4), (4, 4, 1, 4), (5, 2, 1, 5)])
def test_expand_kv_is_the_reference_gather_laid_out_head_major(
        n_heads, n_kv, pad, hq):
    """The broadcast copy, with the last KV head repeated for padded heads
    or a group size that does not divide, equals the reference's
    gather."""
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv, head_pad_multiple=pad)
    cfg = dataclasses.replace(ref_reduced(ref_get_config("starcoder2-3b")),
                              **kw)
    pcfg = dataclasses.replace(reduced(get_config("starcoder2-3b")), **kw)
    kv = np.random.default_rng(3).standard_normal((2, 5, n_kv, 16)).astype(
        np.float32)
    got = attn.expand_kv(pcfg, _t(kv))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_attn.expand_kv(cfg, kv)))
    assert got.shape == (2, 5, hq, 16)
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.0])
def test_kv_quant_is_bitwise_the_reference(scale):
    """``_kv_quant``/``_kv_dequant`` on the same f32 input: payloads,
    bf16 scale bits and the dequantized bits equal the reference's, eager
    and jitted (16,384 scales, an all-zero row among them)."""
    x = (np.random.default_rng(4).standard_normal((8, 512, 4, 128))
         * scale).astype(np.float32)
    x[0, 0, 0] = 0.0
    pq, ps = tfm._kv_quant(_t(x))
    for f in (ref_tfm._kv_quant, jax.jit(ref_tfm._kv_quant)):
        q, s = f(jnp.asarray(x))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(
            interop.array_from_tensor(ps).view(np.uint16),
            np.asarray(s).view(np.uint16))
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        want = np.asarray(ref_tfm._kv_dequant(q, s, jdt))
        got = interop.array_from_tensor(tfm._kv_dequant(pq, ps, dt))
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_matches_reference(cd, with_state):
    """``rglru_block`` over a sequence, from zero state and from a given
    state (h and the conv tail), and one step (S = 1, decode's shape)."""
    rcfg, cfg = _cfgs("recurrentgemma-9b", cd)
    rp = ref_build(rcfg).init(jax.random.key(5))
    p = interop.params_from_numpy(jax.device_get(rp), cfg, device=CPU)
    p_rg = tfm._unstack(p["stages"][0], 1)[0]["rglru"]
    rp_rg = jax.tree.map(lambda a: a[0], rp["stages"][0])["rglru"]
    rng = np.random.default_rng(6)
    jcd = jnp.dtype(cd)
    for S_ in (24, 1):
        x = _rand(rng, (2, S_, cfg.d_model), cd)
        state = rstate = None
        if with_state:
            h = _rand(rng, (2, cfg.lru_width), scale=0.5)
            conv = _rand(rng, (2, cfg.conv_width - 1, cfg.lru_width))
            rstate = ref_rec.RGLRUState(h=jnp.asarray(h),
                                        conv=jnp.asarray(conv))
            state = rec.RGLRUState(h=_t(h), conv=_t(conv))
        y, st = ref_rec.rglru_block(rcfg, rp_rg, jnp.asarray(x), jcd,
                                    state=rstate)
        with torch.no_grad():
            py, pst = rec.rglru_block(cfg, p_rg, _t(x), getattr(torch, cd),
                                      state=state)
        tol = 1e-5 if cd == "float32" else _tol(cfg)
        assert py.dtype == getattr(torch, cd) and py.shape == y.shape
        assert _max_rel(py, y) <= tol
        assert _max_rel(pst.h, st.h) <= tol
        assert pst.conv.shape == st.conv.shape
        assert _max_rel(pst.conv, st.conv) <= tol


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------

_RIGS: dict = {}


def _rig(name, cd, kv):
    """Both packages' reduced model at (compute dtype, KV dtype), the
    reference's params in both, and the reference's jitted prefill of a
    (2, S) prompt and its teacher-forced decode steps (logits and each
    step's cache), computed once a module."""
    key = (name, cd, kv)
    if key not in _RIGS:
        rcfg, cfg = _cfgs(name, cd, kv)
        rm, m = ref_build(rcfg), build(cfg)
        rp = rm.init(jax.random.key(7))
        p = interop.params_from_numpy(jax.device_get(rp), cfg, device=CPU)
        toks = np.random.default_rng(8).integers(
            0, cfg.vocab_size, (B, S + NEW)).astype(np.int32)
        prefill = jax.jit(rm.prefill, static_argnames=("max_cache_seq",))
        logits, cache = prefill(rp, {"tokens": jnp.asarray(toks[:, :S])},
                                max_cache_seq=S + NEW)
        steps = [jax.device_get((logits, cache))]
        dec = jax.jit(rm.decode_step)
        for i in range(NEW):
            logits, cache = dec(rp, cache, jnp.asarray(toks[:, S + i:S + i + 1]))
            steps.append(jax.device_get((logits, cache)))
        _RIGS[key] = (cfg, m, p, toks, steps)
    return _RIGS[key]


@pytest.mark.parametrize("cd,kv", CASES)
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name, cd, kv):
    """``Model.prefill`` in one wave and in two: the next-token logits and
    the whole cache tree (stacked stage leaves, ring buffers, int8
    payloads and scales, recurrent states, ``pos``, ``slot_pos``)."""
    cfg, m, p, toks, steps = _rig(name, cd, kv)
    truth = _rig(name, "float32", kv)[4]
    for waves in (1, 2):
        mw = build(dataclasses.replace(cfg, prefill_waves=waves))
        with torch.no_grad():
            logits, cache = mw.prefill(p, {"tokens": _t(toks[:, :S])},
                                       max_cache_seq=S + NEW)
        assert logits.shape == (B, 1, cfg.padded_vocab())
        _assert_close(logits, steps[0][0], truth[0][0], cfg, what=waves)
        _assert_cache_close(cache, steps[0][1], truth[0][1], cfg)


@pytest.mark.parametrize("cd,kv", CASES)
@pytest.mark.parametrize("name", ARCHS)
def test_decode_from_reference_cache_matches_reference(name, cd, kv):
    """Four teacher-forced ``decode_step``s from the reference's own prefill
    cache (``interop.cache_from_numpy``): each step's logits and, after
    the last, the whole cache tree."""
    cfg, m, p, toks, steps = _rig(name, cd, kv)
    truth = _rig(name, "float32", kv)[4]
    cache = interop.cache_from_numpy(steps[0][1], cfg, device=CPU)
    f32_tol = 1 / 127 if kv == "int8" else 1e-5
    for i in range(NEW):
        with torch.no_grad():
            logits, cache = m.decode_step(p, cache,
                                          _t(toks[:, S + i:S + i + 1]))
        _assert_close(logits, steps[i + 1][0], truth[i + 1][0], cfg,
                      f32_tol, what=i)
    assert int(cache["pos"]) == S + NEW
    _assert_cache_close(cache, steps[-1][1], truth[-1][1], cfg)


def test_cache_from_numpy_checks_the_tree():
    cfg, m, p, toks, steps = _rig("starcoder2-3b", "float32", "int8")
    tree = jax.device_get(steps[0][1])
    other = _cfgs("starcoder2-3b", "float32", "bfloat16")[1]
    with pytest.raises(ValueError, match="decode cache"):
        interop.cache_from_numpy(tree, other, device=CPU)
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            interop.cache_from_numpy(tree, cfg)


# ---------------------------------------------------------------------------
# The reference's own serving tests (tests/test_models.py), on the port
# ---------------------------------------------------------------------------

def _port_model(name, seed):
    cfg = _cfgs(name)[1]
    m = build(cfg)
    return cfg, m, m.init(torch.Generator().manual_seed(seed), device=CPU)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_matches_full_forward(name):
    cfg, m, params = _port_model(name, 2)
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        logits_p, cache = m.prefill(params, {"tokens": toks[:, :32]},
                                    max_cache_seq=40)
        pos = int(cache["pos"])
        lg, new_cache = m.decode_step(params, cache, toks[:, 32:33])
        logits_f, _ = m.forward(params, toks)
    a, b = lg[:, 0].float().numpy(), logits_f[:, -1].float().numpy()
    err = np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)
    tol = 5e-2 if cfg.attention == "sliding" else 3e-2
    assert err < tol, err
    assert int(new_cache["pos"]) == pos + 1


@pytest.mark.parametrize("name", ARCHS)
def test_multi_step_decode_matches_forward(name):
    """Decode 4 tokens from a prefill; logits at each step must match the
    growing full forward (teacher-forced)."""
    cfg, m, params = _port_model(name, 3)
    toks = torch.randint(0, cfg.vocab_size, (1, 20),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _, cache = m.prefill(params, {"tokens": toks[:, :16]},
                             max_cache_seq=20)
        for i in range(4):
            lg, cache = m.decode_step(params, cache, toks[:, 16 + i:17 + i])
            full, _ = m.forward(params, toks[:, :17 + i])
            a, b = lg[:, 0].float().numpy(), full[:, -1].float().numpy()
            err = np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)
            assert err < 3e-2, (i, err)


_LOSSES: dict = {}


def _ref_loss(name, cd, toks, labs):
    """The reference's jitted loss and gradients at ``cd`` (params from
    ``jax.random.key(9)``, f32 whatever ``cd``), once a module."""
    if (name, cd) not in _LOSSES:
        rcfg = _cfgs(name, cd)[0]
        rm = ref_build(rcfg)
        rp = rm.init(jax.random.key(9))
        loss, grads = jax.jit(jax.value_and_grad(rm.loss))(
            rp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
        _LOSSES[name, cd] = (jax.device_get(rp), float(loss),
                             [np.asarray(g) for g in jax.tree.leaves(grads)])
    return _LOSSES[name, cd]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["starcoder2-3b", "granite-20b",
                                  "recurrentgemma-9b", "chunked-global"])
def test_loss_and_gradients_match_reference_on_the_cpu(name, cd):
    """``loss_fn`` of the attention archs (and the hybrid), with autograd
    through the plain attention and RG-LRU scan on the CPU: the loss, and
    each gradient leaf as a relative Frobenius error.  f32: the loss within
    1e-5, the gradients within 1e-4 (the backward through the softmax
    amplifies the forward's f32 rounding past 1e-5 on reduced
    starcoder2-3b).  bf16: the reference's bf16 accuracy, as in the
    module docstring, in the Frobenius measure."""
    cfg = _cfgs(name, cd)[1]
    m = build(cfg)
    rng = np.random.default_rng(10)
    toks, labs = (rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
                  for _ in range(2))
    rp, loss, grads = _ref_loss(name, cd, toks, labs)
    p = interop.params_from_numpy(rp, cfg, device=CPU)
    leaves, td = tree_flatten(p)
    leaves = [x.detach().requires_grad_() for x in leaves]
    ploss = m.loss(tree_unflatten(td, leaves),
                   {"tokens": _t(toks), "labels": _t(labs)})
    pgrads = [g.detach() for g in torch.autograd.grad(ploss, leaves)]
    assert len(pgrads) == len(grads)
    if cd == "float32":
        assert abs(float(ploss.detach()) / loss - 1.0) <= 1e-5
        errs = [_frob(g, r) for g, r in zip(pgrads, grads)]
        assert max(errs) <= 1e-4, errs
        return
    _, loss32, grads32 = _ref_loss(name, "float32", toks, labs)
    tol = _tol(cfg)
    rel = lambda a, b: abs(a / b - 1.0)
    assert rel(float(ploss.detach()), loss) <= tol or rel(
        float(ploss.detach()), loss32) <= max(tol, 2.0 * rel(loss, loss32))
    for g, r, r32 in zip(pgrads, grads, grads32):
        if _frob(g, r) <= tol:
            continue
        assert _frob(g, r32) <= max(tol, 2.0 * _frob(r, r32))
