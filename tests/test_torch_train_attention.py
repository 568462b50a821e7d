"""Training through attention and the RG-LRU in the port, against the
reference on the CPU (seeded numpy inputs, reduced widths).

* ``kernels/flash_attention.py::FlashAttention`` (the plain forward here,
  the blocked backward on either device) in the model layout, through
  ``models/attention.py::attention``, against ``jax.grad`` of the
  reference's ``attention`` in every mask mode, with Sq != Skv and with
  GQA through ``expand_kv``; the sequence is not a multiple of the
  backward's query block.  f32: the output and each gradient within 1e-5
  of its largest magnitude (max abs); bf16: relative Frobenius 2e-2.
* ``kernels/rglru_scan.py::RGLRUScan``: da, db and dh0 against
  ``jax.grad`` of the reference's stepwise scan, and ``_rglru_core``'s
  gradients against ``jax.grad`` of the reference's (its log-depth
  ``associative_scan``), each within 1e-5 of its largest magnitude.
* ``remat_group = 2`` (two-level remat) against the reference's, and on
  multi-kind super-blocks against the port's ``remat_group = 1``.
* Two AdamW ``make_train_step`` steps of reduced starcoder2-3b and
  recurrentgemma-9b against the reference's jitted steps, f32, from the
  port's init carried into the reference's tree.

The file takes about 45 s alone on one CPU worker.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels import ref as ref_kernels
from repro.models import attention as ref_attn
from repro.models import build as ref_build
from repro.models import recurrent as ref_rec
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_state as ref_init_state

from repro_torch.ckpt.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.models import attention as attn
from repro_torch.models import build
from repro_torch.models import recurrent as rec
from repro_torch.optim import adamw

CPU = "cpu"
F32_TOL, BF16_TOL = 1e-5, 2e-2
#: the backward's query block in the attention tests: 136 rows are 2 blocks
#: and a ragged 8.
ROWS = 64
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x).astype(np.float64)


def _max_rel(a, b) -> float:
    a, b = _f64(a), _f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _frob(a, b) -> float:
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.fixture
def blocks_of_rows(monkeypatch):
    """Make the backward take ``ROWS`` query rows a block at any shape."""
    def rows(BH, Sq, band):
        return min(ROWS, Sq)
    monkeypatch.setattr(fa, "block_rows", rows)


ATTN_CASES = {
    "causal": dict(mode="causal", Sq=136),
    "sliding": dict(mode="sliding", Sq=136, window=37),
    "chunked": dict(mode="chunked", Sq=136, chunk=48),
    "bidir": dict(mode="bidir", Sq=136),
    "bidir-cross": dict(mode="bidir", Sq=72, Skv=136),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_gradients_match_reference(case, dtype,
                                                   blocks_of_rows):
    c = ATTN_CASES[case]
    B, H, Dh = 2, 3, 16
    Sq, Skv = c["Sq"], c.get("Skv", c["Sq"])
    kw = dict(mode=c["mode"], window=c.get("window", 0),
              chunk=c.get("chunk", 0))
    rng = np.random.default_rng(21)
    q, do = (rng.standard_normal((B, Sq, H, Dh)) for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, H, Dh)) for _ in range(2))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def ref_f(q_, k_, v_):
        out = ref_attn.attention(q_, k_, v_, **kw)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do, jnp.float32)
                       .astype(jd).astype(jnp.float32)), out
    (_, r_out), r_grads = jax.jit(jax.value_and_grad(
        ref_f, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x, jnp.float32).astype(jd) for x in (q, k, v)))
    ins = [_t(x, td).requires_grad_() for x in (q, k, v)]
    out = attn.attention(*ins, **kw)
    grads = torch.autograd.grad(out, ins, _t(do, td))
    assert out.dtype == td and all(g.dtype == td for g in grads)
    for got, want in zip((out,) + grads, (r_out,) + r_grads):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            assert _max_rel(got, want) <= F32_TOL
        else:
            assert _frob(got, want) <= BF16_TOL


def test_flash_attention_gradients_through_expand_kv_match_reference(
        blocks_of_rows):
    """GQA: 4 q heads over 2 KV heads (and padded heads), the gradients of
    the un-expanded K and V summed over each group."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config("starcoder2-3b")),
                               n_heads=3, n_kv_heads=2, head_pad_multiple=4)
    cfg = dataclasses.replace(reduced(get_config("starcoder2-3b")),
                              n_heads=3, n_kv_heads=2, head_pad_multiple=4)
    B, S, Dh = 2, 136, 16
    rng = np.random.default_rng(22)
    q, do = (rng.standard_normal((B, S, 4, Dh)) for _ in range(2))
    k, v = (rng.standard_normal((B, S, 2, Dh)) for _ in range(2))

    def ref_f(q_, k_, v_):
        out = ref_attn.attention(q_, ref_attn.expand_kv(rcfg, k_),
                                 ref_attn.expand_kv(rcfg, v_), mode="causal")
        return jnp.sum(out * jnp.asarray(do, jnp.float32))
    want = jax.jit(jax.grad(ref_f, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, jnp.float32) for x in (q, k, v)))
    ins = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attn.attention(ins[0], attn.expand_kv(cfg, ins[1]),
                         attn.expand_kv(cfg, ins[2]), mode="causal")
    got = torch.autograd.grad(out, ins, _t(do))
    for g, w in zip(got, want):
        assert _max_rel(g, w) <= F32_TOL


def test_flash_backward_blocks_hold_no_full_score_matrix():
    """``block_rows`` keeps a block's (BH, rows, keys) tensor within
    ``BWD_BLOCK_ELEMS`` (16 rows at least) and ``key_range`` gives each
    mode's keys: the band for sliding, the chunk for chunked."""
    assert fa.block_rows(96, 4096, 4096) == 64
    assert 96 * fa.block_rows(96, 4096, 4096) * 4096 <= fa.BWD_BLOCK_ELEMS
    assert fa.block_rows(16, 4096, 2048) == 1024
    assert fa.block_rows(10 ** 6, 4096, 4096) == fa.MIN_BLOCK_ROWS
    assert fa.key_range("sliding", 128, 192, 4096, 100, 0) == (29, 192)
    assert fa.key_range("chunked", 130, 192, 4096, 0, 64) == (128, 192)
    assert fa.key_range("causal", 128, 192, 4096, 0, 0) == (0, 192)
    assert fa.key_range("bidir", 0, 64, 1500, 0, 0) == (0, 1500)


def test_rglru_scan_gradients_match_reference_scan():
    B, S, W = 2, 70, 24
    rng = np.random.default_rng(23)
    a = rng.uniform(0.0, 1.0, (B, S, W))
    b, g = (rng.standard_normal((B, S, W)) for _ in range(2))
    h0 = rng.standard_normal((B, W))
    want = jax.grad(lambda *x: jnp.sum(ref_kernels.rglru_ref(*x)
                                       * jnp.asarray(g, jnp.float32)),
                    argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.float32) for x in (a, b, h0)))
    ins = [_t(x).requires_grad_() for x in (a, b, h0)]
    got = torch.autograd.grad(rg.RGLRUScan.apply(*ins), ins, _t(g))
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        assert _max_rel(x, y) <= F32_TOL, name


def test_rglru_core_gradients_match_reference():
    """``_rglru_core`` (gates, then the scan through ``RGLRUScan``) against
    ``jax.grad`` of the reference's: the gates' parameters, xw and h0."""
    spec = rec.rglru_spec(reduced(get_config("recurrentgemma-9b")))
    names = ["gate_a", "gate_a_b", "gate_x", "gate_x_b", "lamb"]
    rng = np.random.default_rng(24)
    p0 = {k: (0.3 * rng.standard_normal(spec[k].shape)).astype(np.float32)
          for k in names}
    W = spec["lamb"].shape[0]
    xw, g = (rng.standard_normal((2, 16, W)) for _ in range(2))
    h0 = rng.standard_normal((2, W))

    def ref_f(p, x, h):
        return jnp.sum(ref_rec._rglru_core(p, x, h)[0]
                       * jnp.asarray(g, jnp.float32))
    rgrads = jax.jit(jax.grad(ref_f, argnums=(0, 1, 2)))(
        {k: jnp.asarray(x) for k, x in p0.items()},
        jnp.asarray(xw, jnp.float32), jnp.asarray(h0, jnp.float32))
    leaves = [_t(p0[k]).requires_grad_() for k in names]
    x, h = _t(xw).requires_grad_(), _t(h0).requires_grad_()
    out = rec._rglru_core(dict(zip(names, leaves)), x, h)[0]
    got = torch.autograd.grad(out, leaves + [x, h], _t(g))
    want = [rgrads[0][k] for k in names] + [rgrads[1], rgrads[2]]
    for name, a, b in zip(names + ["xw", "h0"], got, want):
        assert _max_rel(a, b) <= F32_TOL, name


def _pair(arch: str, **kw):
    """The reference's and the port's reduced config of ``arch``, f32."""
    return [dataclasses.replace(red(get(arch)), compute_dtype="float32",
                                **kw)
            for get, red in ((ref_get_config, ref_reduced),
                             (get_config, reduced))]


def _batch(vocab: int, B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    toks, labs = (rng.integers(0, vocab, (B, S)).astype(np.int32)
                  for _ in range(2))
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)})


def _params(rm, m, seed: int):
    """The port's init from ``seed`` on the host, and the same leaves as the
    reference's tree (both flatten in JAX's order; the reference's own
    init runs eagerly and takes seconds)."""
    params = m.init(torch.Generator().manual_seed(seed), device=CPU)
    td = jax.tree.structure(jax.eval_shape(rm.init, jax.random.key(0)))
    leaves = [jnp.asarray(x.numpy()) for x in tree_leaves(params)]
    return params, jax.tree.unflatten(td, leaves)


def _grads(m, params, batch):
    leaves, td = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss = m.loss(tree_unflatten(td, leaves), batch)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def test_two_level_remat_matches_reference():
    """starcoder2-3b reduced to 2 layers under ``remat="full"`` with
    ``remat_group = 2``: one outer checkpoint over both layers, a
    checkpoint a layer inside.  The loss (1e-5) and every gradient leaf
    (relative Frobenius 1e-4, the f32 gradient tolerance of the serving
    tests) against the reference's jitted two-level remat."""
    rcfg, cfg = _pair("starcoder2-3b", remat="full", remat_group=2)
    rm, m = ref_build(rcfg), build(cfg)
    params, rp = _params(rm, m, 5)
    rb, tb = _batch(cfg.vocab_size, 2, 32, 25)
    rloss, rgrads = jax.jit(jax.value_and_grad(rm.loss))(rp, rb)
    loss, grads = _grads(m, params, tb)
    assert abs(loss / float(rloss) - 1.0) <= 1e-5
    errs = [_frob(g, r) for g, r in zip(grads, jax.tree.leaves(rgrads))]
    assert max(errs) <= 1e-4, errs


def test_two_level_remat_of_multi_kind_super_blocks_equals_one_level():
    """recurrentgemma-9b reduced to 2 super-blocks (rglru, rglru,
    sliding): ``remat_group = 2`` against ``remat_group = 1`` from the same
    params, loss and every gradient leaf within 1e-6 (remat recomputes the
    same values)."""
    cfg = dataclasses.replace(_pair("recurrentgemma-9b", n_layers=6,
                                    remat="full")[1])
    params = build(cfg).init(torch.Generator().manual_seed(7), device=CPU)
    tb = _batch(cfg.vocab_size, 2, 32, 27)[1]
    loss2, grads2 = _grads(build(dataclasses.replace(cfg, remat_group=2)),
                           params, tb)
    loss1, grads1 = _grads(build(cfg), params, tb)
    assert abs(loss2 / loss1 - 1.0) <= 1e-6
    assert max(_frob(a, b) for a, b in zip(grads2, grads1)) <= 1e-6


@pytest.mark.parametrize("arch", ["starcoder2-3b", "recurrentgemma-9b"])
def test_two_adamw_steps_match_reference(arch):
    """Two ``make_train_step`` steps (f32) from the
    same params on one batch against the reference's jitted steps.
    The first step's loss and grad norm within 1e-5, the second's loss
    within 1e-5 and grad norm within 1e-3: AdamW moves an element by
    lr * sign(g) whatever |g|, so elements near g = 0 may take opposite
    first steps in the two packages (2 lr apart), which moves the second
    step's gradients (4e-4 of the norm on starcoder2-3b).  The moments
    carry that into the second update, so each leaf's two-step update
    (new minus initial params), m and v are held in relative Frobenius at
    5e-3 (they read 0.5e-3 to 1.8e-3)."""
    rcfg, cfg = _pair(arch)
    rm, m = ref_build(rcfg), build(cfg)
    p, rp = _params(rm, m, 6)
    p0 = [_f64(x) for x in jax.tree.leaves(rp)]
    rb, tb = _batch(cfg.vocab_size, 2, 32, 26)
    rstep = jax.jit(rm.make_train_step(RefAdamWConfig(**OPT)))
    step = m.make_train_step(adamw.AdamWConfig(**OPT))
    rs = ref_init_state(rp)
    s = adamw.init_state(p, device=CPU)
    for tol in ({"loss": 1e-5, "grad_norm": 1e-5},
                {"loss": 1e-5, "grad_norm": 1e-3}):
        rp, rs, rmet = rstep(rp, rs, rb)
        p, s, met = step(p, s, tb)
        for k, t in tol.items():
            assert abs(float(met[k]) / float(rmet[k]) - 1.0) <= t, k
    assert int(s.step) == int(rs.step) == 2
    for a, b, z in zip(tree_leaves(p), jax.tree.leaves(rp), p0):
        assert _frob(_f64(a) - z, _f64(b) - z) <= 5e-3
    for got, want in ((s.m, rs.m), (s.v, rs.v)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert _frob(a, b) <= 5e-3


def test_adamw_updates_a_large_leaf_in_slices_bitwise(monkeypatch):
    """A leaf larger than ``UPDATE_CHUNK`` is updated slice by slice (the
    memory of recurrentgemma-9b's 4 GB embedding update): the new params
    and moments are bitwise the whole-leaf update's, decayed or not."""
    gen = torch.Generator().manual_seed(8)
    params = {"w": torch.randn((300, 37), generator=gen),
              "n": torch.randn((1001,), generator=gen),
              "s": torch.randn((3, 50, 7), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    cfg = adamw.AdamWConfig()
    state = adamw.apply_updates(cfg, params, grads,
                                adamw.init_state(params, device=CPU))[1]
    whole = adamw.apply_updates(cfg, params, grads, state)
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 256)
    sliced = adamw.apply_updates(cfg, params, grads, state)
    for a, b in zip(tree_leaves((whole[0], whole[1].m, whole[1].v)),
                    tree_leaves((sliced[0], sliced[1].m, sliced[1].v))):
        assert torch.equal(a, b)
