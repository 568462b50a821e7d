"""xLSTM trains in the port: reduced xLSTM (the reference's ``reduced``,
S = 64, so 4 chunks of 16) against the reference, from the reference's
parameters carried across by ``interop.params_from_numpy``.

Tolerances: bf16 compute at the reference's bf16 tolerance, 3e-2 (the
logits and the new parameters as max |a - b| / max |b|, the reference's
measure; each gradient leaf as a relative Frobenius error, since XLA and
PyTorch round bf16 at other points); f32 compute at 1e-5 relative, the
algorithm itself.  ``MLSTMScan``'s gradient is held against autograd
through the ``_mlstm_chunk`` scan at 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import build as ref_build
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_state as ref_init_state

from repro_torch import interop
from repro_torch.ckpt.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import mlstm_scan as ml
from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.models import recurrent as rec
from repro_torch.optim import adamw

CPU = "cpu"
B, S = 2, 64
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
TOL = {"bfloat16": 3e-2, "float32": 1e-5}


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _frob(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _batch_np(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    labs = rng.integers(0, 512, (B, S)).astype(np.int32)
    return toks, labs


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def rig(request):
    """Both packages' reduced xLSTM at one compute dtype, the reference's
    params in both, and the reference's forward, gradients and one jitted
    train step on one batch."""
    cd = request.param
    rcfg = dataclasses.replace(ref_reduced(ref_get_config("xlstm-125m")),
                               compute_dtype=cd)
    cfg = dataclasses.replace(reduced(get_config("xlstm-125m")),
                              compute_dtype=cd)
    rm, m = ref_build(rcfg), build(cfg)
    rp = rm.init(jax.random.key(3))
    params = interop.params_from_numpy(jax.device_get(rp), cfg, device=CPU)
    toks, labs = _batch_np()
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    logits = jax.jit(rm.forward)(rp, rb["tokens"])[0]
    loss, grads = jax.jit(jax.value_and_grad(rm.loss))(rp, rb)
    step = jax.jit(rm.make_train_step(RefAdamWConfig(**OPT)))
    new_p, new_s, metrics = step(rp, ref_init_state(rp), rb)
    ref = {"logits": np.asarray(logits, np.float32), "loss": float(loss),
           "grads": [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)],
           "new_params": [np.asarray(x, np.float32)
                          for x in jax.tree.leaves(new_p)],
           "new_m": [np.asarray(x) for x in jax.tree.leaves(new_s.m)],
           "new_v": [np.asarray(x) for x in jax.tree.leaves(new_s.v)],
           "metrics": {k: float(v) for k, v in metrics.items()}}
    return cd, cfg, m, params, tb, ref


def _value_and_grad(m, params, batch):
    leaves, td = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss = m.loss(tree_unflatten(td, leaves), batch)
    return loss, torch.autograd.grad(loss, leaves)


def test_logits_match_reference(rig):
    cd, cfg, m, params, tb, ref = rig
    logits, cache = m.forward(params, tb["tokens"])
    assert cache is None
    assert logits.shape == (B, S, cfg.padded_vocab())
    assert logits.dtype == getattr(torch, cd)
    assert _max_rel(_np(logits), ref["logits"]) <= TOL[cd]


def test_loss_and_every_gradient_leaf_match_reference(rig):
    cd, cfg, m, params, tb, ref = rig
    loss, grads = _value_and_grad(m, params, tb)
    assert abs(float(loss.detach()) / ref["loss"] - 1.0) <= TOL[cd]
    assert len(grads) == len(ref["grads"]) == 22
    errs = [_frob(_np(g), r) for g, r in zip(grads, ref["grads"])]
    assert max(errs) <= TOL[cd], errs


def test_one_adamw_train_step_matches_reference(rig):
    """One ``make_train_step`` step.  The metrics and the moments (m is
    (1 - b1) g, v (1 - b2) g^2) are held directly.  AdamW's first update
    is lr * g / (|g| + eps) (plus the decay), lr * sign(g) away from g = 0
    and a jump of 2 lr where g changes sign, so no tolerance on g carries
    over to the parameters near g = 0.  The new parameters are held where
    both packages' m have one sign and |m| > 1e-6 (so |g| > 1e3 eps and
    the update is within 1e-3 lr of lr * sign(g)); every other element
    may differ by at most 2 lr, and signs differ at under 1% of a leaf's
    elements with |m| > 1e-6."""
    cd, cfg, m, params, tb, ref = rig
    step = m.make_train_step(adamw.AdamWConfig(**OPT))
    opt = adamw.init_state(params, device=CPU)
    new_p, new_s, metrics = step(params, opt, tb)
    tol = TOL[cd]
    assert int(new_s.step) == 1
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(metrics[k]) / ref["metrics"][k] - 1.0) <= tol, k
    # m is (1 - b1) g; v is (1 - b2) g^2, twice g's relative error
    for got, want, t in ((new_s.m, ref["new_m"], tol),
                         (new_s.v, ref["new_v"], 2 * tol)):
        errs = [_frob(_np(a), b) for a, b in zip(tree_leaves(got), want)]
        assert max(errs) <= t, errs
    lr = OPT["lr"]
    for a, b, ma, mb in zip(tree_leaves(new_p), ref["new_params"],
                            tree_leaves(new_s.m), ref["new_m"]):
        a, ma = _np(a), _np(ma)
        big = (np.abs(ma) > 1e-6) & (np.abs(mb) > 1e-6)
        firm = big & (np.sign(ma) == np.sign(mb))
        assert firm.sum() >= 0.99 * big.sum()
        assert _max_rel(a[firm], b[firm]) <= tol
        assert np.abs(a - b).max() <= 2 * lr * (1 + 1e-3)


def test_microbatches_two_equal_one():
    cfg = dataclasses.replace(reduced(get_config("xlstm-125m")),
                              compute_dtype="float32")
    m = build(cfg)
    params = m.init(torch.Generator().manual_seed(5), device=CPU)
    toks, labs = _batch_np(1)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)}
    outs = []
    for k in (1, 2):
        step = m.make_train_step(adamw.AdamWConfig(**OPT), microbatches=k)
        outs.append(step(params, adamw.init_state(params, device=CPU),
                         batch))
    (p1, s1, m1), (p2, s2, m2) = outs
    assert abs(float(m2["loss"]) / float(m1["loss"]) - 1.0) <= 1e-6
    assert abs(float(m2["grad_norm"]) / float(m1["grad_norm"]) - 1.0) \
        <= 1e-5
    errs = [_frob(_np(a), _np(b)) for a, b in zip(tree_leaves(s2.m),
                                                  tree_leaves(s1.m))]
    assert max(errs) <= 1e-5, errs


def test_microbatch_accumulation_in_bfloat16_runs():
    cfg = reduced(get_config("xlstm-125m"))
    m = build(cfg)
    params = m.init(torch.Generator().manual_seed(6), device=CPU)
    toks, labs = _batch_np(2)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)}
    step = m.make_train_step(adamw.AdamWConfig(**OPT), microbatches=2,
                             accum_dtype="bfloat16")
    _, _, metrics = step(params, adamw.init_state(params, device=CPU), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))


def test_three_step_overfit_loss_falls():
    """The reference's overfit check (``tests/test_models.py``): three
    steps on one batch, every loss finite and the last below the first."""
    cfg = reduced(get_config("xlstm-125m"))
    m = build(cfg)
    params = m.init(torch.Generator().manual_seed(7), device=CPU)
    toks, labs = _batch_np(3)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)}
    step = m.make_train_step(adamw.AdamWConfig(**OPT))
    opt = adamw.init_state(params, device=CPU)
    losses = []
    for _ in range(3):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert np.isfinite(float(metrics["grad_norm"]))


@pytest.mark.parametrize("S_, L", [(64, 16), (48, 48), (96, 32)])
def test_mlstm_scan_backward_matches_autograd_through_the_chunk_scan(S_, L):
    """``MLSTMScan`` (the forward's saved starting states, then a reverse
    loop of vector-Jacobian products of ``_mlstm_chunk``) against autograd
    through the chunk scan from zero state, every input at 1e-6."""
    rng = np.random.default_rng(S_ + L)
    Bq, H, Dh = 2, 3, 32
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32))
    q, k, v = (f(Bq, H, S_, Dh, scale=0.3) for _ in range(3))
    li = f(Bq, H, S_)
    lf = torch.nn.functional.logsigmoid(f(Bq, H, S_) + 2.0)
    dh = f(Bq, H, S_, Dh)
    ins = [x.requires_grad_() for x in (q, k, v, li, lf)]
    calls = ml.mlstm_scan_plain.calls
    h, last = ops.mlstm_scan_trainable(*ins, chunk=L)
    assert ml.mlstm_scan_plain.calls == calls + 1
    got = torch.autograd.grad(h, ins, dh)
    zero = rec.MLSTMState(torch.zeros(Bq, H, Dh, Dh), torch.zeros(Bq, H, Dh),
                          torch.zeros(Bq, H))
    h_ref, st_ref = rec._mlstm_chunks(*ins, zero, L)
    want = torch.autograd.grad(h_ref, ins, dh)
    assert _frob(_np(h), _np(h_ref)) <= 1e-6
    for g, w in zip(got, want):
        assert _frob(_np(g), _np(w)) <= 1e-6
    # the last chunk's starting state carries no gradient; one chunk from
    # it gives the scan's final state
    assert not any(x.requires_grad for x in last)
    sl = slice(S_ - L, S_)
    _, fin = rec._mlstm_chunk(*(x[:, :, sl] for x in ins), last)
    for a, b in zip(fin, st_ref):
        assert _frob(_np(a), _np(b)) <= 1e-6


def test_mlstm_block_final_state_matches_the_chunk_scan():
    """From zero state, the block's final state (one chunk from the saved
    starting state) equals the chunk scan's; from a given state the block
    scans ``_mlstm_chunk``, and two halves chained equal the whole."""
    cfg = dataclasses.replace(reduced(get_config("xlstm-125m")),
                              compute_dtype="float32")
    m = build(cfg)
    params = m.init(torch.Generator().manual_seed(8), device=CPU)
    p = {k: v[0] for k, v in params["stages"][0]["mlstm"].items()}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    y, st = rec.mlstm_block(cfg, p, x, torch.float32)
    zero = rec.mlstm_zero_state(cfg, B)
    y2, st2 = rec.mlstm_block(cfg, p, x, torch.float32, state=zero)
    assert _frob(_np(y), _np(y2)) <= 1e-6
    for a, b in zip(st, st2):
        assert _frob(_np(a), _np(b)) <= 1e-6
    ya, sa = rec.mlstm_block(cfg, p, x[:, :32], torch.float32, state=zero)
    yb, sb = rec.mlstm_block(cfg, p, x[:, 32:], torch.float32, state=sa)
    assert _frob(_np(torch.cat([ya, yb], 1)), _np(y)) <= 1e-6
    for a, b in zip(sb, st):
        assert _frob(_np(a), _np(b)) <= 1e-6


@pytest.mark.parametrize("arch", ["dbrx-132b", "whisper-tiny",
                                  "internvl2-1b"])
def test_unported_kinds_raise(arch):
    """The kinds that raised before the port's MoE and encoder-decoder
    slice (the MoE layer, the encoder-decoder, the prefix input) now run:
    the forward's logits in f32 from the reference's params, within 1e-5
    (relative Frobenius) of the reference's."""
    rcfg, cfg = (dataclasses.replace(red(get(arch)), compute_dtype="float32")
                 for get, red in ((ref_get_config, ref_reduced),
                                  (get_config, reduced)))
    rp = ref_build(rcfg).init(jax.random.key(0))
    p = interop.params_from_numpy(jax.device_get(rp), cfg, device=CPU)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    kw = {}
    if cfg.n_prefix_tokens:
        kw["prefix"] = 0.02 * rng.standard_normal(
            (1, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        kw["frames"] = 0.02 * rng.standard_normal(
            (1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want, _ = ref_build(rcfg).forward(rp, jnp.asarray(toks), **{
        k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got, _ = build(cfg).forward(p, torch.as_tensor(toks), **{
            k: torch.as_tensor(v) for k, v in kw.items()})
    assert got.shape == want.shape
    assert _frob(_np(got), np.asarray(want)) <= 1e-5


def test_chip_smoke_train_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_train`` end to end on the CPU at the reduced
    size (``remat="full"``): its gates hold and, with no card, no kernel
    launches."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke
    from repro_torch.benchmarks import _util
    monkeypatch.setattr(_util, "RESULTS", tmp_path)
    monkeypatch.setitem(chip_smoke.TRAIN, "cpu_S", 64)
    cfg = dataclasses.replace(reduced(get_config("xlstm-125m")),
                              remat="full")
    rep = chip_smoke.phase_train(torch.device(CPU), "cpu", cfg=cfg, B=2,
                                 S=64, S_loss=128)
    assert rep["launches"]["mlstm_scan"] == 0
    assert rep["launches"]["plain"] == 2 * 3      # forward + recompute
    assert rep["losses"][-1] < rep["losses"][0]
    assert rep["compress"]["bitwise_leaves"] == rep["compress"]["leaves"]
    assert max(rep["kernel_checks"]["bwd_frob"].values()) <= 1e-6
