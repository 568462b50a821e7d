"""Sharded execution of the port's train step and decode on eight ranks,
against the single-device runs (the counterpart of the reference's
``tests/test_sharded_execution.py``).

One module fixture starts eight processes of a ``gloo`` group (they meet
on a ``FileStore`` under a temporary directory, so no port is taken) and
runs every case in that one spawn.  Their mesh is
``make_test_mesh(8, device="cpu")``: data 2 x model 4.  The archs are the
reference test's, reduced starcoder2-3b, dbrx-132b and recurrentgemma-9b
with ``head_pad_multiple=4``, and reduced xlstm-125m (d 64, 4 heads, mLSTM
chunk 16); AdamW (lr 1e-3, warm-up 1), microbatches 2, a batch of 8 x 64
drawn from a numpy seed; the parameters are the reference's ``init``
carried over by ``interop.params_from_numpy``, placed on the mesh by
``sharding.place_tree``, and the batch is placed along its ``batch`` axis.

* (a) the mesh is (2, 4) on eight ranks;
* (b) bf16 compute: the sharded step against the port's single-device
  step (loss rel 2e-2, every parameter leaf max-abs < 5e-2, the
  reference test's bounds) and against the reference's jitted
  single-device step from the same numpy parameters (the loss and the
  first leaf);
* (c) f32 compute, the train step with microbatches 2 on both sides (each
  microbatch the reference's global rows, on the mesh laid out over
  ``data`` again): the loss and the gradient norm within 1e-6 (relative)
  and every accumulated gradient leaf AdamW is handed within 1e-5
  (relative Frobenius) of the single-device port's, also for dbrx on the
  capacity path, for reduced llama4 (one super-block of 4 layers: chunked
  and global attention, the top-1 router, on the dense and the capacity
  path), for reduced whisper-tiny (its encoder and cross attention on a
  batch of seeded frames) and for a batch with one masked label
  (microbatches of 255 and 256 labels); a top-1 router's gradient, zero
  in exact arithmetic, is rounding noise on both sides and must lie under
  ``ZERO_GRAD_SHARE`` of the largest leaf's norm.  These bounds are near the f32 noise of these
  random models: at the reference's init, attention is near one-hot, and
  one ulp of the embedding table moves some gradient leaf by more than
  1e-5 on one device.  The q and k projections of attention are
  therefore scaled by ``QK_SCALE`` for this case (the same ulp then moves
  every leaf by under a third of the bound; a test holds both); a wrong
  reduction moves a leaf by O(1) at either scale;
* (d) every parameter and AdamW leaf after the step has the placements
  ``shardings_tree`` and the state spec give, the gradients their
  parameters' and the loss is replicated;
* (e) the flash, RG-LRU and mLSTM wrappers ran on local shards (batch /
  2, heads / 4, LRU width / 4), and a sequence split raises;
* (f) decode: starcoder2-3b and recurrentgemma-9b prefill 64 tokens, then
  take 8 decode steps through their 32-slot window ring, the KV cache
  split over ``model`` along its slots (8 a rank; the decode kernel runs
  on each rank's slots, and the pieces merge by their log-sum-exps), q and
  k scaled by ``QK_SCALE``: f32 logits within 1e-5 of each step's largest
  |logit| and the written slots and states within 1e-6, bf16 next-token
  losses within 2e-2, and every cache leaf keeps ``cache_spec``'s
  placements;
* AdamW alone on placed params: a factored second moment against the
  plain update (1e-6), the global norm (1e-6 relative), and the update
  sliced by ``UPDATE_CHUNK`` on each shard bitwise the whole-leaf one;
* the dry run's reduced train cell (starcoder2-3b at its production
  numerics, reduced width): each rank runs it for real from a seed under
  the dry run's ``LiveBytes``; its local argument bytes equal the meta
  trace's ``argument_bytes`` and its peak lies within
  ``DRYRUN_PEAK_BAND`` of the trace's ``peak_bytes_est``;
* a mesh dim of size 1 takes ``Replicate()`` (no group needed).

The rank processes import neither ``jax`` nor ``repro``; the reference
runs in the test process.  The file takes about 100 s alone on eight CPU
cores.
"""
import dataclasses
import logging
import traceback

import numpy as np
import pytest
import torch

ARCHS = ("starcoder2-3b", "dbrx-132b", "recurrentgemma-9b", "xlstm-125m")
#: archs run only as f32 gradient cases: llama4 (one super-block of 4
#: layers: chunked and global attention, the top-1 router) and whisper-tiny
#: (its encoder, cross attention).
F32_ONLY = ("llama4-scout-17b-a16e", "whisper-tiny")
#: the f32 gradient cases: each arch, dbrx through the capacity path (the
#: top-k scatter-add) and llama4 through it too (the top-1 combine).
F32_CASES = {arch: {} for arch in ARCHS + F32_ONLY}
F32_CASES["llama4-scout-17b-a16e"] = {"n_layers": 4}
F32_CASES["dbrx-132b capacity"] = {"moe_impl": "capacity"}
F32_CASES["llama4-scout-17b-a16e capacity"] = {"n_layers": 4,
                                               "moe_impl": "capacity"}
WORLD = 8
B, S, MICRO = 8, 64, 2
OPT = dict(lr=1e-3, warmup_steps=1)
LOSS_RTOL, LEAF_ATOL = 2e-2, 5e-2
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-6, 1e-5
#: a top-1 router's gradient is zero in exact arithmetic (the one weight a
#: token keeps is renormalised to v / v = 1), rounding noise (~1e-10)
#: beside leaves of ~1e-2 on both sides: its norm must lie under this
#: share of the largest leaf's, where no relative error is defined.
ZERO_GRAD_SHARE = 1e-7
QK_SCALE = 0.25
#: the decode cases: a prompt of ``PROMPT`` tokens prefilled, then
#: ``NEW_TOKENS`` decode steps through the 32-slot window ring (8 slots a
#: rank on ``model``), so the ring wraps.
DECODE_ARCHS = ("starcoder2-3b", "recurrentgemma-9b")
DECODE_CASES = [(arch, cd) for arch in DECODE_ARCHS
                for cd in ("float32", "bfloat16")]
PROMPT, NEW_TOKENS = 64, 8
#: f32 logits within ``DECODE_F32_TOL`` of the step's largest |logit|, the
#: slots and states a step writes within ``CACHE_TOL`` (relative
#: Frobenius); bf16 logits within the reference test's 2e-2 of it.
DECODE_F32_TOL, CACHE_TOL, DECODE_BF16_TOL = 1e-5, 1e-6, 2e-2
#: the fixture's limit on the ranks' run, in seconds.
SPAWN_TIMEOUT = 900
#: the band of a rank's peak, running the dry run's reduced cell for real,
#: over the cell's meta trace's ``peak_bytes_est`` (``chip_smoke.py``'s
#: ``TOOL_PEAK_BAND``).
DRYRUN_PEAK_BAND = (0.8, 1.25)


def _dryrun_cfg(shape):
    """The dry run's reduced cell: starcoder2-3b at its production
    numerics (``dryrun.cell_config``: bf16 parameters, remat) at the
    reduced width, heads padded to 4."""
    from repro_torch.configs import reduced
    from repro_torch.launch import dryrun
    prod = dryrun.cell_config("starcoder2-3b", shape)
    return dataclasses.replace(reduced(prod), name=prod.name,
                               head_pad_multiple=4, remat=prod.remat)


def _arch(case: str) -> str:
    return case.split()[0]


def _cfg(case: str, compute_dtype: str, ref: bool = False):
    """The reduced config of ``case`` with the reference test's settings
    (the reference's own config when ``ref``)."""
    if ref:
        from repro.configs import get_config, reduced
    else:
        from repro_torch.configs import get_config, reduced
    extra = dict(F32_CASES.get(case, {}))
    n_layers = extra.pop("n_layers", 2)
    return dataclasses.replace(reduced(get_config(_arch(case)),
                                       n_layers=n_layers),
                               head_pad_multiple=4,
                               compute_dtype=compute_dtype, **extra)


def _zero_grad_leaves(case: str) -> set:
    """Indices of the gradient leaves that are zero in exact arithmetic:
    a top-1 router's."""
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.models import build
    cfg = _cfg(case, "float32")
    if cfg.top_k != 1:
        return set()

    def mark(node, key=None):
        if isinstance(node, dict):
            return {k: mark(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(mark(v) for v in node)
        return key == "router"
    flags = tree_leaves(mark(build(cfg).param_spec()))
    return {i for i, f in enumerate(flags) if f}


def _scale_qk(tree, f: float):
    """A copy of a numpy parameter tree with every attention layer's q and
    k projections scaled by ``f`` (cross attention's and an encoder's
    too)."""
    def layer(p):
        p = dict(p)
        for name in ("attn", "xattn"):
            if name in p:
                p[name] = dict(p[name], wq=p[name]["wq"] * np.float32(f),
                               wk=p[name]["wk"] * np.float32(f))
        return p
    out = dict(tree)
    for key in ("stages", "tail"):
        out[key] = tuple(layer(p) for p in tree[key])
    if "encoder" in tree:
        out["encoder"] = dict(tree["encoder"],
                              stage=layer(tree["encoder"]["stage"]))
    return out


def _batch(arch: str) -> dict:
    """Tokens and labels drawn from the arch's seed, and an encoder's
    frames after them."""
    rng = np.random.default_rng((ARCHS + F32_ONLY).index(arch) + 1)
    out = {k: rng.integers(0, 512, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    cfg = _cfg(arch, "float32")
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _tokens(arch: str) -> np.ndarray:
    """A decode case's prompt and the tokens fed to its decode steps."""
    rng = np.random.default_rng(100 + ARCHS.index(arch))
    return rng.integers(0, 512, (B, PROMPT + NEW_TOKENS)).astype(np.int32)


# ---------------------------------------------------------------------------
# The ranks (no jax here)
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().numpy()


def _record_local_shapes() -> dict:
    """Wrap the flash, RG-LRU and decode kernel wrappers and the mLSTM's
    plain version (the functions the autograd Functions and
    ``ops.decode_attention`` call on the CPU) to record the shapes they are
    called on: the first argument's, the cache's for decode."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import rglru_scan as rg
    seen = {"flash_attention": [], "rglru_scan": [], "decode_attention": [],
            "mlstm_scan_plain": []}

    def wrap(mod, name, arg=0):
        inner = getattr(mod, name)

        def rec(*args, **kw):
            seen[name].append(tuple(args[arg].shape))
            return inner(*args, **kw)
        rec.__dict__.update(inner.__dict__)     # its counters
        setattr(mod, name, rec)
    wrap(fa, "flash_attention")
    wrap(rg, "rglru_scan")
    wrap(da, "decode_attention", 1)
    wrap(ml, "mlstm_scan_plain")
    return seen


def _mismatches(tree, spec_tree, mesh) -> list:
    """Leaves of ``tree`` whose placements differ from those their specs
    resolve to on ``mesh``."""
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.models import shardings_tree
    want = tree_leaves(shardings_tree(spec_tree, mesh))
    got = tree_leaves(tree)
    if len(want) != len(got):
        return [f"{len(got)} leaves against {len(want)} specs"]
    return [f"leaf {i}: {tuple(x.placements)} != {tuple(w.placements)}"
            for i, (x, w) in enumerate(zip(got, want))
            if tuple(x.placements) != tuple(w.placements)]


def _placed_batch(batch: dict, mesh):
    from repro_torch.models.spec import ParamSpec
    from repro_torch.parallel import sharding as shd
    spec = {k: ParamSpec(v.shape, ("batch", None, "act_embed"), "float32")
            if k == "frames" else ParamSpec((B, S), ("batch", "seq"), "int32")
            for k, v in batch.items()}
    return shd.place_tree({k: torch.from_numpy(v) for k, v in batch.items()},
                          spec, mesh)


def _sharded_step(arch: str, np_params, mesh) -> dict:
    """One bf16 train step on the mesh: the loss, the new parameters
    (whole), and the placements against the specs."""
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    cfg = _cfg(arch, "bfloat16")
    model = build(cfg)
    ocfg = adamw.AdamWConfig(**OPT)
    pspec = model.param_spec()
    params = shd.place_tree(params_from_numpy(np_params, cfg, device="cpu"),
                            pspec, mesh)
    opt = adamw.init_state(params, ocfg)
    step = model.make_train_step(ocfg, microbatches=MICRO)
    new_p, new_o, met = step(params, opt, _placed_batch(_batch(arch), mesh))
    return {"loss": float(met["loss"]),
            "loss_replicated": all(p.is_replicate()
                                   for p in met["loss"].placements),
            "leaves": [_np(x) for x in tree_leaves(new_p)],
            "param_mismatches": _mismatches(new_p, pspec, mesh),
            "opt_mismatches": _mismatches(new_o, adamw.state_spec(pspec,
                                                                  ocfg),
                                          mesh),
            "opt_before_mismatches": _mismatches(
                opt, adamw.state_spec(pspec, ocfg), mesh)}


def _f32_step(case: str, np_params, mesh=None, move_first: bool = False,
              qk_scale: float = QK_SCALE, mask_one: bool = False) -> dict:
    """The f32 train step with ``MICRO`` microbatches (q and k scaled by
    ``qk_scale``), on ``mesh`` when given: its loss and gradient norm, and
    the accumulated gradients it hands AdamW (recorded there), as numpy
    with whether each kept its parameter's placements.  ``move_first``
    moves the first leaf (the embedding table) up by one ulp; ``mask_one``
    masks the first label, so that the microbatches hold 255 and 256
    labels."""
    from repro_torch.ckpt.tree import tree_flatten, tree_leaves, \
        tree_unflatten
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    cfg = _cfg(case, "float32")
    model = build(cfg)
    params = params_from_numpy(_scale_qk(np_params, qk_scale), cfg,
                               device="cpu")
    if move_first:
        leaves, td = tree_flatten(params)
        leaves[0] = torch.nextafter(leaves[0],
                                    torch.full_like(leaves[0], np.inf))
        params = tree_unflatten(td, leaves)
    nb = _batch(_arch(case))
    if mask_one:
        nb["labels"][0, 0] = -1
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    if mesh is not None:
        params = shd.place_tree(params, model.param_spec(), mesh)
        batch = _placed_batch(nb, mesh)
    ocfg = adamw.AdamWConfig(**OPT)
    seen, inner = [], adamw.apply_updates

    def record(opt_cfg, ps, grads, state):
        seen.append(tree_leaves(grads))
        return inner(opt_cfg, ps, grads, state)
    adamw.apply_updates = record
    try:
        _, _, met = model.make_train_step(ocfg, microbatches=MICRO)(
            params, adamw.init_state(params, ocfg, device="cpu"), batch)
    finally:
        adamw.apply_updates = inner
    (grads,) = seen
    return {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "grads": [_np(g) for g in grads],
            "grad_mismatches": [
                i for i, (g, p) in enumerate(zip(grads, tree_leaves(params)))
                if mesh is not None
                and tuple(g.placements) != tuple(p.placements)]}


def _adamw_on_shards(np_params, mesh) -> dict:
    """AdamW alone on starcoder2-3b's placed f32 params and seeded
    gradients: a factored second moment (its row and col means over split
    dims) against the same update on plain tensors, and the update sliced
    by ``UPDATE_CHUNK`` on each shard against the whole-leaf one."""
    from repro_torch.ckpt.tree import tree_flatten, tree_leaves, \
        tree_unflatten
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    cfg = _cfg("starcoder2-3b", "float32")
    pspec = build(cfg).param_spec()
    plain = params_from_numpy(np_params, cfg, device="cpu")
    leaves, td = tree_flatten(plain)
    gen = torch.Generator().manual_seed(5)
    grads = tree_unflatten(td, [torch.randn(x.shape, generator=gen)
                                for x in leaves])
    params = shd.place_tree(plain, pspec, mesh)
    sgrads = shd.place_tree(grads, pspec, mesh)
    ocfg = adamw.AdamWConfig(factored_second_moment=True, **OPT)
    want = adamw.apply_updates(ocfg, plain, grads,
                               adamw.init_state(plain, ocfg, device="cpu"))
    state = adamw.init_state(params, ocfg)
    got = adamw.apply_updates(ocfg, params, sgrads, state)
    pairs = list(zip(tree_leaves((got[0], got[1].m, got[1].v)),
                     tree_leaves((want[0], want[1].m, want[1].v))))
    out = {"factored_max_abs": max(float(np.abs(_np(a) - _np(b)).max())
                                   for a, b in pairs),
           "factored_leaves": len(pairs),
           "grad_norm": [float(got[2]["grad_norm"]),
                         float(want[2]["grad_norm"])],
           "factored_mismatches": _mismatches(
               got[1], adamw.state_spec(pspec, ocfg), mesh)}
    ocfg = adamw.AdamWConfig(**OPT)
    state = adamw.init_state(params, ocfg)
    whole = adamw.apply_updates(ocfg, params, sgrads, state)
    chunk, adamw.UPDATE_CHUNK = adamw.UPDATE_CHUNK, 1000
    try:
        sliced = adamw.apply_updates(ocfg, params, sgrads, state)
    finally:
        adamw.UPDATE_CHUNK = chunk
    out["sliced_leaves"] = sum(shd.local(x).numel() > 1000
                               for x in tree_leaves(params))
    out["sliced_bitwise"] = all(
        torch.equal(shd.local(a), shd.local(b)) for a, b in zip(
            tree_leaves((whole[0], whole[1].m, whole[1].v)),
            tree_leaves((sliced[0], sliced[1].m, sliced[1].v))))
    return out


def _split_sequence_raises(mesh) -> str:
    """Flash on a q split along its sequence: the error's text, or ''."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    q = distribute_tensor(torch.zeros((2, 8, 4, 16)), mesh,
                          [Shard(1), Replicate()])
    try:
        ops.flash_attention(q, q, q)
    except ValueError as e:
        return str(e)
    return ""


def _written(cache, pos: int) -> list:
    """What decode wrote at position ``pos``: each K/V leaf's slot
    ``pos % Sc`` (and int8 scales') and every recurrent state leaf, as
    numpy copies (later steps write the same tensors in place)."""
    from repro_torch.ckpt.tree import tree_leaves
    out = []
    for lead, entries in ((1, cache["layers"]["stages"]),
                          (0, cache["layers"]["tail"])):
        for e in entries:
            if isinstance(e, dict):
                for key in sorted(e):
                    if key in ("k", "v", "k_scale", "v_scale"):
                        x = _np(e[key])
                        out.append(x.take(pos % x.shape[lead + 1],
                                          axis=lead + 1))
            else:
                out += [_np(x).copy() for x in tree_leaves(e)]
    return out


def _decode_run(arch: str, compute_dtype: str, np_params,
                mesh=None) -> dict:
    """Prefill ``PROMPT`` tokens, then ``NEW_TOKENS`` decode steps fed the
    case's tokens, on ``mesh`` when given (parameters, prompt and tokens
    placed by their specs); f32 with q and k scaled by ``QK_SCALE``.  Each
    step's logits and what it wrote (:func:`_written`), and on the mesh
    the cache leaves whose placements left ``cache_spec``'s."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build
    from repro_torch.models.spec import ParamSpec
    from repro_torch.parallel import sharding as shd
    cfg = _cfg(arch, compute_dtype)
    model = build(cfg)
    np_params = _scale_qk(np_params, QK_SCALE)
    params = params_from_numpy(np_params, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(arch))
    prompt = {"tokens": toks[:, :PROMPT]}
    place = lambda t: t
    if mesh is not None:
        params = shd.place_tree(params, model.param_spec(), mesh)
        prompt = shd.place_tree(prompt, {"tokens": ParamSpec(
            (B, PROMPT), ("batch", "seq"), "int32")}, mesh)
        place = lambda t: shd.place_tree(
            t, ParamSpec((B, 1), ("batch", None), "int32"), mesh)
    spec = model.cache_spec(B, PROMPT + NEW_TOKENS)["layers"]
    out = {"logits": [], "written": [], "mismatches": []}
    with torch.no_grad():
        logits, cache = model.prefill(params, prompt,
                                      max_cache_seq=PROMPT + NEW_TOKENS)
        for pos in range(PROMPT, PROMPT + NEW_TOKENS):
            if mesh is not None:
                out["mismatches"] += _mismatches(cache["layers"], spec, mesh)
            out["logits"].append(_np(logits))
            logits, cache = model.decode_step(params, cache,
                                              place(toks[:, pos:pos + 1]))
            out["written"].append(_written(cache, pos))
        out["logits"].append(_np(logits))
        if mesh is not None:
            out["mismatches"] += _mismatches(cache["layers"], spec, mesh)
    return out


def _dryrun_cell(mesh) -> dict:
    """The dry run's reduced cell (``DRYRUN_CELL``) on the mesh: its meta
    trace's record, then the same step on real CPU tensors (parameters
    from a seed, placed on the mesh) under the dry run's ``LiveBytes``:
    the local argument bytes and the peak of the run."""
    import time
    from torch.utils._pytree import tree_flatten as pt_flatten
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import batch_spec, build
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    t0 = time.perf_counter()
    shape = ShapeConfig("train_small", "train", S, B)
    cfg = _dryrun_cfg(shape)
    rec = dryrun.cell_record(cfg.name, cfg, shape, mesh)
    model = build(cfg)
    gen = torch.Generator().manual_seed(0)
    params = shd.place_tree(model.init(gen, device="cpu"),
                            model.param_spec(), mesh)
    opt = adamw.init_state(params, dryrun.opt_config(cfg))
    batch = shd.place_tree(
        {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                          dtype=torch.int32) for k in ("tokens", "labels")},
        batch_spec(cfg, shape), mesh)
    args = (params, opt, batch)
    step = dryrun.train_step(cfg, dryrun.microbatches(cfg, shape, mesh))
    mem = dryrun.LiveBytes(exclude=pt_flatten(args)[0])
    with shd.use_mesh(mesh), mem:
        out = step(*args)
    local = sum(shd.local(x).numel() * shd.local(x).element_size()
                for x in pt_flatten(args)[0])
    del out
    return {"record_memory": rec["memory"], "local_argument_bytes": local,
            "peak": local + mem.peak, "seconds": time.perf_counter() - t0}


def _rank_main(rank: int, store_path: str, inbox, queue) -> None:
    try:
        out = _rank_run(rank, store_path, inbox)
        if rank == 0:
            queue.put(out)
    except BaseException:
        # the test process reads this and stops the ranks still waiting
        queue.put({"error": f"rank {rank}: {traceback.format_exc()}"})
        raise
    finally:
        queue.close()
        queue.join_thread()


def _rank_run(rank: int, store_path: str, inbox) -> dict:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import sharding as shd
    torch.set_num_threads(1)
    # DTensor logs each multi-step redistribution and gloo's all-to-all
    # fallback at WARNING, once a rank
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    params = inbox.get(timeout=SPAWN_TIMEOUT)
    try:
        mesh = make_test_mesh(WORLD, device="cpu")
        shapes = _record_local_shapes()
        out = {"world": dist.get_world_size(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        with shd.use_mesh(mesh):
            for arch in ARCHS:
                out[arch] = _sharded_step(arch, params[arch], mesh)
            for case in F32_CASES:
                out[f"f32 {case}"] = _f32_step(case, params[_arch(case)],
                                               mesh)
            out["f32 masked"] = _f32_step("starcoder2-3b",
                                          params["starcoder2-3b"], mesh,
                                          mask_one=True)
            for arch, cd in DECODE_CASES:
                out[f"decode {arch} {cd}"] = _decode_run(arch, cd,
                                                         params[arch], mesh)
            out["adamw"] = _adamw_on_shards(params["starcoder2-3b"], mesh)
            out["split_sequence_error"] = _split_sequence_raises(mesh)
            out["dryrun_cell"] = _dryrun_cell(mesh)
        out["local_shapes"] = {k: sorted(set(v)) for k, v in shapes.items()}
        return out
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The test process
# ---------------------------------------------------------------------------

def _ref_params() -> dict:
    """The reference's init of each arch as numpy trees."""
    import jax
    from repro.models import build as ref_build
    out = {}
    for arch in ARCHS + F32_ONLY:
        rm = ref_build(_cfg(arch, "bfloat16", ref=True))
        out[arch] = jax.device_get(jax.jit(rm.init)(jax.random.key(0)))
    return out


def _single_device(ref_params) -> dict:
    """The port's single-device bf16 step and f32 step's gradients, and
    the reference's jitted bf16 step, from the same numpy parameters."""
    import jax
    import jax.numpy as jnp
    from repro.models import build as ref_build
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import init_state as ref_init_state
    from repro_torch.ckpt.tree import tree_leaves
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build
    from repro_torch.optim import adamw
    out = {}
    for arch in ARCHS:
        batch = _batch(arch)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        cfg = _cfg(arch, "bfloat16")
        params = params_from_numpy(ref_params[arch], cfg, device="cpu")
        ocfg = adamw.AdamWConfig(**OPT)
        step = build(cfg).make_train_step(ocfg, microbatches=MICRO)
        new_p, _, met = step(params, adamw.init_state(params, ocfg,
                                                      device="cpu"), tb)
        rm = ref_build(_cfg(arch, "bfloat16", ref=True))
        rp = jax.tree.map(jnp.asarray, ref_params[arch])
        rstep = jax.jit(rm.make_train_step(RefAdamWConfig(**OPT),
                                           microbatches=MICRO))
        rnew, _, rmet = rstep(rp, ref_init_state(rp),
                              {k: jnp.asarray(v) for k, v in batch.items()})
        out[arch] = {"loss": float(met["loss"]),
                     "leaves": [x.float().numpy() for x in
                                tree_leaves(new_p)],
                     "ref_loss": float(rmet["loss"]),
                     "ref_leaf": np.asarray(jax.tree.leaves(rnew)[0],
                                            np.float32)}
    for case in F32_CASES:
        out[f"f32 {case}"] = _f32_step(case, ref_params[_arch(case)])
    out["f32 masked"] = _f32_step("starcoder2-3b", ref_params["starcoder2-3b"],
                                  mask_one=True)
    for arch, cd in DECODE_CASES:
        out[f"decode {arch} {cd}"] = _decode_run(arch, cd, ref_params[arch])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"sharded": rank 0's results, "single": the test process's,
    "ref_params": the reference's numpy parameters}.  The
    ranks start while the reference's parameters are made, and the
    single-device runs go on while the ranks work."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    store = str(tmp_path_factory.mktemp("sharded_store") / "store")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    inboxes = [ctx.Queue() for _ in range(WORLD)]
    procs = [ctx.Process(target=_rank_main, args=(r, store, inboxes[r], q),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref_params = _ref_params()
        for box in inboxes:
            box.put(ref_params)
        single = _single_device(ref_params)
        try:
            sharded = q.get(timeout=SPAWN_TIMEOUT)
        except queue_mod.Empty:
            pytest.fail(f"the ranks gave no result in {SPAWN_TIMEOUT} s")
        assert "error" not in sharded, sharded.get("error")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return {"sharded": sharded, "single": single, "ref_params": ref_params}


def _rel(a: float, b: float) -> float:
    return abs(a / b - 1.0)


def _frob(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_ran_on_a_two_by_four_mesh_of_eight_ranks(runs):
    assert runs["sharded"]["world"] == WORLD
    assert runs["sharded"]["mesh"] == {"data": 2, "model": 4}


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_bf16_step_matches_single_device(runs, arch, against):
    """The reference test's bounds: loss rel 2e-2, parameters after one
    update max-abs < 5e-2 (every leaf against the port's single-device
    step; the first leaf against the reference's, as its test holds)."""
    sh, one = runs["sharded"][arch], runs["single"][arch]
    if against == "port":
        assert _rel(sh["loss"], one["loss"]) <= LOSS_RTOL
        diffs = [float(np.abs(a - b).max())
                 for a, b in zip(sh["leaves"], one["leaves"])]
        assert len(diffs) == len(one["leaves"]) and max(diffs) < LEAF_ATOL
    else:
        assert _rel(sh["loss"], one["ref_loss"]) <= LOSS_RTOL
        assert float(np.abs(sh["leaves"][0] - one["ref_leaf"]).max()) \
            < LEAF_ATOL


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_sharded_f32_loss_and_gradients_match_single_device(runs, case):
    """Every leaf within ``F32_GRAD_TOL``; a leaf that is zero in exact
    arithmetic (a top-1 router's) under ``ZERO_GRAD_SHARE`` of the largest
    leaf's norm on both sides."""
    sh, one = runs["sharded"][f"f32 {case}"], runs["single"][f"f32 {case}"]
    assert _rel(sh["loss"], one["loss"]) <= F32_LOSS_RTOL
    assert _rel(sh["grad_norm"], one["grad_norm"]) <= F32_LOSS_RTOL
    assert len(sh["grads"]) == len(one["grads"])
    zero = _zero_grad_leaves(case)
    assert ("llama4" in case) == bool(zero)
    top = max(np.linalg.norm(g) for g in one["grads"])
    for i in zero:
        assert np.linalg.norm(sh["grads"][i]) <= ZERO_GRAD_SHARE * top
        assert np.linalg.norm(one["grads"][i]) <= ZERO_GRAD_SHARE * top
    errs = [_frob(a, b) for i, (a, b) in enumerate(zip(sh["grads"],
                                                       one["grads"]))
            if i not in zero]
    assert max(errs) <= F32_GRAD_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_keeps_its_placements(runs, arch):
    sh = runs["sharded"][arch]
    assert sh["opt_before_mismatches"] == []
    assert sh["param_mismatches"] == []
    assert sh["opt_mismatches"] == []
    assert sh["loss_replicated"]
    grads = runs["sharded"][f"f32 {arch}"]
    assert grads["grad_mismatches"] == []


def test_kernels_ran_on_local_shards(runs):
    """Flash on (B_local * H / 4, S, Dh) with B_local = the microbatch's 4
    rows / 2 (and a prefill's B / 2); the RG-LRU on (B_local, S, W / 4)
    (and a decode step's S of 1); the mLSTM on (B_local * H / 4, S, Dh)
    with its Dh of 2 d / H; llama4's chunks and whisper's encoder, flash
    on 32 positions.  No whole-batch or whole-head call."""
    seen = runs["sharded"]["local_shapes"]
    H, Dh, W = 4, 16, 64
    rows = B // MICRO
    flash = {((rows // 2) * (H // 4), S, Dh), ((B // 2) * (H // 4), PROMPT,
                                                Dh),
             ((rows // 2) * (H // 4), 32, Dh)}
    lru = {(rows // 2, S, W // 4), (B // 2, PROMPT, W // 4),
           (B // 2, 1, W // 4)}
    mlstm = {((rows // 2) * (H // 4), S, 2 * W // H)}
    assert {tuple(s) for s in seen["flash_attention"]} == flash
    assert {tuple(s) for s in seen["rglru_scan"]} == lru
    assert {tuple(s) for s in seen["mlstm_scan_plain"]} == mlstm


def test_decode_ran_on_local_slots(runs):
    """The decode kernel read each rank's 8 of the 32 window slots, for its
    B / 2 rows and every one of the 4 heads (the slots, not the heads,
    split over ``model``)."""
    seen = runs["sharded"]["local_shapes"]["decode_attention"]
    assert {tuple(s) for s in seen} == {((B // 2) * 4, 32 // 4, 16)}


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_f32_decode_matches_single_device(runs, arch):
    """Prefill and 8 decode steps on the mesh, the KV cache split over
    ``model`` along its slots: each step's logits within ``DECODE_F32_TOL``
    of its largest |logit|, and every slot and state a step writes within
    ``CACHE_TOL`` of the single-device step's."""
    sh = runs["sharded"][f"decode {arch} float32"]
    one = runs["single"][f"decode {arch} float32"]
    assert len(sh["logits"]) == len(one["logits"]) == NEW_TOKENS + 1
    for a, b in zip(sh["logits"], one["logits"]):
        assert np.abs(a - b).max() <= DECODE_F32_TOL * np.abs(b).max()
    for got, want in zip(sh["written"], one["written"]):
        assert len(got) == len(want) > 0
        assert max(_frob(a, b) for a, b in zip(got, want)) <= CACHE_TOL


def _next_token_loss(logits: np.ndarray, tokens: np.ndarray) -> float:
    """The mean cross-entropy of (B, 1, V) logits against ``tokens``."""
    lg = logits[:, 0].astype(np.float64)
    top = lg.max(-1)
    lse = top + np.log(np.exp(lg - top[:, None]).sum(-1))
    return float(np.mean(lse - lg[np.arange(len(tokens)), tokens]))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_bf16_decode_matches_single_device(runs, arch):
    """bf16: each step's next-token loss within the reference test's 2e-2
    (relative) of the single-device step's, and its logits no farther from
    them (relative Frobenius) than twice the single-device bf16 logits lie
    from the f32 ones: rounding at other points (partial sums over
    ``model``) moves them by that much (0.017-0.022 for
    recurrentgemma-9b's, whose largest |logit| moves by up to 3%)."""
    sh = runs["sharded"][f"decode {arch} bfloat16"]
    one = runs["single"][f"decode {arch} bfloat16"]
    f32 = runs["single"][f"decode {arch} float32"]
    toks = _tokens(arch)
    for i, (a, b, c) in enumerate(zip(sh["logits"], one["logits"],
                                      f32["logits"])):
        if i < NEW_TOKENS:
            want = _next_token_loss(b, toks[:, PROMPT + i])
            assert _rel(_next_token_loss(a, toks[:, PROMPT + i]), want) \
                <= DECODE_BF16_TOL
        assert _frob(a, b) <= 2 * _frob(b, c)


@pytest.mark.parametrize("arch,cd", DECODE_CASES)
def test_decode_cache_keeps_its_placements(runs, arch, cd):
    """After the prefill and after every decode step, each cache leaf has
    the placements ``cache_spec`` gives (the K/V slots split over
    ``model``): the in-place writes moved no shard."""
    assert runs["sharded"][f"decode {arch} {cd}"]["mismatches"] == []


def test_adamw_on_shards_matches_single_device(runs):
    """A factored second moment on DTensors (its means over split dims
    reduced) against the plain update; the leaf sliced by
    ``UPDATE_CHUNK`` on each shard bitwise the whole-leaf update."""
    ad = runs["sharded"]["adamw"]
    assert ad["factored_leaves"] > 0 and ad["factored_max_abs"] <= 1e-6
    gn, want = ad["grad_norm"]
    assert _rel(gn, want) <= F32_LOSS_RTOL
    assert ad["factored_mismatches"] == []
    assert ad["sliced_leaves"] > 0 and ad["sliced_bitwise"]


def _ulp_sensitivity(case: str, np_params, qk_scale: float,
                     unmoved=None) -> float:
    """The largest relative Frobenius change of an f32 step's gradient
    leaf on one device when the embedding table moves by one ulp
    (``unmoved``: the step's gradients without the move, if known)."""
    if unmoved is None:
        unmoved = _f32_step(case, np_params, qk_scale=qk_scale)["grads"]
    moved = _f32_step(case, np_params, move_first=True,
                      qk_scale=qk_scale)["grads"]
    zero = _zero_grad_leaves(case)
    return max(_frob(b, a) for i, (a, b) in enumerate(zip(unmoved, moved))
               if i not in zero)


#: whisper-tiny's gradients move by 4.8e-6 on one ulp with q and k scaled
#: (its encoder's norms and MLP): within ``F32_GRAD_TOL``, not a third of
#: it, so it is not among these cases.
@pytest.mark.parametrize("case", sorted(c for c in F32_CASES
                                         if "xlstm" not in c
                                         and "whisper" not in c))
def test_one_ulp_moves_f32_gradients_within_the_bound_only_when_scaled(
        runs, case):
    """Why (c) scales q and k: at the reference's init one ulp of the
    embedding table moves some gradient leaf by more than ``F32_GRAD_TOL``
    on one device; with q and k scaled by ``QK_SCALE``, by under a third
    of it."""
    np_params = runs["ref_params"][_arch(case)]
    assert _ulp_sensitivity(case, np_params, 1.0) > F32_GRAD_TOL
    assert _ulp_sensitivity(case, np_params, QK_SCALE, runs["single"][
        f"f32 {case}"]["grads"]) <= F32_GRAD_TOL / 3


def test_a_sequence_split_raises(runs):
    assert "'seq' axis" in runs["sharded"]["split_sequence_error"]


def test_a_masked_label_weighs_as_on_one_device(runs):
    """One masked label (microbatches of 255 and 256 labels): the sharded
    f32 step takes the reference's global rows, so its loss, gradient norm
    and accumulated gradients are the single-device step's."""
    sh, one = runs["sharded"]["f32 masked"], runs["single"]["f32 masked"]
    assert _rel(sh["loss"], one["loss"]) <= F32_LOSS_RTOL
    assert _rel(sh["grad_norm"], one["grad_norm"]) <= F32_LOSS_RTOL
    errs = [_frob(a, b) for a, b in zip(sh["grads"], one["grads"])]
    assert len(errs) == len(one["grads"]) and max(errs) <= F32_GRAD_TOL
    assert sh["loss"] != runs["sharded"]["f32 starcoder2-3b"]["loss"]
    assert sh["grad_mismatches"] == []


def test_dry_run_peak_holds_for_a_real_step(runs):
    """The dry run's reduced cell, a train step of 8 x 64 on the 2 x 4 mesh
    (4 rows a rank), run for real on each rank's shards from a seed: its
    local argument bytes are the record's ``argument_bytes``, and its peak
    (those and the high-water mark of the storages the step makes, counted
    by the dry run's ``LiveBytes``) lies within ``DRYRUN_PEAK_BAND`` of
    the meta trace's ``peak_bytes_est``."""
    cell = runs["sharded"]["dryrun_cell"]
    mem = cell["record_memory"]
    assert cell["local_argument_bytes"] == mem["argument_bytes"]
    ratio = cell["peak"] / mem["peak_bytes_est"]
    assert DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1], ratio


@pytest.mark.parametrize("sizes,want", [
    ({"data": 1, "model": 1}, (None, None)),
    ({"data": 2, "model": 1}, (0, None)),
    ({"data": 2, "model": 4}, (0, 2))])
def test_a_mesh_dim_of_size_one_replicates(sizes, want):
    """A dim split over a mesh dim of size 1 is whole there: its placement
    is ``Replicate()`` (DTensor's views refuse to merge a dim sharded
    over it, which stopped a world-1 step at ``project_heads``)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel import sharding as shd
    spec = shd.resolve_pspec(("batch", "seq", "kv_heads", "head_dim"), sizes,
                             shape=(8, 64, 4, 16))
    assert spec == shd.PartitionSpec("data", None, "model")
    assert shd.placements(spec, sizes) == tuple(
        Replicate() if d is None else Shard(d) for d in want)
