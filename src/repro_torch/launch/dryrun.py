"""Dry run of every (architecture x input shape) cell on the production
meshes: does it fit an H100, and where does its work go.

Counterpart of the reference's ``repro/launch/dryrun.py``.  The reference
lowers and compiles each cell's sharded program for 256 or 512 virtual
devices (``XLA_FLAGS=--xla_force_host_platform_device_count``) and reads
one device's memory and cost from XLA's analyses.  The port compiles
nothing, so:

* the meshes are ``DeviceMesh``\\ es over a ``fake`` process group of 256
  or 512 ranks in this process (``launch/mesh.py``); the caller
  initialises it (:func:`main` does, for a command-line run);
* the parameters, the AdamW state (``adamw.state_spec``) and the inputs
  or cache (``models.input_specs``) are meta DTensors at their global
  shapes with the mesh's placements (``models.spec.abstract_tree``), which
  allocate nothing; ``memory.argument_bytes`` is the exact sum of one
  rank's local shard bytes of them, the reference's number;
* the step -- the model's own train step with the reference's
  microbatches, the prefill, or one decode step -- runs once on those
  stand-ins with the mesh active (``sharding.use_mesh``): one rank's
  tensor-parallel step, as the models run on DTensors (every kernel
  wrapper has a shape-only path, ``kernels/cost.py``).  The ``fake``
  group's functional collectives run their meta kernels, so nothing
  moves;
* ``launch/cost.py`` counts that run's local ops (the dispatch modes let
  DTensor break each op into the ops one rank runs on its shards, and see
  those and the collectives they need), so ``flops_per_device``,
  ``bytes_accessed_per_device`` and the collectives are one rank's;
  ``memory.temp_bytes`` is the high-water mark of the local storages the
  run makes (redistribution buffers and collective outputs included)
  beyond what the step returns (``output_bytes``);
* ``memory.peak_bytes_est = argument_bytes + output_bytes + temp_bytes -
  alias_bytes``, and ``fits_hbm`` compares it with ``launch/mesh.py``'s
  ``H100["hbm_bytes"]``.  The port donates no buffer (``alias_bytes`` 0),
  so the step's outputs stand beside its arguments, where the reference
  subtracts what it donates.  The record's ``memory.method`` says so.

Records go to ``build/repro_torch_results/dryrun/``.

    python -m repro_torch.launch.dryrun --all --both-meshes --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch.utils._pytree import tree_flatten as pt_flatten

from .._device import resolve_device
from ..ckpt.tree import tree_flatten, tree_leaves, tree_unflatten
from ..configs import ALL_ARCHS, get_config
from ..configs.base import SHAPES, ArchConfig, ShapeConfig
from ..models import build, input_specs
from ..models.spec import abstract_tree
from ..optim import adamw
from ..parallel import sharding as shd
from . import cost
from .mesh import H100, make_production_mesh

MEMORY_METHOD = (
    "argument_bytes: exact, one rank's local shard bytes of params, AdamW "
    "state and inputs or cache on the mesh; output_bytes and temp_bytes: "
    "one rank's local storages in a trace of the tensor-parallel step on "
    "meta DTensors over the mesh (what the step returns; the high-water "
    "mark of the rest, redistribution and collective buffers included); "
    "peak_bytes_est: argument_bytes + output_bytes + temp_bytes - "
    "alias_bytes; alias_bytes: 0 (the port donates no buffer)")


def results_dir() -> Path:
    from ..benchmarks import _util
    return _util.RESULTS / "dryrun"


def production_config(name: str, *, serving: bool = False) -> ArchConfig:
    """Arch config with production numerics: padded heads for TP=16; bf16
    parameters.  llama4 takes the per-row capacity MoE (top-1; the dense
    path computes 16x the active FLOPs); serving runs an int8 KV cache
    without remat.  The reference's numerics (``dryrun.py:84-103``)."""
    cfg = dataclasses.replace(get_config(name), head_pad_multiple=16,
                              param_dtype="bfloat16")
    if cfg.name == "llama4-scout-17b-a16e":
        cfg = dataclasses.replace(cfg, moe_impl="capacity")
    if serving:
        cfg = dataclasses.replace(cfg, remat="none", kv_cache_dtype="int8")
    return cfg


def cell_config(arch: str, shape: ShapeConfig, multi_pod: bool = False):
    """The cell's config: :func:`production_config`, and for llama4 at
    prefill_32k the dense MoE in waves that keep a wave's batch divisible
    by the data-parallel degree (the reference's exception)."""
    cfg = production_config(arch, serving=shape.kind != "train")
    if arch == "llama4-scout-17b-a16e" and shape.name == "prefill_32k":
        dp = 32 if multi_pod else 16
        waves = 2 if (shape.global_batch // 2) % dp == 0 else 1
        cfg = dataclasses.replace(cfg, moe_impl="dense", prefill_waves=waves)
    return cfg


def opt_config(cfg: ArchConfig) -> adamw.AdamWConfig:
    """>100B params: bf16-native params with no f32 master copy; smaller
    archs keep the master (``dryrun.py:123-126``)."""
    return adamw.AdamWConfig(factored_second_moment=True,
                             momentum_dtype="bfloat16",
                             master_weights=cfg.param_count() < 100e9)


def dp_size(mesh) -> int:
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    n = 1
    for ax in ("pod", "data"):
        if ax in names:
            n *= mesh.size(names.index(ax))
    return n


def mesh_name(mesh) -> str:
    names = tuple(mesh.mesh_dim_names or ())
    shape = [mesh.size(i) for i in range(len(names))]
    if names == ("data", "model") and shape == [16, 16]:
        return "pod16x16"
    if names == ("pod", "data", "model") and shape == [2, 16, 16]:
        return "pod2x16x16"
    return "x".join(f"{n}{s}" for n, s in zip(names, shape))


def _local_bytes(tree) -> int:
    total = 0
    for x in tree_leaves(tree):
        t = x.to_local() if hasattr(x, "to_local") else x
        total += t.numel() * t.element_size()
    return total


def argument_trees(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """The step's arguments as stand-ins on ``mesh``: params, and the AdamW
    state and batch (train), the batch (prefill) or the cache and token
    (decode)."""
    model = build(cfg)
    pspec = model.param_spec()
    out = {"params": abstract_tree(pspec, mesh)}
    if shape.kind == "train":
        out["opt"] = abstract_tree(adamw.state_spec(pspec, opt_config(cfg)),
                                   mesh)
    out["inputs"] = input_specs(cfg, shape, mesh)
    return out


def argument_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """One rank's local shard bytes of the step's arguments (exact)."""
    return sum(_local_bytes(t) for t in
               argument_trees(cfg, shape, mesh).values())


def _host_positions(cache, seq_len: int):
    """A decode cache of meta stand-ins with its ``pos`` and ``slot_pos``
    leaves (host int32 tensors in the port's serving path) made real on
    the host: the step decodes the last position of a full cache."""
    leaves, td = tree_flatten(cache["slot_pos"])
    cache = dict(cache)
    cache["pos"] = torch.tensor(seq_len - 1, dtype=torch.int32)
    cache["slot_pos"] = tree_unflatten(td, [
        torch.zeros(tuple(x.shape), dtype=torch.int32) for x in leaves])
    return cache


def microbatches(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """The reference's microbatch count of a train cell on ``mesh``."""
    return max(1, shape.global_batch
               // (dp_size(mesh) * cfg.microbatch_rows_per_device))


def train_step(cfg: ArchConfig, k: int):
    """The model's train step with ``k`` microbatches, accumulated as the
    reference accumulates them (bf16 from 8 microbatches)."""
    return build(cfg).make_train_step(
        opt_config(cfg), microbatches=k,
        accum_dtype="bfloat16" if k >= 8 else "float32")


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """(callable, args) of the cell's step on its arguments as meta DTensors
    on ``mesh`` (:func:`argument_trees`): the train step with the
    reference's microbatches (:func:`microbatches`), the prefill, or one
    decode step, to be run with ``mesh`` active (``sharding.use_mesh``)."""
    model = build(cfg)
    trees = argument_trees(cfg, shape, mesh)
    params, inp = trees["params"], trees["inputs"]
    if shape.kind == "train":
        step = train_step(cfg, microbatches(cfg, shape, mesh))
        return step, (params, trees["opt"], inp)
    if shape.kind == "prefill":
        def prefill(params, batch):
            return model.prefill(params, batch, max_cache_seq=shape.seq_len)
        return prefill, (params, inp)
    return model.decode_step, (
        params, _host_positions(inp["cache"], shape.seq_len), inp["token"])


class LiveBytes(cost.LocalOps):
    """The live bytes of the storages that one rank's ops make
    (``cost.LocalOps``), and their high-water mark.  A storage counts from
    the first op that returns it until the last tensor on it is freed;
    storages of tensors made before the mode (the arguments, or of a
    DTensor argument its local tensor) are never counted, even when an op
    writes them in place."""

    def __init__(self, exclude=()):
        super().__init__()
        self.live, self.cur, self.peak = {}, 0, 0
        self.exclude = {shd.local(t).untyped_storage()._cdata
                        for t in exclude if isinstance(t, torch.Tensor)}

    def _drop(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.cur -= entry[0]
            del self.live[key]

    def see(self, func, args, kwargs, out) -> None:
        # a collective's result wrapped for autograd is its input on a
        # device (an ``AsyncCollectiveTensor``); off one, a copy
        wraps = func.__name__.startswith("_wrap_tensor_autograd")
        for t in pt_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = (args[0] if wraps else t).untyped_storage()
            key = st._cdata
            if key in self.exclude:
                continue
            if key not in self.live:
                self.live[key] = [st.nbytes(), 0]
                self.cur += st.nbytes()
                self.peak = max(self.peak, self.cur)
            self.live[key][1] += 1
            weakref.finalize(t, self._drop, key)


def trace(fn, args, mesh=None) -> tuple:
    """(cost vector, output bytes, temp bytes, seconds) of one run of
    ``fn(*args)`` on meta stand-ins with ``mesh`` (if any) active, one
    rank's."""
    t0 = time.perf_counter()
    mem = LiveBytes(exclude=pt_flatten(args)[0])
    box = {}

    def run():
        with mem:
            box["out"] = fn(*args)
    with (shd.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        walked = cost.analyze(run)
    out_bytes = mem.cur
    del box
    return walked, out_bytes, max(0, mem.peak - out_bytes), \
        time.perf_counter() - t0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             save: bool = True, device="cuda", mesh=None,
             shape: Optional[ShapeConfig] = None,
             n_layers: Optional[int] = None) -> dict:
    """Trace one cell (:func:`cell_record`) and write its record.
    ``mesh`` (default the production mesh on ``device``), ``shape``
    (default ``SHAPES[shape_name]``) and ``n_layers`` (a cut of depth) make
    reduced cells."""
    shape = shape or SHAPES[shape_name]
    cfg = cell_config(arch, shape, multi_pod)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    record = cell_record(arch, cfg, shape, mesh)
    if save:
        d = results_dir()
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{arch}__{shape.name}__{record['mesh']}.json"
        path.write_text(json.dumps(record, indent=1))
    return record


def cell_record(arch: str, cfg: ArchConfig, shape: ShapeConfig,
                mesh) -> dict:
    """The roofline-input record (the reference's keys) of ``cfg``'s step
    at ``shape`` traced as one rank of ``mesh``."""
    n_chips = mesh.size()
    t0 = time.perf_counter()
    arg_bytes = argument_bytes(cfg, shape, mesh)
    t_args = time.perf_counter() - t0
    fn, args = build_cell(cfg, shape, mesh)
    walked, out_bytes, temp_bytes, t_trace = trace(fn, args, mesh)
    alias_bytes = 0         # the port donates no buffer
    model = build(cfg)
    coll_total = float(sum(walked.coll_bytes.values()))
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name(mesh),
        "n_chips": n_chips,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "n_layers": cfg.n_layers,
        "param_count": model.param_count(),
        "active_param_count": cfg.active_param_count(),
        "flops_per_device": walked.flops,
        "bytes_accessed_per_device": walked.hbm_bytes,
        "transcendentals": float(walked.ops.get("transcendental", 0)),
        "collectives": {"bytes_by_type": dict(walked.coll_bytes),
                        "counts_by_type": dict(walked.coll_counts),
                        "total_bytes": int(coll_total)},
        "walked": {
            "flops_per_device": walked.flops,
            "hbm_bytes_per_device": walked.hbm_bytes,
            "coll_bytes_by_type": dict(walked.coll_bytes),
            "coll_counts_by_type": dict(walked.coll_counts),
            "coll_bytes_total": coll_total,
            "kernel_calls": dict(walked.kernels),
            "kernel_ops": dict(walked.ops),
        },
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp_bytes,
            "alias_bytes": alias_bytes,
            "peak_bytes_est": (arg_bytes + out_bytes + temp_bytes
                               - alias_bytes),
            "method": MEMORY_METHOD,
        },
        "hbm_per_chip": H100["hbm_bytes"],
        "timings_s": {"arguments": round(t_args, 2),
                      "trace": round(t_trace, 2)},
    }
    record["fits_hbm"] = bool(
        record["memory"]["peak_bytes_est"] <= H100["hbm_bytes"])
    return record


def all_cells(multi_pod: bool = False):
    for cfg in ALL_ARCHS:
        for shape in cfg.applicable_shapes():
            yield cfg.name, shape.name, multi_pod


def _create_fake_pg(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup
    return FakeProcessGroup._create_internal(
        common_opts.group_rank, common_opts.group_size, backend_opts)


def init_fake_group(world: int = 512) -> None:
    """A ``fake`` process group of ``world`` ranks in this process (rank 0;
    collectives do nothing), unless a group is initialised already.  The
    backend is registered here as ``torch.testing``'s ``fake_pg`` module
    registers it, which the port does not import."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dist.Backend.register_backend(dist.Backend.FAKE, _create_fake_pg,
                                  extended_api=True,
                                  devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one architecture id")
    ap.add_argument("--shape", default=None, help="one shape name")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 ranks) instead of 16x16")
    ap.add_argument("--all", action="store_true",
                    help="every applicable (arch x shape) on this mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="with --all: run single-pod AND multi-pod")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--print-hlo-stats", action="store_true",
                    help="print each cell's kernel calls (the port has no "
                         "HLO)")
    ap.add_argument("--device", default="cuda",
                    help="the meshes' device type (default cuda; raises "
                         "without a GPU unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cells = []
    if args.all:
        cells += list(all_cells(multi_pod=args.multi_pod))
        if args.both_meshes:
            cells += list(all_cells(multi_pod=True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape, args.multi_pod)]

    init_fake_group(512)
    failures = []
    t_all = time.perf_counter()
    for arch, shape, mp in cells:
        name = "pod2x16x16" if mp else "pod16x16"
        out = results_dir() / f"{arch}__{shape}__{name}.json"
        if args.skip_existing and out.exists():
            print(f"[skip] {arch} x {shape} x {name}")
            continue
        try:
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, multi_pod=mp, device=args.device)
            print(f"[ok]   {arch} x {shape} x {name}: "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"coll={rec['collectives']['total_bytes']:.3e}B "
                  f"args={rec['memory']['argument_bytes'] / 2**30:.2f}GiB "
                  f"peak={rec['memory']['peak_bytes_est'] / 2**30:.2f}GiB "
                  f"fits={rec['fits_hbm']} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
            if args.print_hlo_stats:
                print(f"       kernels {rec['walked']['kernel_calls']}")
        except Exception as e:   # noqa: BLE001 -- report and continue
            failures.append((arch, shape, name, repr(e)))
            print(f"[FAIL] {arch} x {shape} x {name}: {e!r}", flush=True)
            traceback.print_exc(limit=3)
    print(f"\n{len(cells)} cells in {time.perf_counter() - t_all:.0f} s")
    if failures:
        print(f"{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("All dry-run cells traced.")


if __name__ == "__main__":
    main()
