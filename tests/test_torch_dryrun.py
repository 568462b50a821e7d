"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

The meshes are ``DeviceMesh``\\ es over a ``fake`` process group of 512
ranks in this process (``dryrun.init_fake_group``), set up for the module
and torn down after it; the reference's shardings resolve on
``jax.sharding.AbstractMesh`` of the same shape and names (no virtual
devices, no compile; ``repro.launch.dryrun`` is never imported: it sets
``XLA_FLAGS``).

* Every one of the 34 (arch, shape) cells on both production meshes: one
  rank's ``argument_bytes`` (params, AdamW state under the dry run's
  optimizer config, inputs or cache) equals the sum of the reference's
  local shard bytes (``NamedSharding(mesh, spec).shard_shape``) over the
  same trees.  Every shard is even (the rules keep only axes that divide
  a dim), so each rank holds the same bytes.
* ``launch.cost.analyze`` of a sharded matmul on a fake 16-rank mesh
  counts one rank's FLOPs and the collective its result needs.
* One reduced cell's record, end to end (a trace of the tensor-parallel
  train step on meta DTensors, written to the results directory), and a
  decode cell whose KV cache is split over ``model`` along its slots.
* Every arch at a reduced width that keeps the production shardings
  non-trivial (heads padded to 16, vocab and ``d_model`` divisible by 16,
  16 experts where the arch has them), traced as train, prefill and
  decode on the 256-rank mesh: ``argument_bytes`` is the reference's
  shard bytes, the peak lies below the same cell's whole-model peak (a
  trace on plain meta tensors), and summed over the 256 ranks the FLOPs
  are at least the whole-model trace's, at the ratio :data:`FLOP_RATIO`
  pins (above 1 where a rank computes work another rank also computes:
  PERF.md §6 names it).
* The command line defaults to ``cuda`` and raises without a GPU.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import repro.configs as RC
import repro.models as RM
from repro.models import spec as ref_spec
from repro.optim import adamw as ref_adamw

from repro_torch.benchmarks import _util
from repro_torch.configs import ALL_ARCHS, reduced
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import cost, dryrun, make_production_mesh
from repro_torch.launch.mesh import make_test_mesh

ARCHS = [c.name for c in ALL_ARCHS]
MESHES = {"pod16x16": ((16, 16), ("data", "model"), False),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}
#: the reference's record keys (``repro/launch/dryrun.py:run_cell``).
REF_KEYS = {"arch", "shape", "mesh", "n_chips", "kind", "seq_len",
            "global_batch", "param_count", "active_param_count",
            "flops_per_device", "bytes_accessed_per_device",
            "transcendentals", "collectives", "walked", "memory",
            "hbm_per_chip", "timings_s", "fits_hbm"}


@pytest.fixture(scope="module")
def meshes():
    assert not dist.is_initialized()
    dryrun.init_fake_group(512)
    yield {name: make_production_mesh(multi_pod=mp, device="cpu")
           for name, (_, _, mp) in MESHES.items()}
    dist.destroy_process_group()


def _ref_production(name: str, shape) -> object:
    """The reference's cell config (``dryrun.py:84-103`` and the llama4
    prefill exception), written out: importing that module sets
    ``XLA_FLAGS``."""
    cfg = dataclasses.replace(RC.get_config(name), head_pad_multiple=16,
                              param_dtype="bfloat16")
    if cfg.name == "llama4-scout-17b-a16e":
        cfg = dataclasses.replace(cfg, moe_impl="capacity")
    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, remat="none", kv_cache_dtype="int8")
    return cfg


def _ref_shard_bytes(tree) -> int:
    total = 0
    for x in jax.tree.leaves(tree):
        local = x.sharding.shard_shape(x.shape)
        total += math.prod(local) * np.dtype(x.dtype).itemsize
    return total


def _ref_argument_bytes(cfg, shape, am) -> int:
    model = RM.build(cfg)
    pspec = model.param_spec()
    trees = [ref_spec.abstract_tree(pspec, am)]
    if shape.kind == "train":
        ocfg = ref_adamw.AdamWConfig(
            factored_second_moment=True, momentum_dtype="bfloat16",
            master_weights=cfg.param_count() < 100e9)
        trees.append(ref_spec.abstract_tree(
            ref_adamw.state_spec(pspec, ocfg), am))
    rshape = RC.base.ShapeConfig(shape.name, shape.kind, shape.seq_len,
                                 shape.global_batch)
    trees.append(RM.input_specs(cfg, rshape, am))
    return sum(_ref_shard_bytes(t) for t in trees)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_are_the_reference_shard_bytes(meshes, arch,
                                                      mesh_name):
    shape_, names, mp = MESHES[mesh_name]
    am = AbstractMesh(shape_, names)
    cfg_shapes = RC.get_config(arch).applicable_shapes()
    assert cfg_shapes
    for rshape in cfg_shapes:
        shape = SHAPES[rshape.name]
        cfg = dryrun.cell_config(arch, shape, mp)
        got = dryrun.argument_bytes(cfg, shape, meshes[mesh_name])
        want = _ref_argument_bytes(_ref_production(arch, shape), shape, am)
        assert got == want, (arch, shape.name, mesh_name)


def test_cells_cover_both_meshes():
    cells = list(dryrun.all_cells()) + list(dryrun.all_cells(True))
    assert len(cells) == 68 and len(set(cells)) == 68
    assert sum(len(RC.get_config(a).applicable_shapes())
               for a in ARCHS) == 34


def test_analyze_counts_a_sharded_matmul_on_one_rank(meshes):
    """x (64, 128) split over ``data`` by rows, w (128, 256) over
    ``model`` by columns, on a 4 x 4 mesh of the fake group's first 16
    ranks: a rank multiplies its 16 x 128 rows by its 128 x 64 columns,
    1/16 of the whole product's FLOPs, and moves nothing; split along the
    contraction instead, each rank's partial product is summed by one
    all-reduce of its 16 x 256 f32 piece."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_test_mesh(16, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and mesh.size() == 16

    def on(t, pl):
        return DTensor.from_local(t, mesh, pl, run_check=False)
    x = on(torch.empty(16, 128, device="meta"), (Shard(0), Replicate()))
    w = on(torch.empty(128, 64, device="meta"), (Replicate(), Shard(1)))
    got = cost.analyze(lambda a, b: a @ b, x, w)
    assert got.flops == 2 * 16 * 128 * 64 == 2 * 64 * 128 * 256 / 16
    assert not got.coll_bytes and not got.coll_counts
    xk = on(torch.empty(16, 32, device="meta"), (Shard(0), Shard(1)))
    wk = on(torch.empty(32, 256, device="meta"), (Replicate(), Shard(0)))
    got = cost.analyze(lambda a, b: (a @ b).full_tensor(), xk, wk)
    assert got.flops == 2 * 16 * 32 * 256
    assert got.coll_counts["all-reduce"] == 1
    assert got.coll_bytes["all-reduce"] == 16 * 256 * 4


def test_fresh_tensors_and_nested_meshes(meshes):
    """A fresh tensor that meets a meta DTensor (a zero state, the conv
    pad, MoE's scatter targets: ``sharding.sharded_full``) is made on the
    stand-in's device, one rank's shard of it, as the trace needs: on the
    mesh's own device it would be real storage.  ``use_mesh`` inside
    another brings the outer mesh back on exit."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.parallel import sharding as shd
    mesh = meshes["pod16x16"]
    like = DTensor.from_local(torch.empty(2, 8, device="meta"), mesh,
                              (Shard(0), Replicate()), run_check=False)
    with shd.use_mesh(mesh):
        z = shd.sharded_full((32, 4, 64), 0, ("batch", None, "lru"), like,
                             torch.float32)
        with shd.use_mesh(meshes["pod2x16x16"]):
            assert shd.active_mesh() is meshes["pod2x16x16"]
        assert shd.active_mesh() is mesh
    assert shd.active_mesh() is None
    assert tuple(z.shape) == (32, 4, 64) and z.placements == (Shard(0),
                                                              Shard(2))
    assert z.to_local().device.type == "meta"
    assert tuple(z.to_local().shape) == (2, 4, 4)


def _whole_model(cfg, shape, k: int) -> tuple:
    """(cost vector, peak bytes) of the cell's step on plain meta tensors:
    the whole model on one device, a train step with ``k``
    microbatches."""
    fn, args = dryrun.build_cell(cfg, shape, None)
    if shape.kind == "train":
        fn = dryrun.train_step(cfg, k)
    whole, out, temp, _ = dryrun.trace(fn, args)
    return whole, dryrun.argument_bytes(cfg, shape, None) + out + temp


def test_reduced_cell_record(meshes, tmp_path, monkeypatch):
    """starcoder2-3b at its production numerics cut to 2 layers, a train
    step of 32 x 256 on the 256-rank mesh (2 rows a rank), traced on meta
    DTensors; the record has the reference's keys, one rank's numbers,
    and is written."""
    monkeypatch.setattr(_util, "RESULTS", tmp_path)
    shape = ShapeConfig("train_small", "train", 256, 32)
    mesh = meshes["pod16x16"]
    cfg = dataclasses.replace(dryrun.cell_config("starcoder2-3b", shape),
                              n_layers=2)
    rec = dryrun.run_cell("starcoder2-3b", "train_small", shape=shape,
                          n_layers=2, mesh=mesh, device="cpu")
    assert REF_KEYS <= set(rec)
    assert (rec["mesh"], rec["n_chips"], rec["n_layers"]) == (
        "pod16x16", 256, 2)
    mem = rec["memory"]
    assert mem["argument_bytes"] == dryrun.argument_bytes(cfg, shape, mesh)
    # the peak is one rank's: its shards of the arguments, and what its
    # step returns and makes beside them
    assert mem["alias_bytes"] == 0
    assert mem["peak_bytes_est"] == (mem["argument_bytes"]
                                     + mem["output_bytes"]
                                     + mem["temp_bytes"]
                                     - mem["alias_bytes"])
    assert 0 < mem["output_bytes"] and 0 < mem["temp_bytes"]
    assert "meta DTensors" in mem["method"]
    # the whole model on one device holds more than 16x as much
    whole, whole_peak = _whole_model(cfg, shape,
                                     dryrun.microbatches(cfg, shape, mesh))
    assert 16 * mem["peak_bytes_est"] < whole_peak
    assert rec["fits_hbm"] and rec["hbm_per_chip"] == 85_017_493_504
    w = rec["walked"]
    assert w["flops_per_device"] == rec["flops_per_device"] > 0
    assert w["hbm_bytes_per_device"] > 0
    # no work lost: the ranks' FLOPs sum to the whole model's, and 0.22%
    # more (the flash backward takes blocks of query rows that grow as a
    # rank's batch x heads shrinks, and a causal block computes its rows
    # against the keys of its last row)
    assert 256 * w["flops_per_device"] / whole.flops == pytest.approx(
        1.0022, abs=1e-4)
    # remat "full": the forward and its recompute, 2 layers
    assert w["kernel_calls"] == {"flash_attention": 4}
    # every collective is traced: the gradients' reductions among them
    coll = rec["collectives"]
    assert set(coll) == {"bytes_by_type", "counts_by_type", "total_bytes"}
    assert coll["bytes_by_type"] == w["coll_bytes_by_type"]
    assert coll["bytes_by_type"]["all-reduce"] > 0
    assert coll["bytes_by_type"]["reduce-scatter-tensor"] > 0
    assert coll["total_bytes"] == int(w["coll_bytes_total"]) > 0
    saved = json.loads((tmp_path / "dryrun"
                        / "starcoder2-3b__train_small__pod16x16.json")
                       .read_text())
    assert saved["memory"] == mem


def test_decode_cell_attends_the_full_cache(meshes):
    """A decode cell steps at the cache's last position: every layer's
    decode kernel reads a rank's 32 of the 512 ring slots (the slots split
    over ``model``) for its 2 of the 32 rows and all 32 padded heads, and
    the pieces merge across ``model``: together the 16 ranks read the
    whole cache."""
    from repro_torch.kernels import cost as kcost
    shape = ShapeConfig("decode_small", "decode", 512, 32)
    rec = dryrun.run_cell("starcoder2-3b", "decode_small", shape=shape,
                          n_layers=2, mesh=meshes["pod2x16x16"],
                          device="cpu", save=False)
    w = rec["walked"]
    assert w["kernel_calls"] == {"decode_attention": 2}
    one = kcost.decode_work(1 * 32, 512 // 16, 128, torch.bfloat16)
    assert w["kernel_ops"]["f32"] == 2 * one.ops["f32"]
    # the log-sum-exp merge: an all-reduce of the maxima and of the sums a
    # layer, and the rest of the step's collectives
    assert w["coll_counts_by_type"]["all-reduce"] >= 2 * 2
    assert rec["collectives"]["total_bytes"] > 0


#: the reduced cells' shapes: one row a rank of the 256-rank mesh, so every
#: arch's train step takes one microbatch.
SMALL = {"train": ShapeConfig("train_small", "train", 64, 16),
         "prefill": ShapeConfig("prefill_small", "prefill", 64, 16),
         "decode": ShapeConfig("decode_small", "decode", 128, 16)}
#: each reduced cell's FLOPs summed over the 256 ranks over the
#: whole-model trace's.  Above 1 where ranks repeat work: a mesh axis that
#: does not divide what it would split leaves it whole on every rank there
#: (PERF.md §6 names what for each arch).
FLOP_RATIO = {
    ("codeqwen1.5-7b", "decode"): 1.3571,
    ("dbrx-132b", "train"): 1.0189, ("dbrx-132b", "prefill"): 1.0178,
    ("dbrx-132b", "decode"): 1.3543,
    ("deepseek-coder-33b", "decode"): 1.3571,
    ("internvl2-1b", "decode"): 1.1829,
    ("llama4-scout-17b-a16e", "train"): 1.0802,
    ("llama4-scout-17b-a16e", "prefill"): 1.0828,
    ("llama4-scout-17b-a16e", "decode"): 1.3191,
    ("recurrentgemma-9b", "train"): 1.2362,
    ("recurrentgemma-9b", "prefill"): 1.2516,
    ("recurrentgemma-9b", "decode"): 1.2362,
    ("starcoder2-3b", "decode"): 1.3000,
    ("whisper-tiny", "decode"): 1.3000,
    ("xlstm-125m", "train"): 2.8350, ("xlstm-125m", "prefill"): 2.8325,
    ("xlstm-125m", "decode"): 2.2311,
}


def _small_cfg(arch: str, shape, ref: bool = False):
    """The cell's production config (the reference's with ``ref``) at the
    reduced width (``configs.reduced``: d 64, 4 heads padded to 16, vocab
    512), with the production remat and the arch's own expert count;
    llama4 keeps one super-block of 4 layers."""
    prod = (_ref_production(arch, shape) if ref
            else dryrun.cell_config(arch, shape))
    red = RC.reduced if ref else reduced
    return dataclasses.replace(
        red(prod, n_layers=4 if arch.startswith("llama4") else 2),
        head_pad_multiple=16, remat=prod.remat, n_experts=prod.n_experts)


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_tensor_parallel_cell(meshes, arch, kind):
    shape = SMALL[kind]
    mesh = meshes["pod16x16"]
    cfg = _small_cfg(arch, shape)
    rec = dryrun.cell_record(arch, cfg, shape, mesh)
    mem = rec["memory"]
    am = AbstractMesh(*MESHES["pod16x16"][:2])
    assert mem["argument_bytes"] == _ref_argument_bytes(
        _small_cfg(arch, shape, ref=True), shape, am)
    k = dryrun.microbatches(cfg, shape, mesh)
    assert k == 1
    whole, whole_peak = _whole_model(cfg, shape, k)
    assert mem["peak_bytes_est"] < whole_peak
    ratio = 256 * rec["flops_per_device"] / whole.flops
    assert ratio >= 1.0
    assert ratio == pytest.approx(FLOP_RATIO.get((arch, kind), 1.0),
                                  abs=1e-4)


def test_main_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "starcoder2-3b", "--shape", "train_4k"])
