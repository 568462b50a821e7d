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
* One reduced cell's record, end to end (a trace on ``meta`` tensors,
  written to the results directory).
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
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, make_production_mesh

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
    trees.append(RM.input_specs(cfg, RC.base.SHAPES[shape.name], am))
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


def test_reduced_cell_record(meshes, tmp_path, monkeypatch):
    """starcoder2-3b at its production numerics cut to 2 layers, a train
    step of 32 x 256 on the 256-rank mesh (2 rows a rank), traced on
    meta tensors; the record has the reference's keys and is written."""
    monkeypatch.setattr(_util, "RESULTS", tmp_path)
    shape = ShapeConfig("train_small", "train", 256, 32)
    rec = dryrun.run_cell("starcoder2-3b", "train_small", shape=shape,
                          n_layers=2, mesh=meshes["pod16x16"],
                          device="cpu")
    assert REF_KEYS <= set(rec)
    assert (rec["mesh"], rec["n_chips"], rec["n_layers"]) == (
        "pod16x16", 256, 2)
    mem = rec["memory"]
    assert mem["argument_bytes"] == dryrun.argument_bytes(
        dataclasses.replace(dryrun.cell_config("starcoder2-3b", shape),
                            n_layers=2), shape, meshes["pod16x16"])
    # the peak is the traced rank's: whole params and AdamW state, its 2
    # rows of inputs; the mesh's shards are the reference's argument bytes
    whole = dryrun.argument_bytes(
        dataclasses.replace(dryrun.cell_config("starcoder2-3b", shape),
                            n_layers=2), dryrun.rank_shape(
                                shape, meshes["pod16x16"]), None)
    assert mem["rank_argument_bytes"] == whole > 16 * mem["argument_bytes"]
    assert mem["peak_bytes_est"] == (mem["rank_argument_bytes"]
                                     + mem["output_bytes"]
                                     + mem["temp_bytes"])
    assert mem["output_bytes"] > 0 and mem["temp_bytes"] > 0
    assert "meta trace" in mem["method"]
    assert rec["fits_hbm"] and rec["hbm_per_chip"] == 85_017_493_504
    w = rec["walked"]
    assert w["flops_per_device"] > 0 and w["hbm_bytes_per_device"] > 0
    # remat "full": the forward and its recompute, 2 layers
    assert w["kernel_calls"] == {"flash_attention": 4}
    assert w["coll_bytes_by_type"]["all-reduce"] > 0
    assert "all-reduce" in rec["collectives"]["modelled"]
    saved = json.loads((tmp_path / "dryrun"
                        / "starcoder2-3b__train_small__pod16x16.json")
                       .read_text())
    assert saved["memory"] == mem


def test_decode_cell_attends_the_full_cache(meshes):
    """A decode cell steps at the cache's last position: every layer's
    decode kernel reads the whole (ring) cache."""
    shape = ShapeConfig("decode_small", "decode", 512, 32)
    rec = dryrun.run_cell("starcoder2-3b", "decode_small", shape=shape,
                          n_layers=2, mesh=meshes["pod2x16x16"],
                          device="cpu", save=False)
    assert rec["walked"]["kernel_calls"] == {"decode_attention": 2}
    assert rec["collectives"]["total_bytes"] == 0


def test_main_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "starcoder2-3b", "--shape", "train_4k"])
