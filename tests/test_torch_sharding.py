"""Logical-axis shardings and meshes (``repro_torch.parallel.sharding``,
``launch.mesh``, the mesh forms of ``models.spec`` and ``input_specs``)
against the reference, on the CPU.

The port's meshes are ``DeviceMesh``\\ es over a world of 512 ranks in this
one process: ``torch.distributed``'s ``fake`` backend, set up for the
module and torn down after it.  The reference's shardings resolve on
``jax.sharding.AbstractMesh`` of the same shape and axis names, and
``NamedSharding(abstract_mesh, spec).shard_shape`` gives its shard shapes,
so no virtual devices are needed on either side.  For all ten archs on
both production meshes, every leaf of the parameter tree, of the AdamW
state under the dry-run's optimizer config and of ``input_specs`` of every
applicable shape must have the reference's spec and local shard shape.
DTensor's layout of a dim split over several mesh axes is held against
XLA's tile assignment for every multi-axis rule of ``DEFAULT_RULES``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import repro.configs as RC
import repro.models as RM
from repro.models import spec as ref_spec
from repro.optim import adamw as ref_adamw
from repro.parallel import sharding as ref_shd

import repro_torch.configs as TC
import repro_torch.models as TM
from repro_torch.ckpt.tree import tree_leaves
from repro_torch.launch import make_production_mesh, make_test_mesh
from repro_torch.models import spec as port_spec
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd

ARCHS = [c.name for c in RC.ALL_ARCHS]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def world():
    """A fake process group of 512 ranks for this module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield 512
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes(world):
    return {"pod16x16": make_production_mesh(device="cpu"),
            "pod2x16x16": make_production_mesh(multi_pod=True,
                                               device="cpu")}


def _production(configs, name: str, serving: bool):
    """The dry-run's production numerics of ``name`` (``repro.launch
    .dryrun.production_config``, written out here because importing that
    module sets ``XLA_FLAGS``), from either package's configs."""
    cfg = dataclasses.replace(configs.get_config(name), head_pad_multiple=16,
                              param_dtype="bfloat16")
    if cfg.name == "llama4-scout-17b-a16e":
        cfg = dataclasses.replace(cfg, moe_impl="capacity")
    if serving:
        cfg = dataclasses.replace(cfg, remat="none", kv_cache_dtype="int8")
    return cfg


def _opt_cfg(module, cfg):
    """The dry-run's optimizer config (``dryrun.py:123-126``)."""
    return module.AdamWConfig(factored_second_moment=True,
                              momentum_dtype="bfloat16",
                              master_weights=cfg.param_count() < 100e9)


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=ref_spec.is_spec)


def _hold(ref_specs, port_abstract, port_specs, am, what):
    """Every leaf: the port's spec equals the reference's resolved one,
    and the port's DTensor stand-in has the reference's global and local
    shard shapes, dtype and the spec's placements."""
    ref = [(tuple(s.shape), ref_shd.resolve_pspec(s.logical, am, None,
                                                  s.shape))
           for s in ref_specs]
    got = tree_leaves(port_abstract)
    assert len(ref) == len(got) == len(port_specs), what
    for i, ((shape, rspec), x, s) in enumerate(zip(ref, got, port_specs)):
        pspec = shd.resolve_pspec(s.logical, x.device_mesh, None, s.shape)
        assert tuple(pspec) == tuple(rspec), (what, i, s.logical)
        assert tuple(x.shape) == shape, (what, i)
        assert tuple(x.to_local().shape) == tuple(
            NamedSharding(am, rspec).shard_shape(shape)), (what, i, rspec)
        assert x.to_local().device.type == "meta"
        assert x.dtype == port_spec.torch_dtype(s.dtype)
        assert tuple(x.placements) == shd.placements(pspec, x.device_mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_shards_as_the_reference(meshes, arch, mesh_name):
    mesh = meshes[mesh_name]
    am = AbstractMesh(*MESHES[mesh_name])
    rcfg, tcfg = _production(RC, arch, False), _production(TC, arch, False)
    rps, tps = RM.build(rcfg).param_spec(), TM.build(tcfg).param_spec()
    _hold(_ref_leaves(rps), TM.abstract_tree(tps, mesh), tree_leaves(tps),
          am, "params")
    # the reference's own tree forms on its mesh agree leaf for leaf
    assert [tuple(p) for p in jax.tree.leaves(
        ref_spec.pspecs_tree(rps, am), is_leaf=lambda x: isinstance(x, P))
    ] == [tuple(p) for p in tree_leaves(
        port_spec.pspecs_tree(tps, mesh),
        is_leaf=lambda x: isinstance(x, shd.PartitionSpec))]

    ros = ref_adamw.state_spec(rps, _opt_cfg(ref_adamw, rcfg))
    tos = adamw.state_spec(tps, _opt_cfg(adamw, tcfg))
    _hold(_ref_leaves(ros), TM.abstract_tree(tos, mesh), tree_leaves(tos),
          am, "adamw")

    for shape in tcfg.applicable_shapes():
        serving = shape.kind != "train"
        rc, tc = _production(RC, arch, serving), _production(TC, arch,
                                                             serving)
        ref = jax.tree.leaves(RM.input_specs(
            rc, RC.base.SHAPES[shape.name], am))
        got = tree_leaves(TM.input_specs(tc, shape, mesh))
        assert len(ref) == len(got), shape.name
        for r, g in zip(ref, got):
            assert tuple(g.shape) == tuple(r.shape), shape.name
            assert tuple(g.to_local().shape) == tuple(
                r.sharding.shard_shape(r.shape)), (shape.name, r.sharding)
            assert g.dtype == port_spec.torch_dtype(str(r.dtype)) or (
                str(r.dtype) == "bool" and g.dtype == torch.bool)


def test_abstract_tree_without_a_mesh_takes_no_memory():
    tcfg = TC.get_config("recurrentgemma-9b")
    leaves = tree_leaves(TM.abstract_tree(TM.build(tcfg).param_spec()))
    assert all(x.device.type == "meta" for x in leaves)
    want = [tuple(s.shape) for s in _ref_leaves(
        RM.build(RC.get_config("recurrentgemma-9b")).param_spec())]
    assert [tuple(x.shape) for x in leaves] == want


def _layout_offsets_ref(rspec, am, shape):
    """{mesh linear index: shard offset} of XLA's tile assignment."""
    hlo = NamedSharding(am, rspec)._to_xla_hlo_sharding(len(shape))
    dims = hlo.tile_assignment_dimensions()
    devs = hlo.tile_assignment_devices()
    local = NamedSharding(am, rspec).shard_shape(shape)
    out = {}
    for pos, d in enumerate(devs):
        tile = np.unravel_index(pos, dims)[:len(shape)]
        out[int(d)] = tuple(int(t) * n for t, n in zip(tile, local))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rule", sorted(
    k for k, v in shd.DEFAULT_RULES.items() if v is not None))
def test_multi_axis_dims_keep_xlas_major_to_minor_layout(meshes, mesh_name,
                                                         rule):
    """Every rank's shard starts where XLA's tile assignment puts that
    device's shard (a dim over ("pod", "data") splits pod-major)."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    mesh = meshes[mesh_name]
    am = AbstractMesh(*MESHES[mesh_name])
    shape = (1024, 4)
    pspec = shd.resolve_pspec((rule, None), mesh, None, shape)
    rspec = ref_shd.resolve_pspec((rule, None), am, None, shape)
    assert tuple(pspec) == tuple(rspec)
    want = _layout_offsets_ref(rspec, am, shape)
    place = shd.placements(pspec, mesh)
    mshape = tuple(mesh.shape)
    for d in range(mesh.size()):
        coord = [int(c) for c in np.unravel_index(d, mshape)]
        local, off = _compute_local_shape_and_global_offset(
            shape, mshape, coord, place)
        assert tuple(off) == want[d], (rule, d, coord)
        assert tuple(local) == NamedSharding(am, rspec).shard_shape(shape)


def test_placements_refuse_a_spec_out_of_mesh_order(meshes):
    m = meshes["pod2x16x16"]
    with pytest.raises(ValueError, match="order"):
        shd.placements(shd.PartitionSpec(("data", "pod")), m)
    from torch.distributed.tensor import Shard
    assert shd.placements(shd.PartitionSpec(("pod", "data"), None, "model"),
                          m) == (Shard(0), Shard(0), Shard(2))


LOGICAL = sorted(shd.DEFAULT_RULES) + ["unknown"]
AXES = ("pod", "data", "model")


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.lists(st.sampled_from(LOGICAL + [None]), min_size=1, max_size=4),
       st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 48, 96, 256,
                                 1000]), min_size=4, max_size=4),
       st.lists(st.sampled_from([1, 2, 3, 4, 8, 16]), min_size=1,
                max_size=3),
       st.booleans())
def test_resolve_pspec_matches_reference(logical, dims, mesh_dims,
                                         with_shape):
    """Random logical names, shapes and meshes: the same spec, as a mesh
    mapping on the port's side."""
    names = AXES[-len(mesh_dims):]
    am = AbstractMesh(tuple(mesh_dims), names)
    shape = tuple(dims[:len(logical)]) if with_shape else None
    ref = ref_shd.resolve_pspec(tuple(logical), am, None, shape)
    got = shd.resolve_pspec(tuple(logical), dict(zip(names, mesh_dims)),
                            None, shape)
    assert tuple(got) == tuple(ref)
    assert isinstance(got, shd.PartitionSpec)
    if shape is not None:
        assert shd.shard_shape(got, dict(zip(names, mesh_dims)), shape) == \
            tuple(NamedSharding(am, ref).shard_shape(shape))


def test_test_mesh_and_its_refusals(world):
    m = make_test_mesh(8, device="cpu")
    assert tuple(m.shape) == (2, 4) and m.mesh_dim_names == ("data",
                                                             "model")
    m3 = make_test_mesh(8, multi_pod=True, device="cpu")
    assert tuple(m3.shape) == (2, 2, 2)
    assert tuple(make_test_mesh(device="cpu").shape) == (16, 32)
    with pytest.raises(RuntimeError, match="world size of 512.*fake"):
        make_test_mesh(1024, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_test_mesh(4)


def test_active_mesh_constrain_and_can_shard(meshes):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    m = meshes["pod16x16"]
    x = torch.ones(32, 8)
    assert shd.active_mesh() is None and not shd.can_shard(32, "batch")
    assert shd.constrain(x, ("batch", None)) is x
    with shd.use_mesh(m) as got:
        assert got is m and shd.active_mesh() is m
        assert shd.active_rules() is shd.DEFAULT_RULES
        assert shd.can_shard(32, "batch") and not shd.can_shard(8, "batch")
        assert not shd.can_shard(32, "seq")
        assert shd.constrain(x, ("batch", None)) is x
        d = distribute_tensor(torch.empty(32, 32, device="meta"), m,
                              [Replicate(), Replicate()])
        c = shd.constrain(d, ("batch", "heads"))
        assert tuple(c.placements) == (Shard(0), Shard(1))
        assert tuple(c.to_local().shape) == (2, 2)
    assert shd.active_mesh() is None
    sh = shd.named_sharding(("batch", "embed"), m, None, (64, 48))
    assert tuple(sh.spec) == ("data",)
    assert sh.shard_shape((64, 48)) == (4, 48)
    tree = {"a": TM.ParamSpec((64, 48), ("batch", "mlp"))}
    assert tuple(shd.tree_pspecs(tree, m)["a"]) == ("data", "model")
    assert shd.tree_shardings(tree, m)["a"].shard_shape((64, 48)) == (4, 3)
