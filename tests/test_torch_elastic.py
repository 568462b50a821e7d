"""Elastic re-planning (``repro_torch.ft.elastic``) against the reference,
and the restore-and-continue on a one-rank mesh, on the CPU.

``plan_reshard`` must give the reference's plan on the production meshes
(the reference's on ``jax.sharding.AbstractMesh``, the port's on a
``DeviceMesh`` of a 512-rank ``fake`` process group), ``build_mesh`` the
plan's mesh, and ``reshard_tree`` every leaf's local shard of the
reference's ``NamedSharding`` on the shrunk 15x16 mesh.  Then
``chip_smoke.py`` phase 17 rehearses here at reduced sizes: on a world-1
``gloo`` group, xLSTM trains, checkpoints, re-plans, restores, reshards
and trains on, bitwise the run that never stopped.
"""
import dataclasses
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

import repro.configs as RC
import repro.ft.elastic as RE
import repro.models as RM
from repro.models import spec as ref_spec
from repro.parallel import sharding as ref_shd

import repro_torch.configs as TC
import repro_torch.models as TM
from repro_torch.ckpt.tree import tree_leaves
from repro_torch.ft import (ElasticPlan, build_mesh, plan_reshard,
                            reshard_tree)
from repro_torch.launch import make_production_mesh

ARCHS = [c.name for c in RC.ALL_ARCHS]
ROOT = Path(__file__).resolve().parents[1]
PLANS = [(False, 0, 4), (False, 1, 4), (False, 2, 4), (False, 63, 4),
         (False, 63, 1), (False, 3, 8), (True, 0, 4), (True, 5, 4),
         (True, 120, 4), (True, 127, 4)]


@pytest.fixture(scope="class")
def world():
    """A fake process group of 512 ranks for the class."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield 512
    dist.destroy_process_group()


def _abstract(multi_pod: bool):
    return AbstractMesh((2, 16, 16) if multi_pod else (16, 16),
                        ("pod", "data", "model") if multi_pod
                        else ("data", "model"))


@pytest.mark.usefixtures("world")
class TestOnProductionMeshes:
    @pytest.mark.parametrize("multi_pod,lost,per_host", PLANS,
                             ids=[f"{'pod2x16x16' if m else 'pod16x16'}"
                                  f"-lost{n}x{h}" for m, n, h in PLANS])
    def test_plan_matches_reference(self, multi_pod, lost, per_host):
        """The reference's plan, or its refusal (16x16 losing 63 hosts of
        4 leaves 4 devices, 2x16x16 losing 127 leaves 4: no replica)."""
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        for policy in ("keep_global", "shrink"):
            try:
                ref = RE.plan_reshard(_abstract(multi_pod), lost, per_host,
                                      policy)
            except RuntimeError as e:
                with pytest.raises(RuntimeError, match=str(e)):
                    plan_reshard(mesh, lost, per_host, policy)
                assert (lost, per_host) in ((63, 4), (127, 4))
                return
            got = plan_reshard(mesh, lost, per_host, policy)
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)
            assert list(got.new_shape) == list(ref.new_shape)
        new = build_mesh(got, device="cpu")
        assert new.mesh_dim_names == tuple(ref.new_shape)
        assert tuple(new.shape) == tuple(ref.new_shape.values())

    @pytest.mark.parametrize("multi_pod,lost", [(False, 64), (True, 128)])
    def test_no_surviving_replica_raises(self, multi_pod, lost):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        with pytest.raises(RuntimeError, match="one data replica") as ref:
            RE.plan_reshard(_abstract(multi_pod), lost)
        with pytest.raises(RuntimeError, match="one data replica") as got:
            plan_reshard(mesh, lost)
        assert str(got.value) == str(ref.value)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_reshard_tree_shards_as_the_reference_on_15x16(self, arch):
        plan = plan_reshard(make_production_mesh(device="cpu"), 4)
        assert plan.new_shape == {"data": 15, "model": 16}
        mesh = build_mesh(plan, device="cpu")
        am = AbstractMesh((15, 16), ("data", "model"))
        tps = TM.build(TC.get_config(arch)).param_spec()
        rps = RM.build(RC.get_config(arch)).param_spec()
        got = tree_leaves(reshard_tree(TM.abstract_tree(tps), tps, mesh))
        ref = jax.tree.leaves(rps, is_leaf=ref_spec.is_spec)
        assert len(got) == len(ref)
        for x, s in zip(got, ref):
            spec = ref_shd.resolve_pspec(s.logical, am, None, s.shape)
            assert tuple(x.shape) == tuple(s.shape)
            assert tuple(x.to_local().shape) == tuple(
                NamedSharding(am, spec).shard_shape(s.shape)), s.logical

    def test_reshard_tree_refuses_a_mismatched_tree(self):
        mesh = make_production_mesh(device="cpu")
        spec = {"w": TM.ParamSpec((32, 16), ("embed", "mlp"))}
        with pytest.raises(ValueError, match="spec"):
            reshard_tree({"w": torch.zeros(16, 32)}, spec, mesh)
        with pytest.raises(ValueError, match="specs"):
            reshard_tree({"w": torch.zeros(32, 16), "b": torch.zeros(2)},
                         spec, mesh)


def test_build_mesh_needs_a_group_and_a_gpu_by_default():
    plan = ElasticPlan(old_shape={"data": 2, "model": 1},
                       new_shape={"data": 1, "model": 1}, lost_hosts=1,
                       batch_policy="keep_global")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="world size of 0"):
        build_mesh(plan, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_mesh(plan)


def test_chip_smoke_mesh_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_mesh`` end to end on the CPU at reduced sizes:
    the split over (cpu, cpu) bitwise the unsplit calls, and the elastic
    restore-and-continue on a world-1 gloo mesh bitwise the uninterrupted
    run (raw checkpoint) and the run through the int8 round trip (int8
    checkpoint), which is not the uninterrupted run."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    rep = chip_smoke.phase_mesh(torch.device("cpu"), "cpu", rehearse=True,
                                root=tmp_path / "elastic")
    assert not dist.is_initialized()
    split = rep["split"]
    for key in ("mc", "sweep_f64", "sweep_compensated_f32", "ml_sweep_f64",
                "ml_sweep_compensated_f32"):
        assert split[key]["bitwise"], key
    el = rep["elastic"]
    assert el["plan"]["new"] == {"data": 1, "model": 1}
    assert el["restored_at"] == [el["k"], el["k"]]
    assert el["raw_equal"] and el["raw_losses_equal"]
    assert el["compressed_equal"] and el["compressed_losses_equal"]
    assert el["losses"]["raw"] == el["losses"]["uninterrupted"]
    assert el["compressed_vs_uninterrupted_params_frob"] > 0.0
    assert el["n_compressed_leaves"] > 0
    assert not (tmp_path / "elastic").exists()
