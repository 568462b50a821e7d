"""Configs, parameter trees and the arch scenarios: the port against the
reference.

The ten configs field for field, ``reduced``, the exact and analytic
parameter counts, the parameter and cache trees leaf for leaf (shape,
dtype, logical axes, init rule), ``init_tree`` statistically per rule (the
draws come from a ``torch.Generator``, not a ``jax.random`` key), the
arch scenarios and grids and ``table_arch_periods`` within the sweep
tests' tolerances, and the new entry points' ``device="cuda"`` default.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.sim as RS
from repro.models import build as ref_build
from repro.models import spec as ref_spec
from repro.models import transformer as ref_tfm

import repro_torch.configs as TC
import repro_torch.sim as TS
from repro_torch import interop
from repro_torch.ckpt.tree import tree_flatten, tree_leaves
from repro_torch.data import synthetic
from repro_torch.ft import ElasticPlan, build_mesh
from repro_torch.launch import make_production_mesh, make_test_mesh
from repro_torch.models import build, spec
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, grad_compress

ARCHS = [c.name for c in RC.ALL_ARCHS]
CPU = "cpu"


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


def _ref_specs(tree):
    return jax.tree.leaves(tree, is_leaf=ref_spec.is_spec)


def _same_leaves(ref_tree, port_tree):
    a, b = _ref_specs(ref_tree), tree_leaves(port_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (tuple(x.shape), tuple(x.logical), x.dtype, x.init,
                x.fan_axis) == (tuple(y.shape), tuple(y.logical), y.dtype,
                                y.init, y.fan_axis)


def test_registry_and_shapes_match_reference():
    assert TC.list_configs() == RC.list_configs()
    assert [c.name for c in TC.ALL_ARCHS] == ARCHS
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("no-such-arch")
    with pytest.raises(ValueError, match="duplicate"):
        TC.register(TC.get_config("xlstm-125m"))


@pytest.mark.parametrize("name", ARCHS)
def test_config_field_for_field(name):
    a, b = RC.get_config(name), TC.get_config(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(RC.reduced(a)) == \
        dataclasses.asdict(TC.reduced(b))
    for fn in ("padded_vocab", "param_count", "active_param_count",
               "checkpoint_bytes", "layer_kinds", "supports_long_context"):
        assert getattr(a, fn)() == getattr(b, fn)(), fn
    assert [s.name for s in a.applicable_shapes()] == \
        [s.name for s in b.applicable_shapes()]
    assert (a.resolved_head_dim, a.q_groups) == (b.resolved_head_dim,
                                                 b.q_groups)


@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_exact(name):
    a, b = RC.get_config(name), TC.get_config(name)
    assert build(b).param_count() == ref_build(a).param_count()
    assert b.param_count() == a.param_count()
    r = TC.reduced(b)
    assert build(r).param_count() == ref_build(RC.reduced(a)).param_count()


def test_xlstm_125m_counts():
    cfg = TC.get_config("xlstm-125m")
    assert build(cfg).param_count() == 173_090_352
    assert len(tree_leaves(build(cfg).param_spec())) == 22
    assert cfg.param_count() == 183_678_720


@pytest.mark.parametrize("name", ARCHS)
def test_model_and_cache_specs_leaf_for_leaf(name):
    for a, b in ((RC.get_config(name), TC.get_config(name)),
                 (RC.reduced(RC.get_config(name)),
                  TC.reduced(TC.get_config(name)))):
        _same_leaves(ref_tfm.model_spec(a), tfm.model_spec(b))
        _same_leaves(ref_tfm.cache_spec(a, 2, 64), tfm.cache_spec(b, 2, 64))
        assert tfm.super_block(b) == ref_tfm.super_block(a)


def test_batch_spec_matches_reference():
    from repro.models import batch_spec as ref_batch_spec
    from repro_torch.models import batch_spec
    for name in ARCHS:
        for shape in RC.get_config(name).applicable_shapes():
            _same_leaves(ref_batch_spec(RC.get_config(name), shape),
                         batch_spec(TC.get_config(name),
                                    TC.SHAPES[shape.name]))


def test_decode_input_spec_matches_reference():
    from repro.models import decode_input_spec as ref_spec
    from repro_torch.models import decode_input_spec
    for name in ARCHS:
        for shape in RC.get_config(name).applicable_shapes():
            _same_leaves(ref_spec(RC.get_config(name), shape),
                         decode_input_spec(TC.get_config(name),
                                           TC.SHAPES[shape.name]))


# ---------------------------------------------------------------------------
# init_tree, per rule
# ---------------------------------------------------------------------------

#: one leaf per init rule, large enough for 1% statistics.
_RULES = {
    "zeros": spec.ParamSpec((64, 96), (None, None), init="zeros"),
    "ones": spec.ParamSpec((64, 96), (None, None), init="ones"),
    "normal": spec.ParamSpec((256, 512), (None, None), init="normal"),
    "lambda_lru": spec.ParamSpec((131072,), (None,), init="lambda_lru"),
    "fan_in": spec.ParamSpec((4, 256, 512), (None, None, None)),
    "fan_in_bf16": spec.ParamSpec((256, 512), (None, None), "bfloat16"),
}


def _ref_rules():
    return {k: ref_spec.ParamSpec(s.shape, s.logical, s.dtype, s.init,
                                  s.fan_axis) for k, s in _RULES.items()}


def test_init_tree_per_rule_statistically_as_reference():
    got = spec.init_tree(_RULES, torch.Generator().manual_seed(0),
                         device=CPU)
    ref = jax.device_get(ref_spec.init_tree(_ref_rules(), jax.random.key(0)))
    for k, s in _RULES.items():
        g = got[k].float().numpy().astype(np.float64)
        r = np.asarray(ref[k], dtype=np.float64)
        assert got[k].dtype == getattr(torch, s.dtype)
        assert g.shape == r.shape == s.shape
        if s.init in ("zeros", "ones"):
            assert (g == r).all()
            continue
        n = g.size
        # means within 5 standard errors of the reference's, spreads within
        # 3% (a standard deviation's sampling error is ~1/sqrt(2n) = 0.1%)
        sd = r.std()
        assert abs(g.mean() - r.mean()) <= 5 * sd * math.sqrt(2.0 / n), k
        assert abs(g.std() / sd - 1.0) <= 0.03, k
        assert abs(g.min() - r.min()) <= 0.05 * (r.max() - r.min()), k
        assert abs(g.max() - r.max()) <= 0.05 * (r.max() - r.min()), k
    fan = 1.0 / math.sqrt(256)
    w = got["fan_in"].numpy()
    assert np.abs(w).max() <= 2.0 * fan                  # truncated at 2 sd
    # a normal truncated to [-2, 2] has sd 0.8796
    assert abs(w.std() / fan - 0.8796) <= 0.01
    assert abs(got["normal"].numpy().std() / 0.02 - 1.0) <= 0.01
    u = np.exp(-8.0 * np.log1p(np.exp(got["lambda_lru"].numpy()
                                      .astype(np.float64))))
    assert u.min() >= 0.9 - 1e-6 and u.max() <= 0.999 + 1e-6


def test_model_init_shapes_and_determinism():
    m = build(TC.reduced(TC.get_config("xlstm-125m")))
    a = m.init(torch.Generator().manual_seed(1), device=CPU)
    b = m.init(torch.Generator().manual_seed(1), device=CPU)
    for x, y, s in zip(tree_leaves(a), tree_leaves(b),
                       tree_leaves(m.param_spec())):
        assert tuple(x.shape) == s.shape and x.dtype == torch.float32
        assert torch.equal(x, y)


def test_params_from_numpy_checks_the_tree():
    cfg = TC.reduced(TC.get_config("xlstm-125m"))
    rp = jax.device_get(ref_build(RC.reduced(RC.get_config("xlstm-125m")))
                        .init(jax.random.key(0)))
    got = interop.params_from_numpy(rp, cfg, device=CPU)
    for x, y in zip(jax.tree.leaves(rp), tree_leaves(got)):
        assert np.array_equal(np.asarray(x), y.numpy())
    bad = dict(rp, embed=rp["embed"][:, :8])
    with pytest.raises(ValueError, match="leaf"):
        interop.params_from_numpy(bad, cfg, device=CPU)
    with pytest.raises(ValueError, match="parameter tree"):
        interop.params_from_numpy({"embed": rp["embed"]}, cfg, device=CPU)


# ---------------------------------------------------------------------------
# arch scenarios and the architecture table
# ---------------------------------------------------------------------------

def test_scenario_registry_has_the_arch_scenarios():
    assert set(TS.list_scenarios()) == set(RS.list_scenarios())


@pytest.mark.parametrize("name", ARCHS)
def test_arch_scenarios_match_reference(name):
    for kind, kw in (("arch", {}), ("arch", dict(profile="tpu")),
                     ("multilevel_arch", {})):
        a = RS.get_scenario(kind, arch=name, **kw)
        b = TS.get_scenario(kind, arch=name, **kw)
        assert a.name == b.name and a.description == b.description
        fa, fb = dataclasses.asdict(a.ckpt), dataclasses.asdict(b.ckpt)
        assert fa.keys() == fb.keys()
        for k in fa:
            if fa[k] is None:
                assert fb[k] is None
            else:
                assert _rel(fb[k], fa[k]) <= 1e-15, k
        assert dataclasses.asdict(a.power) == dataclasses.asdict(b.power)


def test_arch_grids_match_reference():
    g1, g2 = RS.arch_grid(), TS.arch_grid(device=CPU)
    for f, v in g1.fields().items():
        assert _rel(getattr(g2, f).numpy(), v).max() <= 1e-15, f
    ref = RS.evaluate_grid(g1)
    got = TS.evaluate_grid(g2, device=CPU)
    for f in ("T_time", "T_energy"):
        assert _rel(getattr(got, f).numpy(), getattr(ref, f)).max() <= 1e-8
    for f in ("energy_ratio", "time_ratio"):
        assert _rel(getattr(got, f).numpy(), getattr(ref, f)).max() <= 1e-10
    m1 = RS.multilevel_arch_grid(["xlstm-125m", "dbrx-132b"], q=0.1)
    m2 = TS.multilevel_arch_grid(["xlstm-125m", "dbrx-132b"], device=CPU,
                                 q=0.1)
    for f, v in m1.fields().items():
        assert _rel(getattr(m2, f).numpy(), v).max() <= 1e-15, f


def test_table_arch_periods_matches_reference(tmp_path, monkeypatch):
    import benchmarks.table_arch_periods as ref_tap
    from repro_torch.benchmarks import _util, table_arch_periods
    monkeypatch.setattr(ref_tap, "RESULTS", tmp_path / "ref")
    (tmp_path / "ref").mkdir()
    monkeypatch.setattr(_util, "RESULTS", tmp_path / "port")
    ref_out, ref_big = ref_tap.run()
    out, big, rows = table_arch_periods.run(device=CPU)
    assert out.read_bytes() == ref_out.read_bytes()
    assert big[0] == ref_big[0] == "dbrx-132b"
    for a, b in zip(big[1:], ref_big[1:]):
        assert _rel(a, b) <= 1e-8
    assert [r[0] for r in rows] == ARCHS


@pytest.mark.parametrize("call", [
    lambda: build(TC.reduced(TC.get_config("xlstm-125m"))).init(
        torch.Generator()),
    lambda: synthetic.for_arch(TC.get_config("xlstm-125m"), 1, 8).peek(),
    lambda: adamw.init_state({"w": torch.zeros(2, 2)}),
    lambda: grad_compress.init_state({"w": torch.zeros(2, 2)}),
    lambda: interop.params_from_numpy({}, TC.get_config("xlstm-125m")),
    lambda: interop.opt_state_from_numpy(adamw.AdamWState(0, {}, {}, None)),
    lambda: TS.arch_grid(),
    lambda: TS.multilevel_arch_grid(),
    lambda: make_test_mesh(1),
    lambda: make_production_mesh(),
    lambda: build_mesh(ElasticPlan({"data": 1}, {"data": 1}, 0,
                                   "keep_global")),
    lambda: TS.effective_devices(),
], ids=["Model.init", "SyntheticLM.peek", "adamw.init_state",
        "grad_compress.init_state", "params_from_numpy",
        "opt_state_from_numpy", "arch_grid", "multilevel_arch_grid",
        "make_test_mesh", "make_production_mesh", "build_mesh",
        "effective_devices"])
def test_new_entry_points_default_to_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        call()
