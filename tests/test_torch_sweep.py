"""The port's grid sweep, scenarios, dispatch and precision policy against
the JAX package, on the CPU.

Tolerances: periods 1e-8 relative (AlgoT/AlgoE are closed forms or
quadratic roots guarded by a golden-section search); the MSK period is a
golden-section argmin only, so it is held by its objective (1e-13) and by
the search's final bracket (40 iterations shrink the bracket by 0.618^40
~ 4.2e-9 of its span, and objective rounding in the flat valley decides
which sub-bracket survives); Tf, E and ratios 1e-10 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sim as RS
try:  # newer jax re-exports the x64 context at top level
    from jax import enable_x64
except ImportError:
    from jax.experimental import enable_x64
from repro.core import EXASCALE_POWER_RHO55, EXASCALE_POWER_RHO7

import repro_torch.sim as TS
from repro_torch import interop
from repro_torch.core import PowerParams
from repro_torch.sim import precision as tprec
from repro_torch.sim.sweep import _msk_energy, _msk_setup

CPU = "cpu"
PERIODS = ("T_time", "T_energy", "T_young", "T_daly")
VALUES = ("Tf_time", "Tf_energy", "E_time", "E_energy", "time_ratio",
          "energy_ratio")

GRIDS = {
    "mu_rho_9x6": lambda: RS.mu_rho_grid(np.linspace(30.0, 600.0, 9),
                                         np.linspace(1.0, 10.0, 6)),
    "nodes_1e8": lambda: RS.nodes_grid([1e4, 1e5, 1e6, 1e7, 1e8],
                                       EXASCALE_POWER_RHO55),
    "nodes_rho7": lambda: RS.nodes_grid([2e3, 4e5, 3e6, 1e8],
                                        EXASCALE_POWER_RHO7),
}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


def _both(name):
    g = GRIDS[name]()
    return g, interop.grid_from_fields(g.fields(), device=CPU)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_evaluate_grid_matches_reference(name):
    g, tg = _both(name)
    ref = RS.evaluate_grid(g)
    got = TS.evaluate_grid(tg, device=CPU)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for f in PERIODS:
        assert _rel(getattr(got, f).numpy(), getattr(ref, f)).max() <= 1e-8, f
    for f in VALUES:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.nan_to_num(_rel(a, b)).max() <= 1e-10, f
    # MSK: golden-section argmin — objective and final-bracket checks.
    p = {k: torch.as_tensor(np.asarray(v, dtype=np.float64).ravel())
         for k, v in g.fields().items()}
    p0, lo, hi, _ = _msk_setup(p)
    Tm_ref = torch.as_tensor(np.asarray(ref.T_msk).ravel())
    Tm = got.T_msk.reshape(-1)
    v = torch.as_tensor(valid.ravel())
    e_ref = _msk_energy(Tm_ref, p0)[v]
    e_got = _msk_energy(Tm, p0)[v]
    assert float(((e_got - e_ref).abs() / e_ref.abs()).max()) <= 1e-13
    bracket = 0.618034 ** 40 * (hi - lo)
    assert bool(((Tm - Tm_ref).abs() <= 4 * bracket)[v].all())


def test_degenerate_points_are_exact():
    g, tg = _both("nodes_1e8")
    got = TS.evaluate_grid(tg, device=CPU)
    bad = ~got.valid
    assert bool(bad.any()), "1e8 nodes must be degenerate"
    assert bool((got.time_ratio[bad] == 1.0).all())
    assert bool((got.energy_ratio[bad] == 1.0).all())
    for f in ("Tf_time", "Tf_energy", "E_time", "E_energy"):
        assert bool(torch.isnan(getattr(got, f)[bad]).all())
    assert torch.equal(got.T_time[bad], tg.C[bad])
    assert torch.equal(got.T_energy[bad], tg.C[bad])


@pytest.mark.parametrize("name", ["mu_rho_9x6", "nodes_rho7"])
def test_compensated_policy_gates(name):
    """compensated_f32 against the port's f64 oracle at the policy's
    documented tolerances: the f32 period's objective, re-evaluated in f64,
    within objective_tol; the period within argmin_rtol."""
    _, tg = _both(name)
    pol = TS.COMPENSATED_F32
    r64 = TS.evaluate_grid(tg, precision="f64", device=CPU)
    r32 = TS.evaluate_grid(tg, precision=pol, device=CPU)
    assert r32.T_time.dtype == torch.float64
    assert torch.equal(r64.valid, r32.valid)
    v = r64.valid.reshape(-1)
    p = {k: x.reshape(-1)[v] for k, x in tg.fields().items()}
    for f, obj in (("T_time", TS.time_final_batched),
                   ("T_energy", TS.energy_final_batched)):
        T64 = getattr(r64, f).reshape(-1)[v]
        T32 = getattr(r32, f).reshape(-1)[v]
        assert float(((T32 - T64).abs() / T64).max()) <= pol.argmin_rtol
        o32, o64 = obj(T32, p), obj(T64, p)
        assert float(((o32 - o64).abs() / o64).max()) <= pol.objective_tol


def test_chunking_is_a_bitwise_noop():
    _, tg = _both("mu_rho_9x6")
    a = TS.evaluate_grid(tg, device=CPU)
    b = TS.evaluate_grid(tg, dispatch=TS.DispatchConfig(chunk=7), device=CPU)
    c = TS.evaluate_grid(tg, dispatch=TS.DispatchConfig(memory_mb=1),
                         device=CPU)
    for f in PERIODS + VALUES + ("T_msk", "valid"):
        for other in (b, c):
            assert torch.equal(getattr(a, f).nan_to_num(-1.0),
                               getattr(other, f).nan_to_num(-1.0)), f


def test_batched_solvers_match_reference():
    g, tg = _both("mu_rho_9x6")
    pr = {k: np.asarray(v).ravel() for k, v in g.fields().items()}
    pt = {k: v.reshape(-1) for k, v in tg.fields().items()}
    with enable_x64():
        ref = {n: np.asarray(getattr(RS, n)(pr)) for n in (
            "t_opt_time_batched", "t_opt_energy_batched",
            "t_young_batched", "t_daly_batched")}
        T = ref["t_opt_time_batched"]
        ref_tf = np.asarray(RS.time_final_batched(T, pr, 2.0))
        ref_e = np.asarray(RS.energy_final_batched(T, pr, 2.0))
    for n, want in ref.items():
        got = getattr(TS, n)(pt).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.nan_to_num(_rel(got, want)).max() <= 1e-8, n
    Tt = torch.tensor(T)
    assert np.nan_to_num(_rel(TS.time_final_batched(Tt, pt, 2.0).numpy(),
                              ref_tf)).max() <= 1e-13
    assert np.nan_to_num(_rel(TS.energy_final_batched(Tt, pt, 2.0).numpy(),
                              ref_e)).max() <= 1e-13
    # MSK batched: same objective at both argmins
    p0, *_ = _msk_setup(pt)
    with enable_x64():
        Tm_ref = np.asarray(RS.t_msk_energy_batched(pr))
    Tm = TS.t_msk_energy_batched(pt)
    ok = ~torch.isnan(Tm)
    e1 = _msk_energy(Tm, p0)[ok]
    e2 = _msk_energy(torch.as_tensor(Tm_ref), p0)[ok]
    assert float(((e1 - e2).abs() / e2).max()) <= 1e-13


def test_golden_section_batched_minimizes():
    lo = torch.tensor([0.0, -3.0, 1.0], dtype=torch.float64)
    hi = torch.tensor([10.0, 3.0, 2.0], dtype=torch.float64)
    target = torch.tensor([2.5, -1.0, 1.75], dtype=torch.float64)
    t = TS.golden_section_batched(lambda x: (x - target) ** 2, lo, hi)
    assert float((t - target).abs().max()) <= 1e-7


@pytest.mark.parametrize("fig", ["rho", "mu_rho", "nodes"])
def test_figure_conveniences(fig):
    if fig == "rho":
        ref = RS.sweep_rho_grid([1.0, 3.0, 7.0], 300.0)
        got = TS.sweep_rho_grid([1.0, 3.0, 7.0], 300.0, device=CPU)
    elif fig == "mu_rho":
        ref = RS.sweep_mu_rho_grid([120.0, 600.0], [2.0, 5.5])
        got = TS.sweep_mu_rho_grid([120.0, 600.0], [2.0, 5.5], device=CPU)
    else:
        pw = PowerParams(**dataclasses.asdict(EXASCALE_POWER_RHO55))
        ref = RS.sweep_nodes_grid([1e5, 1e6], EXASCALE_POWER_RHO55)
        got = TS.sweep_nodes_grid([1e5, 1e6], pw, device=CPU)
    assert got.T_time.shape == tuple(np.shape(ref.T_time))
    assert _rel(got.T_energy.numpy(), ref.T_energy).max() <= 1e-8
    assert _rel(got.energy_ratio.numpy(), ref.energy_ratio).max() <= 1e-10
    assert got.energy_saving.shape == got.time_overhead.shape


class TestScenarios:
    def test_registry_matches_reference(self):
        names = set(TS.list_scenarios())
        assert names == set(RS.list_scenarios())
        assert {"arch", "multilevel_arch"} <= names
        for name, kw in (("fig12", dict(mu_min=120.0, rho=7.0)),
                         ("fig3", dict(n_nodes=2e5)),
                         ("exascale_rho55", {}), ("exascale_rho7", {}),
                         ("jaguar", dict(n_nodes=1000))):
            a, b = RS.get_scenario(name, **kw), TS.get_scenario(name, **kw)
            assert a.name == b.name
            assert dataclasses.asdict(a.ckpt) == dataclasses.asdict(b.ckpt)
            assert dataclasses.asdict(a.power) == dataclasses.asdict(b.power)
        with pytest.raises(KeyError, match="unknown scenario"):
            TS.get_scenario("nope")

    @pytest.mark.parametrize("proc", ["weibull", "lognormal", "trace",
                                      "exponential"])
    def test_robustness_scenarios(self, proc):
        kw = dict(process=proc, trace=[3.0, 5.0] if proc == "trace" else None)
        a, b = RS.get_scenario("robustness", **kw), \
            TS.get_scenario("robustness", **kw)
        assert a.name == b.name and b.process.name == a.process.name

    def test_grids_match_reference_fields(self):
        pairs = [
            (RS.mu_rho_grid([60.0, 300.0], [1.0, 5.5, 7.0], alpha=2.0),
             TS.mu_rho_grid([60.0, 300.0], [1.0, 5.5, 7.0], alpha=2.0,
                            device=CPU)),
            (RS.grid_from_scenarios([RS.get_scenario("fig3"),
                                     RS.get_scenario("jaguar")]),
             TS.grid_from_scenarios([TS.get_scenario("fig3"),
                                     TS.get_scenario("jaguar")],
                                    device=CPU)),
            (RS.robustness_grid([0.5, 0.7], [120.0, 300.0, 600.0])[0],
             TS.robustness_grid([0.5, 0.7], [120.0, 300.0, 600.0],
                                device=CPU)[0]),
        ]
        for g, tg in pairs:
            assert tg.shape == g.shape
            for f, v in g.fields().items():
                np.testing.assert_array_equal(getattr(tg, f).numpy(), v)
            np.testing.assert_array_equal(tg.valid().numpy(), g.valid())
            np.testing.assert_array_equal(tg.rho.numpy(), g.rho)
            idx = (0,) * len(g.shape)
            assert tg.ckpt_at(idx) == type(tg.ckpt_at(idx))(
                **dataclasses.asdict(g.ckpt_at(idx)))
        _, proc = TS.robustness_grid([0.5, 0.7], [120.0, 300.0], device=CPU)
        np.testing.assert_array_equal(np.asarray(proc.shape),
                                      [[0.5, 0.5], [0.7, 0.7]])

    def test_grid_plumbing(self):
        tg = TS.mu_rho_grid([60.0, 300.0, 600.0], [1.0, 5.5], device=CPU)
        assert tg.size == 6 and tg.ravel().shape == (6,)
        assert tg.reshape((2, 3)).shape == (2, 3)
        sub = tg.take(torch.tensor([5, 0]))
        assert sub.mu.tolist() == [600.0, 60.0]
        assert tg.to(CPU).device.type == "cpu"


class TestPrecision:
    def test_comp_add_recovers_cancellation(self):
        big = torch.tensor(1e8, dtype=torch.float32)
        one = torch.tensor(1.0, dtype=torch.float32)
        terms = [big, one, -big, one]
        naive = terms[0]
        for t in terms[1:]:
            naive = naive + t
        assert float(naive) != 2.0
        assert float(tprec.compensated_sum(terms)) == 2.0
        s, c = tprec.comp_add(big, torch.zeros((), dtype=torch.float32), one)
        assert float(s) == 1e8 and float(c) == 1.0
        s, err = tprec.two_sum(1.0, 1e-20)
        assert s == 1.0 and err == 1e-20

    def test_psum_follows_the_active_policy(self):
        terms = [torch.tensor(v, dtype=torch.float32)
                 for v in (1e8, 1.0, -1e8, 1.0)]
        assert float(tprec.psum(terms)) != 2.0
        with tprec.use_policy(tprec.COMPENSATED_F32):
            assert tprec.active_policy() is tprec.COMPENSATED_F32
            assert float(tprec.psum(terms)) == 2.0
        assert tprec.active_policy() is tprec.F64

    def test_policies_match_reference_tolerances(self):
        from repro.sim import precision as rprec
        for name, pol in tprec.POLICIES.items():
            ref = rprec.POLICIES[name]
            assert (pol.dtype, pol.compensated, pol.objective_tol,
                    pol.argmin_rtol) == (ref.dtype, ref.compensated,
                                         ref.objective_tol, ref.argmin_rtol)
        assert tprec.F64.exact and not tprec.COMPENSATED_F32.exact
        assert tprec.COMPENSATED_F32.torch_dtype is torch.float32

    def test_resolution_order(self, monkeypatch):
        monkeypatch.delenv("REPRO_PRECISION", raising=False)
        F64, C32 = TS.F64, TS.COMPENSATED_F32
        # device defaults: f64 on the CPU, compensated f32 on CUDA
        assert TS.resolve_precision(device="cpu") is F64
        assert TS.resolve_precision(device="cuda") is C32
        cfg = TS.DispatchConfig(precision=F64)
        # explicit argument beats everything
        assert TS.resolve_precision(cfg, C32, device="cpu") is C32
        monkeypatch.setenv("REPRO_PRECISION", "compensated_f32")
        # config beats the environment
        assert TS.resolve_precision(cfg, device="cpu") is F64
        # environment beats the device default
        assert TS.resolve_precision(device="cpu") is C32
        # bad environment value: warn + fall through to the device default
        monkeypatch.setenv("REPRO_PRECISION", "float8")
        with pytest.warns(RuntimeWarning, match="REPRO_PRECISION"):
            assert TS.resolve_precision(device="cpu") is F64

    def test_unknown_policy_raises(self):
        with pytest.raises(ValueError, match="float16"):
            tprec.resolve("float16")
        with pytest.raises(TypeError):
            tprec.resolve(3.14)


class TestDispatch:
    def test_chunk_plan_bounds_bytes(self):
        from repro_torch.sim.dispatch import chunk_plan, trial_chunk
        cfg = TS.DispatchConfig(memory_mb=1)
        plan = chunk_plan(10_000, 1024, cfg)
        assert plan[0] == (0, 1024) and plan[-1][1] == 10_000
        assert all(b - a <= 1024 for a, b in plan)
        assert chunk_plan(10, 8, TS.DispatchConfig(chunk=4)) == [
            (0, 4), (4, 8), (8, 10)]
        assert chunk_plan(0, 8) == []
        assert trial_chunk(100, 1 << 20, cfg) == 1
        assert trial_chunk(100, 8, cfg) == 100

    def test_environment_knobs(self, monkeypatch):
        from repro_torch.sim.dispatch import DEFAULT_MEMORY_BUDGET
        assert TS.DispatchConfig().budget() == DEFAULT_MEMORY_BUDGET
        monkeypatch.setenv("REPRO_SWEEP_MEMORY_MB", "64")
        monkeypatch.setenv("REPRO_SWEEP_CHUNK", "5")
        assert TS.DispatchConfig().budget() == 64 << 20
        assert TS.DispatchConfig(memory_mb=2).budget() == 2 << 20
        assert TS.chunk_plan(12, 8)[0] == (0, 5)
        monkeypatch.setenv("REPRO_SWEEP_CHUNK", "lots")
        with pytest.warns(RuntimeWarning, match="REPRO_SWEEP_CHUNK"):
            assert TS.DispatchConfig().chunk_size() is None


def test_nan_free_ratios_on_valid_points():
    _, tg = _both("mu_rho_9x6")
    got = TS.evaluate_grid(tg, device=CPU)
    v = got.valid
    assert bool(torch.isfinite(got.energy_ratio[v]).all())
    assert bool((got.time_ratio[v] >= 1.0 - 1e-12).all())
    assert bool((got.energy_ratio[v] >= 1.0 - 1e-12).all())
