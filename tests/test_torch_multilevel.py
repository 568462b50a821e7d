"""The multilevel (buddy + PFS) batched layer, port against reference:
``MultilevelParamGrid`` and its scenarios, the batched two-level model and
joint (T, m) grid solver, the trade-off sweep, and the two-level Monte
Carlo engine.

The port runs on the CPU on the same numpy inputs as the reference (grids
carried across by ``interop.ml_grid_from_fields``; where a function draws
its own schedule, the port gets ``np.random.default_rng(s)`` and the
reference ``seed=s``, which draw the same numbers).  Tolerances:

* grid fields and derived quantities bitwise;
* ``ml_*_batched`` (the reference's forms evaluated on numpy) within 1e-15
  relative;
* ``evaluate_multilevel_grid`` in f64 within 1e-13 relative, with the same
  m picks and the same valid and NaN positions (the reference's jitted
  program contracts ``a + b * c`` into FMAs and rewrites some divisions,
  the port computes every operation on its own, as on the card); on random
  platforms the AlgoE periods within 1e-12 (see the test);
* compensated f32 against the reference's f64 by the reference's own
  multilevel gate (``argmin_rtol`` periods, m flips of at most one notch,
  the f32 pick's f64 energy within 10 ``objective_tol``);
* the two-level scan bitwise, wherever the overlap factors make
  ``rate * t`` exact (the reference's FMA then rounds as the port's
  multiply and add); at omega1 = 0.2, omega2 = 0.8 within 1e-14 with
  counts and flags equal;
* the Monte-Carlo means within 2% of the closed forms where m T < mu (the
  reference's own gate).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sim as RS
from repro.core import (EXASCALE_ML_POWER, EXASCALE_POWER_RHO55,
                        CheckpointParams, MultilevelCheckpointParams,
                        MultilevelPowerParams, simulate_once)
from repro.core import tradeoff as RT
from repro.sim import sweep as RSW

import repro_torch.core as PC
import repro_torch.sim as TS
from repro_torch import interop
from repro_torch.sim import engine as TE
from repro_torch.sim import sweep as TSW
from repro_torch.sim.dispatch import DispatchConfig
from repro_torch.sim.precision import COMPENSATED_F32

CPU = "cpu"
M_VALUES = tuple(range(1, 9))
OUTS = ("T_time", "T_energy", "Tf_time", "Tf_energy", "E_time", "E_energy",
        "time_ratio", "energy_ratio", "time_vs_single", "energy_vs_single",
        "T_time_by_m", "Tf_by_m", "T_energy_by_m", "E_by_m")
EXACT = ("m_time", "m_energy", "valid", "valid_by_m")
ML_FIELDS = ("wall_time", "energy", "work_executed", "io1_time", "io2_time",
             "down_time", "n_failures", "n_hard_failures", "n_ckpt1",
             "n_ckpt2", "truncated", "gaps_exhausted")
ML_FLOATS = ML_FIELDS[:6]


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.nan_to_num(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _with_omegas(grid, w1, w2):
    """The reference grid with per-level overlap factors."""
    if w1 is None:
        return grid
    return RS.MultilevelParamGrid(**{**grid.fields(),
                                     "omega1": np.full(grid.shape, w1),
                                     "omega2": np.full(grid.shape, w2)})


def _random_grid(n, seed, shared=True):
    """``n`` random two-level platforms: costs over two decades, MTBFs
    60-3000 min, q in [0, 0.6], overlaps shared or drawn per level."""
    rng = np.random.default_rng(seed)
    C2 = rng.uniform(1.0, 20.0, n)
    w = rng.uniform(0.0, 1.0, n)
    f = dict(C1=C2 * rng.uniform(0.01, 1.0, n), C2=C2,
             R1=rng.uniform(0.1, 10.0, n), R2=rng.uniform(1.0, 20.0, n),
             D1=rng.uniform(0.0, 2.0, n), D2=rng.uniform(0.0, 4.0, n),
             mu=rng.uniform(60.0, 3000.0, n), omega=w,
             q=rng.uniform(0.0, 0.6, n), P_static=rng.uniform(2.0, 20.0, n),
             P_cal=rng.uniform(2.0, 20.0, n), P_io1=rng.uniform(1.0, 50.0, n),
             P_io2=rng.uniform(10.0, 200.0, n),
             P_down=rng.uniform(0.0, 5.0, n))
    if not shared:
        f.update(omega1=rng.uniform(0.0, 1.0, n),
                 omega2=rng.uniform(0.0, 1.0, n))
    return RS.MultilevelParamGrid(**f)


def _port(grid):
    return interop.ml_grid_from_fields(grid.fields(), device=CPU)


def _degenerate_and_rescued():
    """A fig-4 point, a platform with no valid period at any m, and one
    only the buddy level makes feasible (no valid PFS-only period)."""
    bad = MultilevelCheckpointParams(C1=20.0, R1=20.0, C2=200.0, R2=200.0,
                                     D1=1, D2=1, mu=120.0, q=0.1, omega=0.5)
    rescued = MultilevelCheckpointParams(C1=5.0, R1=5.0, C2=100.0,
                                         R2=100.0, D1=0.5, D2=1.0, mu=120.0,
                                         q=0.1, omega=0.0)
    parts = [RS.multilevel_grid_from_scenarios(
        [RS.get_scenario("multilevel_exascale")])] + [
        RS.MultilevelParamGrid.from_params(c, EXASCALE_ML_POWER).reshape(
            (1,)) for c in (bad, rescued)]
    return RS.MultilevelParamGrid(
        **{f: np.concatenate([getattr(g, f) for g in parts])
           for f in parts[0].fields()})


GRIDS = {
    "fig4": lambda: RS.buddy_ratio_grid([0.02, 0.05, 0.1, 0.2, 0.4, 1.0],
                                        [0.01, 0.05, 0.1, 0.2, 0.4]),
    "random_shared": lambda: _random_grid(600, 1),
    "random_split": lambda: _random_grid(600, 2, shared=False),
    "degenerate_rescued": _degenerate_and_rescued,
}


@pytest.fixture(scope="module")
def solved():
    """{name: (reference grid, reference result, port result)} at m 1..8."""
    out = {}
    for name, make in GRIDS.items():
        g = make()
        out[name] = (g, RS.evaluate_multilevel_grid(g, m_values=M_VALUES),
                     TS.evaluate_multilevel_grid(_port(g), m_values=M_VALUES,
                                                 device=CPU))
    return out


# ---------------------------------------------------------------------------
# Scenarios and grids
# ---------------------------------------------------------------------------

class TestGrids:
    @pytest.mark.parametrize("omegas", [None, (0.2, 0.9), (0.5, 0.5)],
                             ids=["shared", "split", "split_equal"])
    def test_fields_and_derived_match_reference(self, omegas):
        g = _with_omegas(RS.buddy_ratio_grid([0.05, 0.2, 1.0],
                                             [0.02, 0.1, 0.3]),
                         *(omegas or (None, None)))
        tg = _port(g)
        if omegas is None:
            tg = TS.buddy_ratio_grid([0.05, 0.2, 1.0], [0.02, 0.1, 0.3],
                                     device=CPU)
        assert tg.shape == g.shape and tg.size == g.size
        for f, v in g.fields().items():
            np.testing.assert_array_equal(getattr(tg, f).numpy(), v)
        for m in (1, 2, 5, 12):
            for k in ("C_mean", "C_omega_mean", "a", "b", "mu_eff", "valid"):
                np.testing.assert_array_equal(getattr(tg, k)(m).numpy(),
                                              getattr(g, k)(m))
            for x, y in zip(tg.period_bounds(m), g.period_bounds(m)):
                np.testing.assert_array_equal(x.numpy(), y)
        sl, tsl = g.single_level(), tg.single_level()
        for f, v in sl.fields().items():
            np.testing.assert_array_equal(getattr(tsl, f).numpy(), v)
        assert tg.ckpt_at((1, 2)) == interop.ml_ckpt_from_fields(
            dataclasses.asdict(g.ckpt_at((1, 2))))
        assert tg.power_at((0, 1)) == interop.ml_power_from_fields(
            dataclasses.asdict(g.power_at((0, 1))))

    def test_plumbing(self):
        tg = TS.buddy_ratio_grid([0.1, 0.5], [0.05, 0.2, 0.4], device=CPU)
        flat = tg.ravel()
        assert flat.shape == (6,) and flat.reshape((2, 3)).shape == (2, 3)
        assert set(tg.fields()) == set(RS.buddy_ratio_grid(
            [0.1], [0.1]).fields())
        assert tg.to(CPU).device.type == "cpu"
        np.testing.assert_array_equal(flat.take(torch.tensor([4])).C1,
                                      flat.C1[4:5])
        # omega1/omega2 default to omega; a scalar field broadcasts
        g = TS.MultilevelParamGrid(
            C1=torch.tensor([1.0, 2.0]), R1=1.0, D1=0.5, C2=10.0, R2=10.0,
            D2=1.0, mu=300.0, omega=0.4, q=0.1, P_static=10.0, P_cal=10.0,
            P_io1=20.0, P_io2=100.0, P_down=0.0)
        assert g.shape == (2,) and g.device.type == "cpu"
        assert torch.equal(g.omega1, g.omega) and torch.equal(g.omega2,
                                                              g.omega)

    def test_scenarios_match_reference(self):
        ref, got = RS.list_scenarios(), TS.list_scenarios()
        for name in ("multilevel_exascale", "multilevel_fig12"):
            assert got[name] == ref[name]
        assert set(got) <= set(ref)
        for name, kw in (("multilevel_exascale", dict(mu_min=600.0,
                                                      buddy_ratio=0.25,
                                                      q=0.2)),
                         ("multilevel_fig12", dict(mu_min=120.0))):
            a, b = RS.get_scenario(name, **kw), TS.get_scenario(name, **kw)
            assert isinstance(b, TS.MultilevelScenario)
            assert a.name == b.name and a.description == b.description
            assert dataclasses.asdict(a.ckpt) == dataclasses.asdict(b.ckpt)
            assert dataclasses.asdict(a.power) == dataclasses.asdict(b.power)
        scens = [TS.get_scenario("multilevel_fig12", mu_min=m)
                 for m in (120.0, 300.0)]
        g = TS.multilevel_grid_from_scenarios(scens, device=CPU)
        r = RS.multilevel_grid_from_scenarios(
            [RS.get_scenario("multilevel_fig12", mu_min=m)
             for m in (120.0, 300.0)])
        for f, v in r.fields().items():
            np.testing.assert_array_equal(getattr(g, f).numpy(), v)

    def test_from_params_and_single_level_lift(self):
        ck = MultilevelCheckpointParams(C1=1.0, R1=1.0, C2=10.0, R2=10.0,
                                        D1=0.5, D2=1.0, mu=300.0, q=0.1,
                                        omega1=0.2, omega2=0.9)
        r = RS.MultilevelParamGrid.from_params(ck, EXASCALE_ML_POWER)
        t = TS.MultilevelParamGrid.from_params(
            interop.ml_ckpt_from_fields(dataclasses.asdict(ck)),
            interop.ml_power_from_fields(
                dataclasses.asdict(EXASCALE_ML_POWER)), device=CPU)
        for f, v in r.fields().items():
            assert getattr(t, f).item() == np.asarray(v).item(), f
        sl = RS.mu_rho_grid([120.0, 300.0], [2.0, 5.5])
        r = RS.MultilevelParamGrid.from_single_level(sl, q=0.3)
        t = TS.MultilevelParamGrid.from_single_level(
            interop.grid_from_fields(sl.fields(), device=CPU), q=0.3)
        for f, v in r.fields().items():
            np.testing.assert_array_equal(getattr(t, f).numpy(), v)


# ---------------------------------------------------------------------------
# The batched two-level model and the joint (T, m) grid solver
# ---------------------------------------------------------------------------

class TestBatchedModel:
    @pytest.mark.parametrize("shared", [True, False], ids=["shared", "split"])
    def test_ml_forms_match_reference(self, shared):
        g = _random_grid(3000, 7, shared=shared)
        rng = np.random.default_rng(8)
        m = rng.integers(1, 13, g.size).astype(np.float64)
        lo, hi = (np.asarray(x) for x in g.period_bounds(m))
        v = hi > lo * 1.01
        T = np.where(v, lo + rng.uniform(0.05, 0.95, g.size) * (hi - lo),
                     50.0)
        p = g.fields()
        tp = {k: torch.as_tensor(x) for k, x in p.items()}
        Tt, mt = torch.as_tensor(T), torch.as_tensor(m)
        for T_base in (1.0, 4000.0):
            for name in ("ml_time_final_batched", "ml_energy_final_batched",
                         "_ml_energy_prime_batched"):
                a = np.asarray(getattr(RSW, name)(T, m, p, T_base))[v]
                b = getattr(TSW, name)(Tt, mt, tp, T_base).numpy()[v]
                assert _rel(b, a).max() <= 1e-15, name
        for a, b in zip(RSW._ml_derived(p, m), TSW._ml_derived(tp, mt)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    @pytest.mark.parametrize("name", sorted(GRIDS))
    def test_grid_matches_reference(self, solved, name):
        _, ref, got = solved[name]
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(ref, f)), f)
        for f in OUTS:
            a, b = _np(getattr(got, f)), np.asarray(getattr(ref, f))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), f)
            # on the random platforms the AlgoE root amplifies the
            # reference's contracted rounding through the cancelling
            # Newton differences of its quadratic (up to 3.5e-13 measured);
            # its energies stay within 1e-13
            tol = 1e-12 if name.startswith("random") and f in (
                "T_energy", "T_energy_by_m") else 1e-13
            assert _rel(a, b).max() <= tol, f
        assert got.m_values == ref.m_values and got.T_base == ref.T_base

    def test_degenerate_and_rescued_points(self, solved):
        g, _, got = solved["degenerate_rescued"]
        assert got.valid.tolist() == [True, False, True]
        assert float(got.time_ratio[1]) == 1.0
        assert float(got.energy_ratio[1]) == 1.0
        assert float(got.T_time[1]) == g.C2[1] and int(got.m_time[1]) == 1
        assert np.isnan(float(got.time_vs_single[2]))
        assert np.isnan(float(got.energy_vs_single[2]))
        assert float(got.time_ratio[2]) >= 1.0

    def test_point_at_matches_reference(self, solved):
        _, ref, got = solved["fig4"]
        for idx in ((0, 0), (3, 2), (5, 4)):
            a, b = ref.point_at(idx), got.point_at(idx)
            assert (a.m_time, a.m_energy) == (b.m_time, b.m_energy)
            for f in ("T_time", "T_energy", "time_ratio", "energy_ratio",
                      "time_vs_single", "energy_vs_single"):
                assert getattr(b, f) == pytest.approx(getattr(a, f),
                                                      rel=1e-13), f
            assert dataclasses.asdict(b.ckpt) == dataclasses.asdict(a.ckpt)

    def test_m_max_mask_and_chunks(self):
        g = GRIDS["fig4"]()
        tg = _port(g)
        m_max = np.minimum(np.arange(g.size).reshape(g.shape) % 8 + 1, 8)
        ref = RS.evaluate_multilevel_grid(g, m_values=M_VALUES, m_max=m_max)
        base = TS.evaluate_multilevel_grid(tg, m_values=M_VALUES,
                                           m_max=m_max, device=CPU)
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(base, f)),
                                          np.asarray(getattr(ref, f)), f)
        for f in OUTS:
            assert _rel(_np(getattr(base, f)),
                        getattr(ref, f)).max() <= 1e-13, f
        assert bool((base.m_energy <= torch.as_tensor(m_max)).all())
        # the chunk plan is a bitwise no-op, masked and unmasked
        for mm in (m_max, None):
            a = TS.evaluate_multilevel_grid(tg, m_values=M_VALUES,
                                            m_max=mm, device=CPU)
            b = TS.evaluate_multilevel_grid(
                tg, m_values=M_VALUES, m_max=mm, device=CPU,
                dispatch=DispatchConfig(chunk=7))
            c = TS.evaluate_multilevel_grid(
                tg, m_values=M_VALUES, m_max=mm, device=CPU,
                dispatch=DispatchConfig(chunk=1))
            for f in OUTS + EXACT:
                x = getattr(a, f)
                assert torch.equal(x.nan_to_num(), getattr(b, f)
                                   .nan_to_num()), f
                assert torch.equal(x.nan_to_num(), getattr(c, f)
                                   .nan_to_num()), f

    def test_m1_lift_reproduces_single_level(self):
        sl = RS.mu_rho_grid([120.0, 300.0, 900.0], [2.0, 5.5, 9.0])
        tsl = interop.grid_from_fields(sl.fields(), device=CPU)
        ml = TS.evaluate_multilevel_grid(
            TS.MultilevelParamGrid.from_single_level(tsl, q=0.0),
            m_values=(1,), device=CPU)
        one = TS.evaluate_grid(tsl, device=CPU)
        for f in ("T_time", "T_energy", "time_ratio", "energy_ratio"):
            assert _rel(getattr(ml, f).numpy(),
                        getattr(one, f).numpy()).max() <= 1e-12, f
        assert _rel(ml.time_vs_single.numpy(), 1.0).max() <= 1e-12
        assert _rel(ml.energy_vs_single.numpy(), 1.0).max() <= 1e-12

    def test_compensated_f32_gate(self):
        pol = COMPENSATED_F32
        g = RS.buddy_ratio_grid([0.05, 0.2, 1.0], [0.02, 0.1, 0.3],
                                mu_min=300.0)
        r64 = RS.evaluate_multilevel_grid(g, m_values=M_VALUES)
        r32 = TS.evaluate_multilevel_grid(_port(g), m_values=M_VALUES,
                                          precision=pol, device=CPU)
        assert r32.T_time.dtype == torch.float64
        for T64, m64, T32, m32 in (
                (r64.T_time, r64.m_time, r32.T_time, r32.m_time),
                (r64.T_energy, r64.m_energy, r32.T_energy, r32.m_energy)):
            np.testing.assert_allclose(T32.numpy(), np.asarray(T64),
                                       rtol=pol.argmin_rtol)
            assert np.abs(m32.numpy() - np.asarray(m64)).max() <= 1
        E64 = np.asarray(r64.E_by_m)
        at64 = np.take_along_axis(E64, (np.asarray(r64.m_energy) - 1)[None],
                                  axis=0)[0]
        at32 = np.take_along_axis(E64, (r32.m_energy.numpy() - 1)[None],
                                  axis=0)[0]
        assert float((np.abs(at32 - at64) / np.abs(at64)).max()) \
            <= 10 * pol.objective_tol

    def test_bad_m_values_raise(self):
        tg = TS.buddy_ratio_grid([0.1], [0.1], device=CPU)
        for mv in ((), (0, 1)):
            with pytest.raises(ValueError, match="m_values"):
                TS.evaluate_multilevel_grid(tg, m_values=mv, device=CPU)


class TestTradeoff:
    @pytest.mark.parametrize("ck", [
        MultilevelCheckpointParams(C1=1.0, R1=1.0, C2=10.0, R2=10.0, D1=0.5,
                                   D2=1.0, mu=300.0, q=0.1, omega=0.5),
        MultilevelCheckpointParams(C1=1.0, R1=1.0, C2=10.0, R2=10.0, D1=0.5,
                                   D2=1.0, mu=300.0, q=0.1, omega1=0.2,
                                   omega2=0.9),
        MultilevelCheckpointParams(C1=5.0, R1=5.0, C2=100.0, R2=100.0,
                                   D1=0.5, D2=1.0, mu=120.0, q=0.1,
                                   omega=0.0)], ids=["shared", "split",
                                                     "rescued"])
    def test_evaluate_multilevel_matches_reference(self, ck):
        a = RT.evaluate_multilevel(ck, EXASCALE_ML_POWER, m_max=8)
        b = PC.evaluate_multilevel(
            interop.ml_ckpt_from_fields(dataclasses.asdict(ck)),
            interop.ml_power_from_fields(
                dataclasses.asdict(EXASCALE_ML_POWER)), m_max=8, device=CPU)
        assert (a.m_time, a.m_energy) == (b.m_time, b.m_energy)
        for f in ("T_time", "T_energy", "time_ratio", "energy_ratio",
                  "time_vs_single", "energy_vs_single", "energy_saving",
                  "time_overhead"):
            x, y = getattr(b, f), getattr(a, f)
            assert np.isnan(x) == np.isnan(y), f
            assert x == pytest.approx(y, rel=1e-12, nan_ok=True), f

    @pytest.mark.parametrize("engine", ["batched", "scalar"])
    def test_sweep_buddy_ratio_matches_reference(self, engine):
        ratios, qs = [0.1, 0.4], [0.05, 0.2]
        ref = RT.sweep_buddy_ratio(ratios, qs, mu_minutes=300.0, m_max=6,
                                   engine=engine)
        got = PC.sweep_buddy_ratio(ratios, qs, mu_minutes=300.0, m_max=6,
                                   engine=engine, device=CPU)
        for rr, rg in zip(ref, got):
            for a, b in zip(rr, rg):
                assert isinstance(b, PC.MultilevelTradeoffPoint)
                assert (a.m_time, a.m_energy) == (b.m_time, b.m_energy)
                for f in ("T_time", "T_energy", "time_ratio",
                          "energy_ratio", "time_vs_single",
                          "energy_vs_single"):
                    assert getattr(b, f) == pytest.approx(
                        getattr(a, f), rel=1e-12), f
        # both of the port's engines agree as the reference's do
        other = PC.sweep_buddy_ratio(
            ratios, qs, mu_minutes=300.0, m_max=6, device=CPU,
            engine="scalar" if engine == "batched" else "batched")
        for rg, ro in zip(got, other):
            for b, o in zip(rg, ro):
                assert b.time_ratio == pytest.approx(o.time_ratio, rel=1e-7)
                assert b.energy_ratio == pytest.approx(o.energy_ratio,
                                                       rel=1e-7)


# ---------------------------------------------------------------------------
# The two-level Monte-Carlo engine
# ---------------------------------------------------------------------------

def _hand_grid():
    ck = MultilevelCheckpointParams(C1=1.0, R1=1.0, C2=2.0, R2=2.0, D1=0.5,
                                    D2=1.0, mu=1.0e9, q=0.5, omega=0.0)
    pw = MultilevelPowerParams(P_static=1.0, P_cal=2.0, P_io1=3.0,
                               P_io2=5.0, P_down=7.0)
    return TS.MultilevelParamGrid.from_params(
        interop.ml_ckpt_from_fields(dataclasses.asdict(ck)),
        interop.ml_power_from_fields(dataclasses.asdict(pw)),
        device=CPU).reshape((1,))


def _assert_ml(ref, got, rtol=0.0):
    for f in ML_FIELDS:
        a, b = np.asarray(getattr(ref, f)), _np(getattr(got, f))
        assert a.shape == b.shape, f
        if rtol == 0.0 or f not in ML_FLOATS:
            np.testing.assert_array_equal(b, a, f)
        else:
            assert _rel(b, a).max() <= rtol, f


class TestEngine:
    """The reference's hand-computed trajectory (T=10, C1=1, C2=2, m=2,
    blocking, T_base=40): fault-free, a soft failure at t=33 (back to the
    buddy commit) and a hard one (back to the deep commit)."""

    @pytest.mark.parametrize("gaps,hard,want", [
        ([1e9, 1e9], [False, False], (46.0, 40.0, 2.0, 4.0, 0.0, 0, 0)),
        ([33.0, 1e9], [False, False], (50.5, 43.0, 3.0, 4.0, 0.5, 1, 0)),
        ([33.0, 1e9], [True, False], (62.0, 52.0, 3.0, 6.0, 1.0, 1, 1)),
    ], ids=["fault_free", "soft", "hard"])
    def test_hand_computed(self, gaps, hard, want):
        tb = TS.simulate_trajectories_ml(
            10.0, 2, _hand_grid(), T_base=40.0,
            gaps=np.asarray(gaps)[None, None, :],
            hard=np.asarray(hard)[None, None, :], device=CPU)
        assert not bool(tb.truncated.any() | tb.gaps_exhausted.any())
        got = (tb.wall_time, tb.work_executed, tb.io1_time, tb.io2_time,
               tb.down_time, tb.n_failures, tb.n_hard_failures)
        assert tuple(x[0, 0].item() for x in got) == want
        w, c, i1, i2, d = want[:5]
        assert tb.energy[0, 0].item() == pytest.approx(
            w + 2.0 * c + 3.0 * i1 + 5.0 * i2 + 7.0 * d, rel=1e-12)

    @pytest.mark.parametrize("m", [1, 2, 3, 5])
    @pytest.mark.parametrize("omegas", [(0.25, 0.5), (0.2, 0.8)],
                             ids=["exact_products", "general"])
    def test_scan_matches_reference_on_explicit_schedules(self, m, omegas):
        g = _with_omegas(RS.buddy_ratio_grid([0.05, 0.3], [0.05, 0.3],
                                             mu_min=200.0), *omegas)
        rng = np.random.default_rng(100 + m)
        gaps = rng.exponential(200.0, size=(g.size, 16, 64))
        hard = rng.random((g.size, 16, 64)) < 0.3
        T = 25.0 + m
        ref = RS.simulate_trajectories_ml(T, m, g, T_base=800.0, gaps=gaps,
                                          hard=hard)
        got = TS.simulate_trajectories_ml(T, m, _port(g), T_base=800.0,
                                          gaps=gaps, hard=hard, device=CPU)
        assert not bool(got.truncated.any())
        assert int(got.n_hard_failures.sum()) > 0
        _assert_ml(ref, got, 0.0 if omegas == (0.25, 0.5) else 1e-14)

    @pytest.mark.parametrize("seed", [0, 5])
    def test_auto_sampled_rng_equals_reference_seed(self, seed):
        g = RS.buddy_ratio_grid([0.1, 0.25], [0.1, 0.3], mu_min=600.0)
        res = RS.evaluate_multilevel_grid(g, m_values=(1, 2, 3, 4))
        ref = RS.simulate_trajectories_ml(res.T_energy, res.m_energy, g,
                                          4000.0, n_trials=48, seed=seed)
        got = TS.simulate_trajectories_ml(
            res.T_energy, res.m_energy, _port(g), 4000.0, n_trials=48,
            rng=np.random.default_rng(seed), device=CPU)
        _assert_ml(ref, got)
        assert got.steps <= got.n_steps
        # the schedule and the budgets themselves
        a = RS.engine.presample_failures(g, 3, 5, seed=seed)
        b = TS.presample_failures(_port(g), 3, 5, np.random.default_rng(seed))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
        T, m, flat = np.asarray(res.T_energy).ravel(), \
            np.asarray(res.m_energy).ravel(), g.ravel()
        for fn in ("default_fail_capacity_ml", "default_step_budget_ml"):
            assert getattr(TS, fn)(T, m, _port(flat), 4000.0) == \
                getattr(RS.engine, fn)(T, m, flat, 4000.0)

    def test_trial_blocks_are_a_bitwise_noop(self, monkeypatch):
        tg = TS.buddy_ratio_grid([0.1, 0.25], [0.1, 0.3], mu_min=600.0,
                                 device=CPU)
        kw = dict(T_base=2000.0, n_trials=24, device=CPU)
        a = TS.simulate_trajectories_ml(60.0, 3, tg,
                                        rng=np.random.default_rng(2), **kw)
        blocks = []
        real = TE._run_one_ml

        def counted(*args, **kwargs):
            blocks.append(args[11].shape[1])
            return real(*args, **kwargs)

        # 64 KiB a lane against a 1 MiB budget: blocks of 4 trials
        monkeypatch.setattr(TE, "_ML_LANE_BYTES", 1 << 16)
        monkeypatch.setattr(TE, "_run_one_ml", counted)
        b = TS.simulate_trajectories_ml(60.0, 3, tg,
                                        rng=np.random.default_rng(2),
                                        dispatch=DispatchConfig(memory_mb=1),
                                        **kw)
        assert blocks == [4] * 6
        _assert_ml(a, b)

    @pytest.mark.parametrize("T", [40.0, 53.3])
    def test_m1_matches_scalar_oracle(self, T):
        ck = CheckpointParams(C=10.0, R=10.0, D=1.0, mu=300.0, omega=0.5)
        tck = interop.ckpt_from_fields(dataclasses.asdict(ck))
        tpw = interop.power_from_fields(dataclasses.asdict(
            EXASCALE_POWER_RHO55))
        sl = TS.ParamGrid.from_params(tck, tpw, device=CPU).reshape((1,))
        grid = TS.MultilevelParamGrid.from_single_level(sl, q=0.3)
        rng = np.random.default_rng(123)
        gaps = rng.exponential(ck.mu, size=(1, 8, 64))
        hard = rng.random(size=(1, 8, 64)) < 0.3
        tb = TS.simulate_trajectories_ml(T, 1, grid, T_base=4000.0,
                                         gaps=gaps, hard=hard, device=CPU)
        assert not bool(tb.truncated.any())
        for k in range(gaps.shape[1]):
            ref = simulate_once(T, ck, EXASCALE_POWER_RHO55, 4000.0,
                                RS.ScheduledRNG(gaps[0, k]))
            assert tb.wall_time[0, k].item() == ref.wall_time
            assert tb.energy[0, k].item() == ref.energy
            assert tb.work_executed[0, k].item() == ref.work_executed
            assert (tb.io1_time[0, k] + tb.io2_time[0, k]).item() \
                == ref.io_time
            assert tb.down_time[0, k].item() == ref.down_time
            assert tb.n_failures[0, k].item() == ref.n_failures
            assert (tb.n_ckpt1[0, k] + tb.n_ckpt2[0, k]).item() \
                == ref.n_checkpoints

    @pytest.mark.parametrize("dyadic", [False, True], ids=["raw", "dyadic"])
    def test_m1_equals_single_level_kinds(self, dyadic):
        """The m = 1 reduction ``chip_smoke.py`` checks on the card: every
        trajectory output of the lift's scan equals the single-level step
        kind bitwise, and on a dyadic schedule the event kernel's plain
        version too.  The energy integral prices each level's I/O at its
        own power (the reference's two-level form), so on a raw schedule
        P io1 + P io2 rounds apart from P (io1 + io2) in a few lanes; it is
        bitwise on the dyadic one."""
        sl = TS.mu_rho_grid([120.0, 300.0], [2.0, 5.5], device=CPU)
        grid = TS.MultilevelParamGrid.from_single_level(sl, q=0.3)
        rng = np.random.default_rng(9)
        gaps = rng.exponential(1.0, size=(4, 32, 96)) * np.array(
            [120.0, 120.0, 300.0, 300.0])[:, None, None]
        T = np.array([[32.25, 34.5], [56.75, 60.0]])
        if dyadic:
            gaps = np.maximum(np.round(gaps * 2**16) / 2**16, 2.0**-16)
        hard = rng.random(gaps.shape) < 0.3
        ml = TS.simulate_trajectories_ml(T, 1, grid, T_base=1500.0,
                                         gaps=gaps, hard=hard, device=CPU)
        assert int(ml.n_hard_failures.sum()) > 0
        for kind in ["step"] + (["event"] if dyadic else []):
            one = TS.simulate_trajectories(T, sl, T_base=1500.0, gaps=gaps,
                                           engine_kind=kind, device=CPU)
            pairs = ((one.wall_time, ml.wall_time),
                     (one.work_executed, ml.work_executed),
                     (one.io_time, ml.io1_time + ml.io2_time),
                     (one.down_time, ml.down_time),
                     (one.n_failures, ml.n_failures),
                     (one.n_checkpoints, ml.n_ckpt1 + ml.n_ckpt2),
                     (one.truncated, ml.truncated),
                     (one.gaps_exhausted, ml.gaps_exhausted))
            assert all(torch.equal(a, b) for a, b in pairs), kind
            if dyadic:
                assert torch.equal(one.energy, ml.energy), kind
            else:
                assert _rel(ml.energy, one.energy).max() <= 1e-15

    def test_errors_match_reference(self):
        g = RS.MultilevelParamGrid.from_params(
            MultilevelCheckpointParams(C1=1.0, R1=1.0, C2=2.0, R2=2.0,
                                       D1=0.5, D2=1.0, mu=1e9, q=0.5,
                                       omega=0.0),
            MultilevelPowerParams(P_static=1.0, P_cal=2.0, P_io1=3.0,
                                  P_io2=5.0, P_down=7.0)).reshape((1,))
        tg = _port(g)
        for T, m, match in ((10.0, 0, "cadence"), (1.5, 2, "cover"),
                            (2.0, 1, "progress")):
            for sim, grid, kw in ((RS.simulate_trajectories_ml, g, {}),
                                  (TS.simulate_trajectories_ml, tg,
                                   dict(rng=np.random.default_rng(0),
                                        device=CPU))):
                with pytest.raises(ValueError, match=match):
                    sim(T, m, grid, T_base=40.0, n_trials=2, **kw)
        with pytest.raises(ValueError, match="disagree"):
            TS.simulate_trajectories_ml(10.0, 2, tg, T_base=40.0,
                                        gaps=np.ones((1, 2, 4)),
                                        hard=np.zeros((1, 2, 5), bool),
                                        device=CPU)
        with pytest.raises(ValueError, match="rng"):
            TS.simulate_trajectories_ml(10.0, 2, tg, T_base=40.0, device=CPU)
        short, flags = np.array([[5.0]]), np.array([[False]])
        for n_steps, match in ((2, "scan budget"), (None, "exhausted")):
            for sim, grid, kw in ((RS.simulate_grid_ml, g, {}),
                                  (TS.simulate_grid_ml, tg,
                                   dict(device=CPU))):
                with pytest.raises(RuntimeError, match=match):
                    sim(10.0, 2, grid, T_base=40.0, gaps=short, hard=flags,
                        n_steps=n_steps, **kw)


class TestMonteCarloValidation:
    """The reference's acceptance gate on its 2 x 2 grid: MC means within
    2% of the closed forms at both optima (m T < mu there), and the joint
    (T, m) beating the PFS-only optimum in the simulator."""

    RATIOS, QS = [0.1, 0.25], [0.1, 0.3]

    @pytest.fixture(scope="class")
    def ml_solved(self):
        grid = TS.buddy_ratio_grid(self.RATIOS, self.QS, mu_min=600.0,
                                   device=CPU)
        return grid, TS.evaluate_multilevel_grid(grid, m_values=(1, 2, 3, 4),
                                                 device=CPU)

    @pytest.mark.parametrize("algo", ["time", "energy"])
    def test_within_2pct(self, ml_solved, algo):
        grid, res = ml_solved
        Ts = getattr(res, f"T_{algo}")
        ms = getattr(res, f"m_{algo}")
        out = TS.simulate_grid_ml(Ts, ms, grid, 4000.0, n_trials=400,
                                  rng=np.random.default_rng(5), device=CPU)
        p = grid.fields()
        assert bool((ms * Ts < grid.mu).all())
        tf = TSW.ml_time_final_batched(Ts, ms.to(torch.float64), p, 4000.0)
        e = TSW.ml_energy_final_batched(Ts, ms.to(torch.float64), p, 4000.0)
        assert float((out["T_final"] / tf - 1).abs().max()) < 0.02
        assert float((out["E_final"] / e - 1).abs().max()) < 0.02

    def test_joint_choice_beats_pfs_only_in_simulation(self, ml_solved):
        grid, res = ml_solved
        sl = TS.evaluate_multilevel_grid(grid, m_values=(1,), device=CPU)
        two = TS.simulate_grid_ml(res.T_time, res.m_time, grid, 4000.0,
                                  n_trials=300, rng=np.random.default_rng(9),
                                  device=CPU)
        one = TS.simulate_grid_ml(sl.T_time, sl.m_time, grid, 4000.0,
                                  n_trials=300, rng=np.random.default_rng(9),
                                  device=CPU)
        assert bool((two["T_final"] < one["T_final"]).all())


class TestFirstOrderGap:
    """The first-order closed forms' own gap, read by the reference: at
    the two AlgoE points of ``chip_smoke.py``'s ml-mc grid
    (``buddy_ratio_grid(geomspace(0.02, 1, 32), geomspace(0.01, 0.4, 32),
    mu_min=600)``, points (23, 31) and (30, 30)) where the card's MC means
    sit 2.09% below ``ml_energy_final``, the reference's own
    ``simulate_grid_ml`` (seed 0, 4096 trials, independent draws of the
    same process) reads the energy 1.67% and 2.05% below the model,
    beyond 1% (over seven standard errors) and within the smoke's 2.5%
    bound; the port reads the same means on the same draws (within
    1e-14: the reference's FMAs, as in the scan tests)."""

    R = np.geomspace(0.02, 1.0, 32)[[23, 30]]
    Q = np.geomspace(0.01, 0.4, 32)[[30, 31]]

    @pytest.fixture(scope="class")
    def gaps(self):
        g = RS.buddy_ratio_grid(self.R, self.Q, mu_min=600.0)
        res = RS.evaluate_multilevel_grid(g, m_values=tuple(range(1, 13)))
        T, m = np.asarray(res.T_energy), np.asarray(res.m_energy)
        ref = RS.simulate_grid_ml(T, m, g, 4000.0, n_trials=4096, seed=0)
        got = TS.simulate_grid_ml(T, m, _port(g), 4000.0, n_trials=4096,
                                  rng=np.random.default_rng(0), device=CPU)
        e = np.asarray(RSW.ml_energy_final_batched(
            T, m.astype(np.float64), g.fields(), 4000.0))
        return T, m, g, ref, got, e

    def test_port_reads_the_reference_means(self, gaps):
        _, _, _, ref, got, _ = gaps
        for k in ("T_final", "E_final", "E_final_se"):
            np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]),
                                       rtol=1e-14, atol=0.0)

    @pytest.mark.parametrize("at", [(0, 1), (1, 0)],
                             ids=["ratio0.364_q0.400", "ratio0.881_q0.355"])
    def test_reference_reads_the_gap(self, gaps, at):
        T, m, g, ref, _, e = gaps
        assert m[at] * T[at] < 600.0
        gap = ref["E_final"][at] / e[at] - 1
        se = ref["E_final_se"][at] / e[at]
        assert -0.025 < gap < -0.01, gap
        assert abs(gap) > 7 * se, (gap, se)


@pytest.mark.parametrize("call", [
    lambda: TS.buddy_ratio_grid([0.1], [0.1]),
    lambda: TS.evaluate_multilevel_grid(
        TS.buddy_ratio_grid([0.1], [0.1], device=CPU)),
    lambda: TS.simulate_trajectories_ml(
        40.0, 2, TS.buddy_ratio_grid([0.1], [0.1], device=CPU),
        n_trials=2, rng=np.random.default_rng(0)),
    lambda: TS.simulate_grid_ml(
        40.0, 2, TS.buddy_ratio_grid([0.1], [0.1], device=CPU),
        n_trials=2, rng=np.random.default_rng(0)),
    lambda: PC.sweep_buddy_ratio([0.1], [0.1]),
    lambda: PC.evaluate_multilevel(
        TS.get_scenario("multilevel_exascale").ckpt,
        TS.get_scenario("multilevel_exascale").power),
], ids=["buddy_ratio_grid", "evaluate_multilevel_grid",
        "simulate_trajectories_ml", "simulate_grid_ml", "sweep_buddy_ratio",
        "evaluate_multilevel"])
def test_default_device_raises_without_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        call()
