"""The rest of the single-level MC engine, port against reference: engine
kinds, the step scan, ``simulate_candidates``, the CRN MC solvers
(``MCSurrogate`` and friends) and the robustness and periods grids.

Schedules are numpy, made from a seed and handed to both packages; where a
function samples its own schedule, the port gets
``np.random.default_rng(s)`` and the reference ``seed=s``, which draw the
same numbers.  The port runs on the CPU (the event kernel's plain
version).  Tolerances: the step scan bitwise on dyadic schedules and
within 1e-12 relative on raw ones; candidates within 1e-12 with counts
and flags equal; surrogate objectives 1e-12, argmins 1e-6 relative;
robustness periods 1e-12 and penalties 1e-10 with the same candidate
picks.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sim as RS
from repro.core import (EXASCALE_POWER_RHO55, Exponential, LogNormal,
                        TraceReplay, Weibull, fig12_checkpoint)
from repro.core import optimal as RO
from repro.core import tradeoff as RT
from repro.sim import engine as RE

import repro_torch.core as PC
import repro_torch.sim as TS
from repro_torch import interop
from repro_torch.core import optimal as PO
from repro_torch.core import tradeoff as PT
from repro_torch.kernels import event_sweep as ES
from repro_torch.sim import engine as TE
from repro_torch.sim.precision import COMPENSATED_F32, F64

CPU = "cpu"
CK = fig12_checkpoint(300.0)
PW = EXASCALE_POWER_RHO55
FIELDS = ("wall_time", "energy", "work_executed", "io_time", "down_time",
          "n_failures", "n_checkpoints", "truncated", "gaps_exhausted")
FLOATS = FIELDS[:5]
PROCESSES = [Exponential(), Weibull(shape=0.6), LogNormal(sigma=1.0),
             TraceReplay(gaps=[40.0, 500.0, 120.0, 90.0, 800.0, 33.0])]
PIDS = [p.name for p in PROCESSES]


def _np(tb, name):
    x = getattr(tb, name)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dyadic(gaps):
    return np.maximum(np.round(gaps * 2.0**16) / 2.0**16, 2.0**-16)


def _assert_close(ref, got, rtol):
    for f in FIELDS:
        a, b = _np(ref, f), _np(got, f)
        assert a.shape == b.shape, f
        if f in FLOATS and rtol:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0.0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def _grids():
    grid = RS.mu_rho_grid([120.0, 300.0, 900.0], [2.0, 7.0])
    return grid, interop.grid_from_fields(grid.fields(), device=CPU)


def _grid1():
    g = RS.ParamGrid.from_params(CK, PW).reshape((1,))
    return g, interop.grid_from_fields(g.fields(), device=CPU)


def _ref_ckpt():
    return interop.ckpt_from_fields(dataclasses.asdict(CK)), \
        interop.power_from_fields(dataclasses.asdict(PW))


T_GRID = np.array([[41.3, 47.9], [63.7, 70.1], [111.1, 131.9]])
#: the same periods rounded to quarters: every quantity of a dyadic
#: schedule's trajectories is then exactly representable
T_DYADIC = np.round(T_GRID * 4.0) / 4.0


class TestEngineKinds:
    def test_resolve_engine_kind(self, monkeypatch):
        monkeypatch.delenv("REPRO_ENGINE_KIND", raising=False)
        assert TE.resolve_engine_kind() == RE.resolve_engine_kind() \
            == "event"
        for kind in ("event", "pallas", "step"):
            assert TE.resolve_engine_kind(kind) == kind
        monkeypatch.setenv("REPRO_ENGINE_KIND", "step")
        assert TE.resolve_engine_kind() == RE.resolve_engine_kind() == "step"
        assert TE.resolve_engine_kind("pallas") == "pallas"
        monkeypatch.setenv("REPRO_ENGINE_KIND", "  ")
        assert TE.resolve_engine_kind() == "event"
        for bad in ("scan", "EVENT"):
            with pytest.raises(ValueError, match="engine_kind"):
                TE.resolve_engine_kind(bad)

    def test_engine_policy_defaults(self, monkeypatch):
        """With no precision, "event" on CUDA runs f64 (the reference's
        oracle), where the device default is compensated f32."""
        monkeypatch.delenv("REPRO_PRECISION", raising=False)
        assert TE._engine_policy("event", None, None, "cuda") is F64
        assert TE._engine_policy("step", None, None, "cuda") is F64
        assert TE._engine_policy("pallas", None, None, "cuda") \
            is COMPENSATED_F32
        assert TE._engine_policy("pallas", None, None, "cpu") is F64
        # an explicit precision keeps winning; a config or env value does
        # not reach the oracle kinds
        assert TE._engine_policy("event", None, "compensated_f32",
                                 "cuda") is COMPENSATED_F32
        assert TE._engine_policy("event", TS.DispatchConfig(
            precision="compensated_f32"), None, "cuda") is F64
        monkeypatch.setenv("REPRO_PRECISION", "compensated_f32")
        assert TE._engine_policy("event", None, None, "cpu") is F64
        assert TE._engine_policy("pallas", None, None, "cpu") \
            is COMPENSATED_F32
        with pytest.raises(ValueError, match="f64 only"):
            TE._engine_policy("step", None, COMPENSATED_F32, "cpu")

    def test_pallas_kind_runs_the_event_kernel(self):
        grid, tg = _grids()
        gaps = RE.presample_gaps(grid, 32, 128, seed=4)
        kw = dict(T_base=3000.0, gaps=gaps, device=CPU)
        a = TS.simulate_trajectories(T_GRID, tg, engine_kind="event", **kw)
        b = TS.simulate_trajectories(T_GRID, tg, engine_kind="pallas",
                                     precision=F64, **kw)
        _assert_close(a, b, 0.0)


class TestStepScan:
    @pytest.mark.parametrize("proc", PROCESSES, ids=PIDS)
    def test_bitwise_on_dyadic_schedule(self, proc):
        grid, tg = _grids()
        gaps = _dyadic(RE.presample_gaps(grid, 24, 96, seed=9,
                                         process=proc))
        ref = RS.simulate_trajectories(T_DYADIC, grid, T_base=1500.0,
                                       gaps=gaps, engine_kind="step")
        got = TS.simulate_trajectories(T_DYADIC, tg, T_base=1500.0,
                                       gaps=gaps, engine_kind="step",
                                       device=CPU)
        assert not bool(got.truncated.any())
        _assert_close(ref, got, 0.0)
        # the reference's contract: event and step agree on dyadic
        # schedules
        ev = TS.simulate_trajectories(T_DYADIC, tg, T_base=1500.0,
                                      gaps=gaps, device=CPU)
        _assert_close(ev, got, 0.0)

    @pytest.mark.parametrize("proc", PROCESSES, ids=PIDS)
    def test_raw_schedule_within_1e12(self, proc):
        grid, tg = _grids()
        gaps = RE.presample_gaps(grid, 24, 96, seed=3, process=proc)
        ref = RS.simulate_trajectories(T_GRID, grid, T_base=1500.0,
                                       gaps=gaps, engine_kind="step")
        got = TS.simulate_trajectories(T_GRID, tg, T_base=1500.0, gaps=gaps,
                                       engine_kind="step", device=CPU)
        _assert_close(ref, got, 1e-12)

    def test_budgets_and_flags_match_reference(self):
        grid, tg = _grids()
        grid, tg, T = grid.ravel(), tg.ravel(), T_GRID.ravel()
        probes = np.stack([T * 0.7, T, T * 2.0])
        for proc in (None, Weibull(shape=0.7)):
            tproc = None if proc is None else PC.Weibull(shape=0.7)
            np.testing.assert_array_equal(
                TE.step_budget_points(T, tg, 1500.0, process=tproc),
                RE.step_budget_points(T, grid, 1500.0, process=proc))
            assert TE.default_step_budget(probes, tg, 1500.0, tproc) == \
                RE.default_step_budget(probes, grid, 1500.0, proc)
        g1, t1 = _grid1()
        short = np.array([50.0, 70.0])
        for n_steps in (None, 3):
            ref = RS.simulate_trajectories(60.0, g1, T_base=4000.0,
                                           gaps=short, n_steps=n_steps,
                                           engine_kind="step")
            got = TS.simulate_trajectories(60.0, t1, T_base=4000.0,
                                           gaps=short, n_steps=n_steps,
                                           engine_kind="step", device=CPU)
            _assert_close(ref, got, 0.0)
        assert bool(got.truncated.all())

    def test_auto_sampled_step_equals_event_on_the_same_draws(self):
        _, tg = _grids()
        kw = dict(T_base=800.0, n_trials=16, seed=5, device=CPU)
        ev = TS.simulate_trajectories(T_GRID, tg, **kw)
        st = TS.simulate_trajectories(T_GRID, tg, engine_kind="step", **kw)
        for f in ("n_failures", "truncated", "gaps_exhausted"):
            np.testing.assert_array_equal(_np(st, f), _np(ev, f))
        for f in FLOATS:
            np.testing.assert_allclose(_np(st, f), _np(ev, f), rtol=1e-12)


class TestCandidates:
    @pytest.mark.parametrize("kind", ["event", "step"])
    def test_grid_axis_matches_reference(self, kind):
        grid, tg = _grids()
        Tc = np.stack([T_GRID * 0.8, T_GRID, T_GRID * 1.3])
        gaps = RE.presample_gaps(grid, 16, 128, seed=11,
                                 process=Weibull(shape=0.7))
        ref = RE.simulate_candidates(Tc, grid, T_base=1500.0, gaps=gaps,
                                     engine_kind=kind)
        got = TE.simulate_candidates(Tc, tg, T_base=1500.0, gaps=gaps,
                                     engine_kind=kind, device=CPU)
        assert _np(got, "wall_time").shape == (3, 3, 2, 16)
        _assert_close(ref, got, 1e-12)

    @pytest.mark.parametrize("kind", ["event", "step"])
    def test_one_point_matches_reference(self, kind):
        g1, t1 = _grid1()
        Ts = np.linspace(40.0, 150.0, 7)
        cap = RE.default_fail_capacity(Ts, g1, 6000.0)
        gaps = RE.presample_gaps(g1, 24, cap, seed=5)
        ref = RE.simulate_candidates(Ts, g1, T_base=6000.0, gaps=gaps,
                                     engine_kind=kind)
        got = TE.simulate_candidates(Ts, t1, T_base=6000.0, gaps=gaps,
                                     engine_kind=kind, device=CPU)
        _assert_close(ref, got, 1e-12)

    def test_stride0_pass_equals_per_candidate_calls(self, monkeypatch):
        """One point: one pass whose rows are the candidates, the schedule
        expanded with point stride 0 (not copied), equal to one
        simulate_trajectories call per candidate."""
        g1, t1 = _grid1()
        Ts = np.linspace(40.0, 150.0, 5)
        gaps = torch.as_tensor(RE.presample_gaps(g1, 20, 256, seed=8))
        seen = []
        real = TE.event_sweep

        def spy(*args, **kw):
            seen.append((args[0].shape, args[6].shape, args[6].stride(),
                         args[6].data_ptr()))
            return real(*args, **kw)
        monkeypatch.setattr(TE, "event_sweep", spy)
        got = TE.simulate_candidates(Ts, t1, T_base=6000.0, gaps=gaps,
                                     device=CPU)
        assert len(seen) == 1
        (tshape, gshape, gstride, gptr), = seen
        assert tshape == (5,) and gshape == (5, 20, 256)
        assert gstride[0] == 0 and gptr == gaps.data_ptr()
        for m, T in enumerate(Ts):
            one = TS.simulate_trajectories(T, t1, T_base=6000.0, gaps=gaps,
                                           device=CPU)
            for f in FIELDS:
                assert torch.equal(getattr(got, f)[m], getattr(one, f)), f

    def test_grid_axis_launches_once_per_candidate(self, monkeypatch):
        _, tg = _grids()
        calls = []
        real = TE.event_sweep
        monkeypatch.setattr(TE, "event_sweep",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        gaps = RE.presample_gaps(_grids()[0], 8, 64, seed=2)
        TE.simulate_candidates(np.stack([T_GRID, T_GRID * 1.1]), tg,
                               T_base=800.0, gaps=gaps, device=CPU)
        assert len(calls) == 2

    @pytest.mark.parametrize("kind", ["event", "step"])
    def test_auto_sampled_candidates_share_the_draws(self, kind):
        """gaps=None: every candidate sees the lanes' same counter-based
        draws, so each equals its own simulate_trajectories call."""
        _, tg = _grids()
        Tc = np.stack([T_GRID, T_GRID * 1.2])
        kw = dict(T_base=800.0, n_trials=12, seed=21, device=CPU)
        got = TE.simulate_candidates(Tc, tg, engine_kind=kind, **kw)
        assert not bool(got.gaps_exhausted.any())
        for m in range(2):
            one = TS.simulate_trajectories(Tc[m], tg, engine_kind=kind, **kw)
            for f in FIELDS:
                assert torch.equal(getattr(got, f)[m], getattr(one, f)), f

    def test_period_too_short_raises(self):
        _, t1 = _grid1()
        with pytest.raises(ValueError, match="too short"):
            TE.simulate_candidates([4.0, 60.0], t1, T_base=100.0,
                                   n_trials=2, device=CPU)


class TestMCSolvers:
    def _pair(self, proc, tproc, n_trials=32, kind=None):
        ck, pw = _ref_ckpt()
        ref = RO.MCSurrogate(CK, PW, proc, n_trials=n_trials, seed=3,
                             engine_kind=kind)
        got = PO.MCSurrogate(ck, pw, tproc, n_trials=n_trials,
                             rng=np.random.default_rng(3), engine_kind=kind,
                             device=CPU)
        return ref, got

    @pytest.mark.parametrize("which", ["exponential", "weibull"])
    def test_surrogate_call_within_1e12(self, which):
        proc, tproc = ((None, None) if which == "exponential"
                       else (Weibull(shape=0.7), PC.Weibull(shape=0.7)))
        ref, got = self._pair(proc, tproc)
        assert (got.lo, got.hi, got.T_base) == (ref.lo, ref.hi, ref.T_base)
        Ts = np.linspace(got.lo * 1.1, got.hi * 0.9, 6)
        a, b = ref(Ts), got(Ts)
        for k in ("time", "energy", "time_se", "energy_se"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, err_msg=k)

    def test_surrogate_step_kind_matches_reference(self):
        ck, pw = _ref_ckpt()
        kw = dict(T_base=1500.0, n_trials=8)
        ref = RO.MCSurrogate(CK, PW, None, seed=1, engine_kind="step", **kw)
        got = PO.MCSurrogate(ck, pw, None, rng=np.random.default_rng(1),
                             engine_kind="step", device=CPU, **kw)
        Ts = [60.0, 90.0]
        for k, v in ref(Ts).items():
            np.testing.assert_allclose(got(Ts)[k], v, rtol=1e-12)

    def test_argmins_within_1e6(self):
        ref, got = self._pair(Weibull(shape=0.7), PC.Weibull(shape=0.7))
        for key in ("time", "energy"):
            a, b = ref.argmin(key), got.argmin(key)
            assert abs(b - a) <= 1e-6 * abs(a), key
        assert set(got._first_evals) == {17}

    def test_mc_solvers_and_evaluate_periods(self):
        ck, pw = _ref_ckpt()
        Ts = [70.0, 90.0, 120.0]
        a = RO.mc_evaluate_periods(Ts, CK, PW, Weibull(shape=0.7),
                                   n_trials=24, seed=7)
        b = PO.mc_evaluate_periods(Ts, ck, pw, PC.Weibull(shape=0.7),
                                   n_trials=24, rng=np.random.default_rng(7),
                                   device=CPU)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, err_msg=k)
        t_ref = RO.t_opt_time_mc(CK, n_trials=16, seed=2)
        t_got = PO.t_opt_time_mc(ck, n_trials=16,
                                 rng=np.random.default_rng(2), device=CPU)
        assert abs(t_got - t_ref) <= 1e-6 * t_ref
        e_ref = RO.t_opt_energy_mc(CK, PW, n_trials=16, seed=2)
        e_got = PO.t_opt_energy_mc(ck, pw, n_trials=16,
                                   rng=np.random.default_rng(2), device=CPU)
        assert abs(e_got - e_ref) <= 1e-6 * e_ref

    def test_evaluate_robustness_point(self):
        ck, pw = _ref_ckpt()
        a = RT.evaluate_robustness(CK, PW, Weibull(shape=0.7), n_trials=24,
                                   seed=4)
        b = PT.evaluate_robustness(ck, pw, PC.Weibull(shape=0.7),
                                   n_trials=24, rng=np.random.default_rng(4),
                                   device=CPU)
        for f in ("T_exp_time", "T_exp_energy", "T_young", "T_daly"):
            assert abs(getattr(b, f) - getattr(a, f)) <= \
                1e-12 * abs(getattr(a, f)), f
        for f in ("T_mc_time", "T_mc_energy"):
            assert abs(getattr(b, f) - getattr(a, f)) <= \
                1e-6 * abs(getattr(a, f)), f
        assert b.energy_left_on_table == pytest.approx(
            a.energy_left_on_table, rel=1e-6, abs=1e-9)
        assert b.time_left_on_table == pytest.approx(
            a.time_left_on_table, rel=1e-6, abs=1e-9)


class TestRobustnessGrids:
    PERIODS = ("T_exp_time", "T_exp_energy", "T_young", "T_daly",
               "T_mc_time", "T_mc_energy")
    PENALTIES = ("time_penalty_exp", "energy_penalty_exp",
                 "time_penalty_young", "time_penalty_daly",
                 "energy_penalty_young", "energy_penalty_daly")

    def test_sweep_weibull_shapes_matches_reference(self):
        ref = RS.sweep_weibull_shapes([0.7, 1.0], [300.0], n_trials=48,
                                      seed=0)
        got = TS.sweep_weibull_shapes([0.7, 1.0], [300.0], n_trials=48,
                                      rng=np.random.default_rng(0),
                                      device=CPU)
        # the same candidate picks: the reported periods are grid
        # candidates, so equal picks give periods equal to 1e-12
        for f in self.PERIODS:
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                       rtol=1e-12, err_msg=f)
        np.testing.assert_allclose(got.eval_periods, ref.eval_periods,
                                   rtol=1e-12)
        np.testing.assert_allclose(got.T_base, ref.T_base, rtol=1e-12)
        for f in self.PENALTIES + ("wall_mc", "energy_mc", "wall_mc_se",
                                   "energy_mc_se"):
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                       rtol=1e-10, err_msg=f)
        assert bool(got.valid.all()) and got.n_trials == 48

        a = RS.evaluate_periods_grid(ref.grid, ref.process, ref.eval_periods,
                                     T_base=ref.T_base, n_trials=48, seed=1)
        b = TS.evaluate_periods_grid(got.grid, got.process, got.eval_periods,
                                     T_base=got.T_base, n_trials=48,
                                     rng=np.random.default_rng(1),
                                     device=CPU)
        for k in a:
            assert b[k].shape == (6, 2, 1)
            np.testing.assert_allclose(b[k], a[k], rtol=1e-10, err_msg=k)

    def test_degenerate_grid_raises(self):
        grid, proc = TS.robustness_grid([0.7], [12.0], device=CPU)
        with pytest.raises(ValueError, match="degenerate"):
            TS.evaluate_robustness_grid(grid, proc, n_trials=4,
                                        rng=np.random.default_rng(0),
                                        device=CPU)


class TestDevices:
    @pytest.mark.parametrize("call", [
        lambda: TE.simulate_candidates([60.0], _grid1()[1], n_trials=2),
        lambda: PO.MCSurrogate(*_ref_ckpt(), n_trials=2,
                               rng=np.random.default_rng(0)),
        lambda: TS.sweep_weibull_shapes([0.7], [300.0], n_trials=2,
                                        rng=np.random.default_rng(0)),
    ], ids=["simulate_candidates", "MCSurrogate", "sweep_weibull_shapes"])
    def test_default_device_raises_without_cuda(self, call):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="cuda"):
            call()

    @pytest.mark.gpu
    def test_stride0_launch_on_the_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (chip_smoke.py runs this check "
                        "on the card)")
        g1, t1 = _grid1()
        Ts = np.linspace(40.0, 150.0, 5)
        gaps = RE.presample_gaps(g1, 64, 256, seed=8)
        before = ES.event_sweep.launches
        got = TE.simulate_candidates(Ts, t1.to("cuda"), T_base=6000.0,
                                     gaps=gaps)
        assert ES.event_sweep.launches == before + 1
        cpu = TE.simulate_candidates(Ts, t1, T_base=6000.0, gaps=gaps,
                                     device=CPU)
        for f in FIELDS:
            assert torch.equal(getattr(got, f).cpu(), getattr(cpu, f)), f
