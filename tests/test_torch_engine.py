"""The port's event engine (its kernel's plain version, on the CPU) against
the JAX package's ``simulate_trajectories(engine_kind="event", gaps=...)``.

The reference's Pallas kernel does not trace on this JAX version, so its
reference here is the scan kernel ``_run_one_event``, which by the
reference's own contract it equals bit for bit.  Schedules are made with
numpy from a seed and handed to both engines.

Tolerances: bitwise on dyadic schedules (every quantity exactly
representable).  On ordinary schedules floats agree to 1e-13 relative;
failure counts and flags exactly; checkpoint counts may differ by exactly
one in at most 0.5% of lanes — a rounding tie in
``j = floor((rem - eps)/w)`` that XLA and eager PyTorch can round to
different sides, with the wall time unchanged.  Compensated f32 against
f64: rtol 1e-5 per lane with equal failure counts (the reference's gate).
"""
import math
import shutil

import numpy as np
import pytest
import torch

import repro.sim as RS
from repro.core import (EXASCALE_POWER_RHO55, Exponential, LogNormal,
                        TraceReplay, Weibull, fig12_checkpoint)
from repro.sim.engine import presample_gaps

import repro_torch.core as PC
import repro_torch.sim as TS
from repro_torch import interop
from repro_torch.kernels import _build
from repro_torch.kernels import event_sweep as ES
from repro_torch.sim import engine as TE

CPU = "cpu"
CK = fig12_checkpoint(300.0)
PW = EXASCALE_POWER_RHO55
FIELDS = ("wall_time", "energy", "work_executed", "io_time", "down_time",
          "n_failures", "n_checkpoints", "truncated", "gaps_exhausted")
FLOATS = FIELDS[:5]

PROCESSES = [Exponential(), Weibull(shape=0.6), LogNormal(sigma=1.0),
             TraceReplay(gaps=[40.0, 500.0, 120.0, 90.0, 800.0, 33.0])]
PORT_PROCESSES = [PC.Exponential(), PC.Weibull(shape=0.6),
                  PC.LogNormal(sigma=1.0),
                  PC.TraceReplay(gaps=(40.0, 500.0, 120.0, 90.0, 800.0,
                                       33.0))]
PIDS = [p.name for p in PROCESSES]


def _dyadic(gaps):
    return np.maximum(np.round(gaps * 2.0**16) / 2.0**16, 2.0**-16)


def _grid1():
    g = RS.ParamGrid.from_params(CK, PW).reshape((1,))
    return g, interop.grid_from_fields(g.fields(), device=CPU)


def _np(tb, name):
    return getattr(tb, name).numpy() if isinstance(getattr(tb, name),
                                                   torch.Tensor) \
        else np.asarray(getattr(tb, name))


def _assert_bitwise(ref, got, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(_np(got, f), _np(ref, f),
                                      err_msg=f"{msg}/{f}")


class TestEventParity:
    @pytest.mark.parametrize("proc", PROCESSES, ids=PIDS)
    def test_bitwise_on_dyadic_schedule(self, proc):
        g, tg = _grid1()
        gaps = _dyadic(presample_gaps(g, 64, 128, seed=9, process=proc))
        ref = RS.simulate_trajectories(60.0, g, T_base=3000.0, gaps=gaps,
                                       engine_kind="event")
        got = TS.simulate_trajectories(60.0, tg, T_base=3000.0, gaps=gaps,
                                       device=CPU)
        assert not got.truncated.any()
        _assert_bitwise(ref, got, proc.name)

    @pytest.mark.parametrize("proc", PROCESSES, ids=PIDS)
    def test_ordinary_schedule_tolerances(self, proc):
        grid = RS.mu_rho_grid([120.0, 300.0, 900.0], [2.0, 7.0])
        tg = interop.grid_from_fields(grid.fields(), device=CPU)
        gaps = presample_gaps(grid, 256, 256, seed=3, process=proc)
        T = np.array([[41.3, 47.9], [63.7, 70.1], [111.1, 131.9]])
        ref = RS.simulate_trajectories(T, grid, T_base=3000.0, gaps=gaps,
                                       engine_kind="event")
        got = TS.simulate_trajectories(T, tg, T_base=3000.0, gaps=gaps,
                                       device=CPU)
        for f in FLOATS:
            np.testing.assert_allclose(_np(got, f), _np(ref, f), rtol=1e-13,
                                       atol=0.0, err_msg=f)
        for f in ("n_failures", "truncated", "gaps_exhausted"):
            np.testing.assert_array_equal(_np(got, f), _np(ref, f))
        dc = _np(got, "n_checkpoints").astype(np.int64) - _np(
            ref, "n_checkpoints")
        assert np.abs(dc).max() <= 1
        assert np.count_nonzero(dc) <= 0.005 * dc.size

    def test_exhaustion_and_truncation_flags(self):
        g, tg = _grid1()
        gaps = np.array([50.0, 70.0])       # far too short for T_base=4000
        ref = RS.simulate_trajectories(60.0, g, T_base=4000.0, gaps=gaps,
                                       engine_kind="event")
        got = TS.simulate_trajectories(60.0, tg, T_base=4000.0, gaps=gaps,
                                       device=CPU)
        assert bool(got.gaps_exhausted.all())
        _assert_bitwise(ref, got)
        tiny = TS.simulate_trajectories(60.0, tg, T_base=50000.0, n_trials=4,
                                        seed=0, n_steps=2, device=CPU)
        assert bool(tiny.truncated.any())
        ref_gaps = presample_gaps(g, 4, 64, seed=1)
        a = RS.simulate_trajectories(60.0, g, T_base=50000.0, gaps=ref_gaps,
                                     n_steps=2, engine_kind="event")
        b = TS.simulate_trajectories(60.0, tg, T_base=50000.0, gaps=ref_gaps,
                                     n_steps=2, device=CPU)
        _assert_bitwise(a, b)

    def test_mixed_scenario_parameter_batch(self):
        scens = [RS.get_scenario("fig12", mu_min=120.0),
                 RS.get_scenario("exascale_rho7", mu_min=300.0),
                 RS.get_scenario("fig3", n_nodes=2e6)]
        grid = RS.grid_from_scenarios(scens)
        tg = interop.grid_from_fields(grid.fields(), device=CPU)
        rng = np.random.default_rng(5)
        gaps = _dyadic(rng.exponential(1.0, size=(3, 16, 96))
                       * grid.mu[:, None, None])
        T = np.array([40.0, 60.0, 9.0])
        ref = RS.simulate_trajectories(T, grid, T_base=500.0, gaps=gaps,
                                       engine_kind="event")
        got = TS.simulate_trajectories(T, tg, T_base=500.0, gaps=gaps,
                                       device=CPU)
        _assert_bitwise(ref, got)

    def test_scalar_oracle_agrees_on_shared_schedule(self):
        g, tg = _grid1()
        gaps = presample_gaps(g, 8, 128, seed=12, process=Weibull(shape=0.7))
        got = TS.simulate_trajectories(53.3, tg, T_base=3000.0, gaps=gaps,
                                       device=CPU)
        tck = tg.ckpt_at(0)
        tpw = tg.power_at(0)
        for k in range(8):
            a = PC.simulate_once(53.3, tck, tpw, 3000.0,
                                 rng=TS.ScheduledRNG(gaps[0, k]))
            b = PC.simulate_once(53.3, tck, tpw, 3000.0, gaps=gaps[0, k])
            assert a == b
            assert math.isclose(float(got.wall_time[0, k]), a.wall_time,
                                rel_tol=1e-12)
            assert int(got.n_failures[0, k]) == a.n_failures


class TestPrecision:
    @pytest.mark.parametrize("proc", [PORT_PROCESSES[0], PORT_PROCESSES[1]],
                             ids=["exponential", "weibull"])
    def test_compensated_f32_close_to_f64(self, proc):
        _, tg = _grid1()
        kw = dict(T_base=1500.0, n_trials=64, seed=3, process=proc,
                  device=CPU)
        r64 = TS.simulate_trajectories(60.0, tg, precision="f64", **kw)
        r32 = TS.simulate_trajectories(60.0, tg,
                                       precision=TS.COMPENSATED_F32, **kw)
        assert torch.equal(r64.n_failures, r32.n_failures)
        for f in ("wall_time", "energy", "work_executed", "io_time"):
            np.testing.assert_allclose(_np(r32, f), _np(r64, f), rtol=1e-5,
                                       err_msg=f)

    def test_cpu_default_policy_is_f64(self):
        _, tg = _grid1()
        kw = dict(T_base=1500.0, n_trials=16, seed=4, device=CPU)
        _assert_bitwise(TS.simulate_trajectories(60.0, tg, **kw),
                        TS.simulate_trajectories(60.0, tg, precision="f64",
                                                 **kw))


class TestBudgetsAndSampling:
    @pytest.mark.parametrize("proc,tproc", [
        (None, None), (Weibull(shape=0.7), PC.Weibull(shape=0.7)),
        (LogNormal(sigma=1.5), PC.LogNormal(sigma=1.5)),
        (Weibull(shape=np.array([0.5, 0.9, 1.4])),
         PC.Weibull(shape=np.array([0.5, 0.9, 1.4])))],
        ids=["none", "weibull", "lognormal", "weibull_array"])
    def test_fail_capacity_points_match_reference(self, proc, tproc):
        grid = RS.mu_rho_grid([60.0, 300.0, 1200.0], [3.0])
        tg = interop.grid_from_fields(grid.fields(), device=CPU)
        T = np.array([[30.0], [70.0], [150.0]])
        # the engine's flat per-point call, and a grid-shaped call
        for args, targs in (((T.ravel(), grid.ravel()),
                             (T.ravel(), tg.ravel())),
                            ((T, grid), (T, tg))):
            for T_base in (1000.0, 4000.0):
                a = RS.fail_capacity_points(*args, T_base, process=proc)
                b = TS.fail_capacity_points(*targs, T_base, process=tproc)
                np.testing.assert_array_equal(a, b)
                assert TS.default_fail_capacity(
                    *targs, T_base, process=tproc) == int(a.max())

    @pytest.mark.parametrize("i", range(len(PROCESSES)), ids=PIDS)
    def test_auto_sampled_means_within_4_se(self, i):
        grid = RS.mu_rho_grid([150.0, 600.0], [5.5])
        tg = interop.grid_from_fields(grid.fields(), device=CPU)
        T = np.array([[45.0], [95.0]])
        ref = RS.simulate_trajectories(T, grid, T_base=2000.0, n_trials=256,
                                       seed=1, process=PROCESSES[i],
                                       engine_kind="event")
        got = TS.simulate_trajectories(T, tg, T_base=2000.0, n_trials=256,
                                       seed=1, process=PORT_PROCESSES[i],
                                       device=CPU)
        assert not got.truncated.any() and not got.gaps_exhausted.any()
        for f in ("wall_time", "energy"):
            a, b = _np(ref, f), _np(got, f)
            se = np.sqrt(a.var(-1, ddof=1) / a.shape[-1]
                         + b.var(-1, ddof=1) / b.shape[-1])
            assert np.all(np.abs(a.mean(-1) - b.mean(-1)) <= 4.0 * se), f

    def test_seed_is_deterministic_and_blocking_is_stable(self):
        grid = TS.mu_rho_grid([120.0, 300.0, 900.0], [2.0, 7.0], device=CPU)
        T = torch.tensor([[40.0, 45.0], [60.0, 70.0], [110.0, 130.0]],
                         dtype=torch.float64)
        kw = dict(T_base=2000.0, n_trials=32, seed=5,
                  process=PC.Weibull(shape=0.7), device=CPU)
        a = TS.simulate_trajectories(T, grid, **kw)
        b = TS.simulate_trajectories(T, grid, **kw)
        _assert_bitwise(a, b)
        cfg = TS.DispatchConfig(memory_mb=1)
        c = TS.simulate_trajectories(T, grid, dispatch=cfg, **kw)
        d = TS.simulate_trajectories(T, grid, dispatch=cfg, **kw)
        _assert_bitwise(c, d)
        blocks = list(TS.sampled_schedules(T, grid, dispatch=cfg, **{
            k: v for k, v in kw.items()}))
        assert len(blocks) > 1
        again = list(TS.sampled_schedules(T, grid, dispatch=cfg, **kw))
        for x, y in zip(blocks, again):
            assert torch.equal(x.gaps, y.gaps) and x.trials == y.trials
        # the engine consumes exactly these schedules
        out = TE._run_blocks(iter(blocks), grid.ravel(), T.reshape(-1),
                            torch.full((6,), 2000.0, dtype=torch.float64),
                            32, TS.F64)
        assert torch.equal(out["wall_time"].reshape(3, 2, 32), c.wall_time)

    @staticmethod
    def _lane_rows(blocks):
        """{(point, trial): gap row} over a schedule's blocks."""
        rows = {}
        for blk in blocks:
            for a, p in enumerate(blk.points.tolist()):
                for b, t in enumerate(blk.trials):
                    rows[(p, t)] = blk.gaps[a, b]
        return rows

    @pytest.mark.parametrize("i", range(len(PORT_PROCESSES)), ids=PIDS)
    def test_auto_sampled_draws_do_not_depend_on_dispatch(self, i):
        """A lane's gaps are a function of (seed, point, trial, gap index,
        process) alone: chunk size and memory budget are bit-exact no-ops
        for auto-sampled schedules, as in the reference."""
        grid = TS.mu_rho_grid([120.0, 300.0, 900.0], [2.0, 7.0], device=CPU)
        T = torch.tensor([[40.0, 45.0], [60.0, 70.0], [110.0, 130.0]],
                         dtype=torch.float64)
        kw = dict(T_base=2000.0, n_trials=700, seed=5,
                  process=PORT_PROCESSES[i], device=CPU)
        ref = TS.simulate_trajectories(T, grid, **kw)
        ref_blocks = list(TS.sampled_schedules(T, grid, **kw))
        ref_rows = self._lane_rows(ref_blocks)
        assert len(ref_rows) == 6 * 700
        n_blocks = {len(ref_blocks)}
        for cfg in (TS.DispatchConfig(chunk=1), TS.DispatchConfig(chunk=7),
                    TS.DispatchConfig(memory_mb=1)):
            blocks = list(TS.sampled_schedules(T, grid, dispatch=cfg, **kw))
            n_blocks.add(len(blocks))
            rows = self._lane_rows(blocks)
            assert rows.keys() == ref_rows.keys()
            for lane, row in rows.items():
                assert torch.equal(row, ref_rows[lane]), (cfg, lane)
            _assert_bitwise(ref, TS.simulate_trajectories(
                T, grid, dispatch=cfg, **kw), str(cfg))
        assert len(n_blocks) > 1        # the configs did cut differently

    def test_lane_gaps_do_not_depend_on_capacity(self):
        """A longer run (larger pow2 capacity) extends each lane's schedule
        and keeps its first gaps."""
        grid = TS.mu_rho_grid([300.0], [5.5], device=CPU)
        kw = dict(n_trials=16, seed=9, process=PC.Weibull(shape=0.7),
                  device=CPU)
        short = list(TS.sampled_schedules(60.0, grid, T_base=1000.0, **kw))
        long = list(TS.sampled_schedules(60.0, grid, T_base=8000.0, **kw))
        a, b = short[0].gaps, long[0].gaps
        assert a.shape[-1] < b.shape[-1]
        assert torch.equal(a, b[..., :a.shape[-1]])

    def test_explicit_schedule_blocking_is_bitwise_noop(self):
        grid = RS.mu_rho_grid([120.0, 300.0, 900.0], [2.0, 7.0])
        tg = interop.grid_from_fields(grid.fields(), device=CPU)
        gaps = presample_gaps(grid, 40, 128, seed=8)
        T = np.array([[40.0, 45.0], [60.0, 70.0], [110.0, 130.0]])
        a = TS.simulate_trajectories(T, tg, T_base=2000.0, gaps=gaps,
                                     device=CPU)
        for cfg in (TS.DispatchConfig(memory_mb=1), TS.DispatchConfig(chunk=1)):
            b = TS.simulate_trajectories(T, tg, T_base=2000.0, gaps=gaps,
                                         dispatch=cfg, device=CPU)
            _assert_bitwise(a, b)

    def test_presample_gaps_matches_reference(self):
        grid = RS.mu_rho_grid([120.0, 300.0], [2.0])
        tg = interop.grid_from_fields(grid.fields(), device=CPU)
        for proc, tproc in ((None, None),
                            (Weibull(shape=0.7), PC.Weibull(shape=0.7))):
            a = presample_gaps(grid, 4, 16, seed=3, process=proc)
            b = TS.presample_gaps(tg, 4, 16, np.random.default_rng(3),
                                  process=tproc)
            np.testing.assert_array_equal(a, b)


class TestSimulateGrid:
    def test_summaries_match_reference_on_shared_schedule(self):
        grid = RS.mu_rho_grid([120.0, 600.0], [2.0, 7.0])
        tg = interop.grid_from_fields(grid.fields(), device=CPU)
        gaps = presample_gaps(grid, 64, 256, seed=2)
        T = np.array([[45.0, 50.0], [100.0, 120.0]])
        a = RS.simulate_grid(T, grid, T_base=2000.0, gaps=gaps)
        b = TS.simulate_grid(T, tg, T_base=2000.0, gaps=gaps, device=CPU)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k], rtol=1e-12,
                                       err_msg=k)

    def test_raises_on_truncation_and_exhaustion(self):
        _, tg = _grid1()
        with pytest.raises(RuntimeError, match="step budget"):
            TS.simulate_grid(60.0, tg, T_base=50000.0, n_trials=4, n_steps=2,
                             device=CPU)
        with pytest.raises(RuntimeError, match="exhausted"):
            TS.simulate_grid(60.0, tg, T_base=4000.0,
                             gaps=np.array([50.0, 70.0]), device=CPU)

    def test_period_too_short_raises(self):
        _, tg = _grid1()
        with pytest.raises(ValueError, match="too short"):
            TS.simulate_trajectories(4.0, tg, T_base=100.0, device=CPU)


class TestDevices:
    """On a machine without CUDA, an entry point left at its default
    ``device="cuda"`` raises instead of running on the CPU."""

    @pytest.mark.parametrize("call", [
        lambda: TS.mu_rho_grid([300.0], [5.5]),
        lambda: TS.evaluate_grid(TS.mu_rho_grid([300.0], [5.5], device=CPU)),
        lambda: TS.simulate_trajectories(
            60.0, TS.mu_rho_grid([300.0], [5.5], device=CPU), n_trials=4),
        lambda: TS.simulate_grid(
            60.0, TS.mu_rho_grid([300.0], [5.5], device=CPU), n_trials=4),
        lambda: PC.time_final(60.0, PC.fig12_checkpoint(300.0)),
        lambda: PC.t_opt_energy(PC.fig12_checkpoint(300.0),
                                PC.EXASCALE_POWER_RHO55),
        lambda: interop.schedule_to_device(np.ones(3)),
        lambda: PC.Exponential().sample_gaps(None, (1, 2), mean=1.0),
    ], ids=["grid", "evaluate_grid", "simulate_trajectories",
            "simulate_grid", "time_final", "t_opt_energy",
            "schedule_to_device", "sample_gaps"])
    def test_default_device_raises_without_cuda(self, call):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="cuda"):
            call()


class TestKernelWrapper:
    def _args(self, dtype=torch.float64, B=3, N=5, F=32, seed=0):
        rng = np.random.default_rng(seed)
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)
        T = t(rng.uniform(30.0, 80.0, B))
        C, R, D = t(np.full(B, 10.0)), t(np.full(B, 10.0)), t(np.full(B, 1.0))
        O, TB = t(np.full(B, 0.5)), t(np.full(B, 2000.0))
        gaps = t(rng.exponential(300.0, size=(B, N, F)))
        return (T, C, R, D, O, TB, gaps)

    def test_cpu_tensors_take_the_plain_version(self):
        before_k, before_p = ES.event_sweep.launches, \
            ES.event_sweep_plain.calls
        args = self._args()
        a = ES.event_sweep(*args, n_steps=33)
        b = ES.event_sweep_plain(*args, n_steps=33)
        assert ES.event_sweep.launches == before_k
        assert ES.event_sweep_plain.calls == before_p + 2
        assert set(a) == set(ES.OUTPUT_KEYS)
        for k in a:
            assert torch.equal(a[k], b[k])
        assert a["wall_time"].dtype == torch.float64
        assert a["n_failures"].dtype == torch.int32
        assert a["truncated"].dtype == torch.bool

    def test_validation(self):
        T, C, R, D, O, TB, gaps = self._args()
        with pytest.raises(ValueError, match="B, N, F"):
            ES.event_sweep(T, C, R, D, O, TB, gaps[0], n_steps=4)
        with pytest.raises(ValueError, match="shape"):
            ES.event_sweep(T[:2], C, R, D, O, TB, gaps, n_steps=4)
        with pytest.raises(TypeError, match="float"):
            ES.event_sweep(T, C, R, D, O, TB, gaps.to(torch.int64),
                           n_steps=4)
        with pytest.raises(TypeError):
            ES.event_sweep(T.float(), C, R, D, O, TB, gaps, n_steps=4)
        with pytest.raises(ValueError, match="n_steps"):
            ES.event_sweep(T, C, R, D, O, TB, gaps, n_steps=-1)

    def test_compensated_plain_version_in_f32(self):
        args64 = self._args(seed=4)
        args32 = tuple(x.float() for x in args64)
        a = ES.event_sweep(*args64, n_steps=33)
        b = ES.event_sweep(*args32, n_steps=33, compensated=True)
        assert torch.equal(a["n_failures"], b["n_failures"])
        np.testing.assert_allclose(b["wall_time"].numpy(),
                                   a["wall_time"].numpy(), rtol=1e-5)

    def test_build_needs_nvcc(self, monkeypatch):
        if shutil.which("nvcc") or torch.cuda.is_available():
            pytest.skip("a CUDA toolkit is present")
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.find_nvcc()
        path = _build.library_path("event_sweep.cu")
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith("event_sweep_")
        assert "-fmad=false" in _build.NVCC_FLAGS

    @pytest.mark.gpu
    def test_kernel_matches_plain_version_on_the_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (chip_smoke.py runs this check "
                        "on the card)")
        for dtype, comp in ((torch.float64, False), (torch.float32, True)):
            args = tuple(x.to("cuda") for x in self._args(dtype, 37, 333,
                                                          200))
            before = ES.event_sweep.launches
            a = ES.event_sweep(*args, n_steps=201, compensated=comp)
            b = ES.event_sweep_plain(*args, n_steps=201, compensated=comp)
            assert ES.event_sweep.launches == before + 1
            for k in a:
                assert torch.equal(a[k], b[k]), k
