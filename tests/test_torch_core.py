"""The port's core (parameters, failure processes, closed forms, solvers,
scalar simulator) against the JAX package's core, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: closed forms 1e-13 relative (the same expressions in another
framework, each operation rounded once); closed-form periods 1e-12 (a
square root or a quadratic root on top); golden-section periods 1e-8 (the
search stops at a relative bracket of 1e-10, and flat-valley rounding of
the objective can move it by a few bracket widths); process moments 1e-14.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P

CPU = "cpu"

SCENARIOS = (
    [(f"fig12(mu={mu:g})/rho55", R.fig12_checkpoint(mu),
      R.EXASCALE_POWER_RHO55) for mu in (60.0, 120.0, 300.0, 600.0)]
    + [(f"fig12(mu={mu:g})/rho7", R.fig12_checkpoint(mu),
        R.EXASCALE_POWER_RHO7) for mu in (60.0, 120.0, 300.0, 600.0)]
    + [("fig3", R.fig3_checkpoint(1e6), R.EXASCALE_POWER_RHO55),
       ("jaguar", R.CheckpointParams.from_platform(
           n_nodes=45208, mu_ind=R.MU_IND_JAGUAR_MIN, C=10.0, R=10.0, D=1.0,
           omega=0.5), R.EXASCALE_POWER_RHO55)])
IDS = [s[0] for s in SCENARIOS]


def _port(ck, pw):
    return (P.CheckpointParams(**dataclasses.asdict(ck)),
            P.PowerParams(**dataclasses.asdict(pw)))


def _periods(ck, n=9, seed=0):
    """Periods spread over the valid range, from a seeded numpy draw."""
    lo, hi = ck.valid_period_range()
    u = np.sort(np.random.default_rng(seed).uniform(0.02, 0.98, n))
    return lo + u * (hi - lo)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


class TestParams:
    def test_derived_quantities_match(self):
        for _, ck, pw in SCENARIOS:
            tck, tpw = _port(ck, pw)
            assert (tck.a, tck.b) == (ck.a, ck.b)
            assert tck.valid_period_range() == ck.valid_period_range()
            assert (tpw.alpha, tpw.beta, tpw.gamma, tpw.rho) == \
                (pw.alpha, pw.beta, pw.gamma, pw.rho)

    def test_constructors_and_constants(self):
        assert P.PowerParams.from_rho(rho=7.0, alpha=2.0) == P.PowerParams(
            **dataclasses.asdict(R.PowerParams.from_rho(rho=7.0, alpha=2.0)))
        assert dataclasses.asdict(P.EXASCALE_POWER_RHO7) == \
            dataclasses.asdict(R.EXASCALE_POWER_RHO7)
        assert P.MU_IND_JAGUAR_MIN == R.MU_IND_JAGUAR_MIN
        assert dataclasses.asdict(P.fig3_checkpoint(2e5)) == \
            dataclasses.asdict(R.fig3_checkpoint(2e5))

    def test_validation_raises(self):
        with pytest.raises(ValueError, match="omega"):
            P.CheckpointParams(C=1.0, R=1.0, D=1.0, mu=10.0, omega=2.0)
        with pytest.raises(ValueError, match="mu"):
            P.CheckpointParams(C=1.0, R=1.0, D=1.0, mu=0.0)
        with pytest.raises(ValueError, match="P_static"):
            P.PowerParams(P_static=0.0, P_cal=1.0, P_io=1.0)
        with pytest.raises(ValueError, match="beta"):
            P.PowerParams.from_rho(rho=0.1, alpha=1.0)


class TestClosedForms:
    @pytest.mark.parametrize("name,ck,pw", SCENARIOS, ids=IDS)
    def test_model_functions(self, name, ck, pw):
        tck, tpw = _port(ck, pw)
        T = _periods(ck)
        pairs = [
            (R.model.time_final(T, ck, 3.0),
             P.time_final(T, tck, 3.0, device=CPU)),
            (R.model.time_final_prime(T, ck), P.time_final_prime(
                T, tck, device=CPU)),
            (R.model.time_fault_free(T, ck, 2.0), P.time_fault_free(
                T, tck, 2.0, device=CPU)),
            (R.model.time_lost_per_failure(T, ck), P.time_lost_per_failure(
                T, tck, device=CPU)),
            (R.model.expected_failures(T, ck), P.expected_failures(
                T, tck, device=CPU)),
            (R.model.energy_final(T, ck, pw, 5.0), P.energy_final(
                T, tck, tpw, 5.0, device=CPU)),
            (R.model.energy_final_prime(T, ck, pw), P.energy_final_prime(
                T, tck, tpw, device=CPU)),
            (R.model.K_factor(T, ck, pw), P.K_factor(T, tck, tpw,
                                                      device=CPU)),
        ]
        ph_r = R.model.phase_times(T, ck, 2.0)
        ph_t = P.phase_times(T, tck, 2.0, device=CPU)
        pairs += list(zip(ph_r, ph_t))
        for ref, got in pairs:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
            assert _rel(got.numpy(), ref) <= 1e-13

    @pytest.mark.parametrize("name,ck,pw", SCENARIOS, ids=IDS)
    def test_K_dE_dT_matches_reference_and_autograd(self, name, ck, pw):
        tck, tpw = _port(ck, pw)
        T = _periods(ck, seed=1)
        q = P.K_dE_dT(T, tck, tpw, device=CPU).numpy()
        # K*E' is a difference of large terms near its root: compare on
        # the scale of the product's terms, not its (small) value.
        scale = np.abs(R.model.K_factor(T, ck, pw)
                       * R.model.energy_final(T, ck, pw))
        assert np.max(np.abs(q - R.model.K_dE_dT(T, ck, pw)) / scale) <= 1e-13
        ad = P.K_dE_dT_autodiff(T, tck, tpw, device=CPU).numpy()
        assert np.max(np.abs(q - ad) / scale) <= 1e-12


class TestSolvers:
    @pytest.mark.parametrize("name,ck,pw", SCENARIOS, ids=IDS)
    def test_closed_form_periods(self, name, ck, pw):
        tck, tpw = _port(ck, pw)
        assert _rel(P.t_opt_time(tck, device=CPU), R.t_opt_time(ck)) <= 1e-12
        assert _rel(P.t_opt_energy(tck, tpw, device=CPU),
                    R.t_opt_energy(ck, pw)) <= 1e-12
        assert P.t_young(tck) == R.t_young(ck)
        assert P.t_daly(tck) == R.t_daly(ck)
        assert _rel(P.energy_quadratic_coefficients(tck, tpw, device=CPU),
                    R.energy_quadratic_coefficients(ck, pw)) <= 1e-8
        assert P.derived_coefficients(tck, tpw) == \
            R.optimal.derived_coefficients(ck, pw)
        ex_t, ex_r = P.t_opt_time_ex(tck, device=CPU), R.t_opt_time_ex(ck)
        assert (ex_t.clamped, ex_t.method) == (ex_r.clamped, ex_r.method)

    @pytest.mark.parametrize("name,ck,pw", SCENARIOS, ids=IDS)
    def test_numeric_periods(self, name, ck, pw):
        tck, tpw = _port(ck, pw)
        for got, ref in (
                (P.t_opt_time_numeric(tck, device=CPU),
                 R.t_opt_time_numeric(ck)),
                (P.t_opt_energy_numeric(tck, tpw, device=CPU),
                 R.t_opt_energy_numeric(ck, pw)),
                (P.t_msk_energy(tck, tpw, device=CPU),
                 R.t_msk_energy(ck, pw))):
            assert _rel(got, ref) <= 1e-8

    @pytest.mark.parametrize("strategy", P.STRATEGIES)
    def test_period_for(self, strategy):
        ck, pw = R.fig12_checkpoint(300.0), R.EXASCALE_POWER_RHO7
        tck, tpw = _port(ck, pw)
        assert _rel(P.period_for(strategy, tck, tpw, device=CPU),
                    R.period_for(strategy, ck, pw)) <= 1e-8

    def test_golden_section_and_bad_inputs(self):
        f = lambda x: (x - 2.5) ** 2 + 1.0
        assert P.golden_section(f, 0.0, 10.0) == R.golden_section(f, 0.0,
                                                                  10.0)
        with pytest.raises(ValueError, match="No valid period"):
            P.t_opt_time(P.CheckpointParams(C=10.0, R=10.0, D=1.0, mu=5.0),
                         device=CPU)
        with pytest.raises(ValueError, match="unknown strategy"):
            P.period_for("warp", P.fig12_checkpoint(300.0), device=CPU)
        with pytest.raises(ValueError, match="PowerParams"):
            P.period_for("algo_e", P.fig12_checkpoint(300.0), device=CPU)

    def test_omega_one_numeric_fallback(self):
        ck = R.CheckpointParams(C=5.0, R=5.0, D=1.0, mu=300.0, omega=1.0)
        tck = P.CheckpointParams(**dataclasses.asdict(ck))
        got = P.t_opt_time_ex(tck, device=CPU)
        assert got.method == "numeric"
        assert _rel(got.T, R.t_opt_time_ex(ck).T) <= 1e-8


PROCESS_PAIRS = [
    (R.Exponential(), P.Exponential()),
    (R.Weibull(shape=0.6), P.Weibull(shape=0.6)),
    (R.Weibull(shape=np.array([0.5, 0.7, 1.5])),
     P.Weibull(shape=np.array([0.5, 0.7, 1.5]))),
    (R.LogNormal(sigma=1.0), P.LogNormal(sigma=1.0)),
    (R.TraceReplay(gaps=(40.0, 500.0, 120.0, 90.0, 800.0, 33.0)),
     P.TraceReplay(gaps=(40.0, 500.0, 120.0, 90.0, 800.0, 33.0))),
]
PROC_IDS = ["exponential", "weibull", "weibull_array", "lognormal", "trace"]


class TestFailureProcesses:
    @pytest.mark.parametrize("ref,port", PROCESS_PAIRS, ids=PROC_IDS)
    def test_moments_and_hazard(self, ref, port):
        mean = 300.0
        assert _rel(port.resolve_mean(mean), ref.resolve_mean(mean)) <= 1e-14
        assert _rel(port.gap_cv(), ref.gap_cv()) <= 1e-14
        if isinstance(ref, R.TraceReplay):
            return
        t = np.geomspace(1.0, 3000.0, 7)
        if np.ndim(getattr(ref, "shape", 0.0)):
            t = t[:, None]
        h_ref = ref.hazard(t, mean=mean)
        h = port.hazard(t, mean=mean, device=CPU)
        assert _rel(h.numpy(), h_ref) <= 1e-14

    @pytest.mark.parametrize("ref,port", PROCESS_PAIRS, ids=PROC_IDS)
    def test_host_sampler_is_the_reference_stream(self, ref, port):
        lead = np.size(getattr(ref, "shape", 0.0))
        size = (lead, 4, 16)
        mean = np.full(lead, 120.0)[:, None, None]
        a = ref.sample(np.random.default_rng(3), size=size, mean=mean)
        b = port.sample(np.random.default_rng(3), size=size, mean=mean)
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("ref,port", PROCESS_PAIRS, ids=PROC_IDS)
    def test_device_sampler_mean_within_4_se(self, ref, port):
        lead = np.size(getattr(ref, "shape", 0.0))
        mean = 250.0
        key = P.CounterKey(11, torch.arange(lead), torch.arange(64))
        g = port.sample_gaps(key, (lead, 64, 512),
                             mean=torch.full((lead,), mean,
                                             dtype=torch.float64),
                             device=CPU).numpy()
        assert g.dtype == np.float64 and np.all(g > 0)
        for row in g.reshape(lead, -1):
            se = row.std(ddof=1) / math.sqrt(row.size)
            assert abs(row.mean() - mean) <= 4.0 * se, (row.mean(), se)

    def test_philox_known_answers_and_counter_streams(self):
        """Philox-4x32-10 against the Random123 known-answer vectors; a
        lane's uniforms depend on (seed, point, trial, index) alone."""
        t = lambda v: torch.tensor(v, dtype=torch.int64)
        kat = [((0, 0, 0, 0), (0, 0),
                (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
               ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
                (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
               ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                (0xA4093822, 0x299F31D0),
                (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
        for ctr, key, want in kat:
            got = P.philox.philox4x32(*[t(c) for c in ctr], *key)
            assert [int(w) for w in got] == list(want)
        u = P.CounterKey(3, torch.arange(4), torch.arange(5)).uniforms(33)
        assert u.shape == (4, 5, 33) and u.dtype == torch.float64
        assert float(u.min()) > 0.0 and float(u.max()) < 1.0
        sub = P.CounterKey(3, torch.tensor([2, 0]),
                           torch.tensor([4, 1])).uniforms(7)
        assert torch.equal(sub[0, 0], u[2, 4, :7])
        assert torch.equal(sub[1, 1], u[0, 1, :7])
        other = P.CounterKey(4, torch.arange(4), torch.arange(5)).uniforms(33)
        assert not torch.equal(u, other)

    def test_trace_replay_device_rows_are_cyclic_shifts(self):
        trace = (40.0, 500.0, 120.0, 90.0, 800.0, 33.0)
        port = P.TraceReplay(gaps=trace)
        key = P.CounterKey(5, torch.arange(2), torch.arange(8))
        g = port.sample_gaps(key, (2, 8, 15), mean=torch.tensor([
            port.mu, 2.0 * port.mu], dtype=torch.float64), device=CPU)
        tr = np.asarray(trace)
        for b, scale in ((0, 1.0), (1, 2.0)):
            for row in g[b].numpy():
                start = int(np.flatnonzero(tr * scale == row[0])[0])
                want = tr[(start + np.arange(15)) % tr.size] * scale
                np.testing.assert_array_equal(row, want)

    def test_registry_and_coercion(self):
        assert sorted(P.failures.PROCESSES) == sorted(
            R.failures.PROCESSES)
        assert isinstance(P.as_process(None), P.Exponential)
        assert isinstance(P.as_process("lognormal"), P.LogNormal)
        assert P.get_process("weibull", shape=0.5).shape == 0.5
        with pytest.raises(KeyError, match="unknown failure process"):
            P.get_process("gamma")
        with pytest.raises(TypeError):
            P.as_process(3)
        with pytest.raises(ValueError):
            P.Weibull(shape=-1.0)


class TestScalarSimulator:
    @pytest.mark.parametrize("ref,port", PROCESS_PAIRS[:2] + PROCESS_PAIRS[3:],
                             ids=["exponential", "weibull", "lognormal",
                                  "trace"])
    def test_simulate_once_with_gaps_equals_reference(self, ref, port):
        ck, pw = R.fig12_checkpoint(300.0), R.EXASCALE_POWER_RHO55
        tck, tpw = _port(ck, pw)
        gaps = ref.sample(np.random.default_rng(21), size=(6, 128),
                          mean=ck.mu)
        for row in gaps:
            a = R.simulate_once(57.3, ck, pw, 3000.0, None, gaps=row)
            b = P.simulate_once(57.3, tck, tpw, 3000.0, gaps=torch.as_tensor(
                row))
            assert dataclasses.asdict(a) == dataclasses.asdict(b)

    def test_simulate_equals_reference_stream(self):
        ck, pw = R.fig12_checkpoint(120.0), R.EXASCALE_POWER_RHO7
        tck, tpw = _port(ck, pw)
        for ref_p, port_p in ((None, None),
                              (R.Weibull(shape=0.7), P.Weibull(shape=0.7))):
            a = R.simulate(40.0, ck, pw, 1500.0, n_trials=40, seed=4,
                           process=ref_p)
            b = P.simulate(40.0, tck, tpw, 1500.0, np.random.default_rng(4),
                           n_trials=40, process=port_p)
            assert a == b

    def test_exhaustion_and_budget_raise(self):
        tck, tpw = _port(R.fig12_checkpoint(300.0), R.EXASCALE_POWER_RHO55)
        with pytest.raises(RuntimeError, match="exhausted"):
            P.simulate_once(60.0, tck, tpw, 4000.0, gaps=[50.0, 70.0])
        with pytest.raises(RuntimeError, match="event budget"):
            P.simulate_once(60.0, tck, tpw, 4000.0, gaps=[1e9],
                            max_events=3)
        with pytest.raises(ValueError, match="too short"):
            P.simulate_once(4.0, tck, tpw, 100.0, gaps=[1e9])
