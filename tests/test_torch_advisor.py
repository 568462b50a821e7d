"""The checkpoint-advisor service, port against reference: the request
schema, fingerprint keys and certificates, the batcher and the service
(batching, the fingerprint cache, the tolerance contract), the threaded
front end, the load generator, the launcher, ``bench_advisor``, the named
cache registry, ``backend_info`` and the kernel-build cache.

Requests come from the reference's ``synthetic_requests(n, seed=s)`` and
the port's ``synthetic_requests(n, np.random.default_rng(s))``, which draw
the same platforms.  The port runs on the CPU (``device="cpu"``).
Tolerances:

* request fields, quantized requests and cache keys equal;
* certificates on the same fields and periods within 1e-12 relative
  (bitwise in practice), with equal certified flags;
* ``advise_many`` in f64 against the reference's jitted run: periods and
  predictions within 1e-13 relative, the same m picks, stores and flags;
  the AlgoE period of a two-tier lane within 1e-11 (1.36e-12 measured
  on these seeds), its objective within 1e-13 (XLA contracts the
  reference's ``a + b * c`` into FMAs, and the flat valley of the energy
  objective magnifies that ulp into the argmin, as
  ``tests/test_torch_multilevel.py`` records for the grid solver);
  against the reference run op by op (``jax.disable_jit()``) bit for
  bit, certificates included;
* the reference's own advisor contract (``tests/test_advisor.py``)
  ported onto the port: batched equal to sequential bit for bit, one
  solve per request shape, served objectives within the certified bound
  of an exact solve.
"""
import dataclasses
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.serve as RS

import repro_torch.serve as PS
import repro_torch.sim as TS
from repro_torch import interop
from repro_torch.benchmarks import bench_advisor
from repro_torch.kernels import _build
from repro_torch.serve import batcher as PB
from repro_torch.sim import cache as PC
from repro_torch.sim import dispatch as PD
from repro_torch.sim import sweep as TSW
from repro_torch.sim.precision import use_policy, trace_policy

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
QUANT = PS.Quantization()
EXACT_Q = PS.Quantization(rel=0.0, absolute=0.0)
NAN_EQ = lambda x, y: x == y or (isinstance(x, float) and math.isnan(x)
                                 and math.isnan(y))


def _port_reqs(n, seed, **kw):
    return PS.synthetic_requests(n, np.random.default_rng(seed), **kw)


def _svc(**kw):
    return PS.AdvisorService(cache_name=kw.pop("cache_name", None),
                             device=CPU, **kw)


def _mixed_workload(n=48, seed=7, repeat_frac=0.25):
    return _port_reqs(n, seed, two_tier_frac=0.5, repeat_frac=repeat_frac)


def _same_advice(a, b) -> bool:
    """Bitwise equality of the served numbers (NaN == NaN)."""
    return (NAN_EQ(a.period, b.period) and a.deep_every == b.deep_every
            and a.store == b.store
            and NAN_EQ(a.predicted_wall, b.predicted_wall)
            and NAN_EQ(a.predicted_energy, b.predicted_energy)
            and NAN_EQ(a.T_time, b.T_time) and NAN_EQ(a.T_energy, b.T_energy)
            and a.m_time == b.m_time and a.m_energy == b.m_energy)


def _rel(x, y) -> float:
    if math.isnan(x) and math.isnan(y):
        return 0.0
    return abs(x - y) / max(abs(y), 1e-300)


def _objective_values(req, period, deep_every):
    """The port's closed-form (time, energy) of ``req`` at a served point,
    in f64 on the host."""
    t = lambda v: torch.tensor(float(v), dtype=torch.float64)
    if req.is_multilevel:
        ck, pw = req.multilevel_params()
        p = {k: t(getattr(ck, k)) for k in ("C1", "R1", "D1", "C2", "R2",
                                            "D2", "mu", "q", "omega")}
        p.update({k: t(getattr(pw, k)) for k in ("P_static", "P_cal",
                                                 "P_io1", "P_io2",
                                                 "P_down")})
        m = t(deep_every)
        return (float(TSW.ml_time_final_batched(t(period), m, p,
                                                req.T_base)),
                float(TSW.ml_energy_final_batched(t(period), m, p,
                                                  req.T_base)))
    ck, pw = req.single_params()
    p = {k: t(getattr(ck, k)) for k in ("C", "R", "D", "mu", "omega")}
    p.update({k: t(getattr(pw, k)) for k in ("P_static", "P_cal", "P_io",
                                             "P_down")})
    return (float(TSW.time_final_batched(t(period), p, req.T_base)),
            float(TSW.energy_final_batched(t(period), p, req.T_base)))


# ---------------------------------------------------------------------------
# Port against reference
# ---------------------------------------------------------------------------

class TestAgainstReference:
    @pytest.mark.parametrize("seed,kw", [
        (0, {}), (3, dict(two_tier_frac=1.0)),
        (7, dict(two_tier_frac=0.5, repeat_frac=0.5)),
        (11, dict(two_tier_frac=0.2, repeat_frac=0.8,
                  objectives=("energy",)))])
    def test_synthetic_requests_equal(self, seed, kw):
        ref = RS.synthetic_requests(64, seed=seed, **kw)
        port = _port_reqs(64, seed, **kw)
        assert [dataclasses.asdict(r) for r in port] == \
            [dataclasses.asdict(r) for r in ref]
        carried = [interop.advice_request_from_fields(dataclasses.asdict(r))
                   for r in ref]
        assert carried == port

    @pytest.mark.parametrize("quant", [
        (1e-3, 1e-3, 1e-2), (0.5, 0.25, 1e-2), (0.0, 0.0, 1e-2)],
        ids=["default", "coarse", "exact"])
    def test_keys_equal(self, quant):
        ref = RS.synthetic_requests(256, seed=5, two_tier_frac=0.5,
                                    repeat_frac=0.3)
        port = _port_reqs(256, 5, two_tier_frac=0.5, repeat_frac=0.3)
        rq, pq = RS.Quantization(*quant), PS.Quantization(*quant)
        for r, p in zip(ref, port):
            qr, qp = RS.quantize_request(r, rq), PS.quantize_request(p, pq)
            assert dataclasses.asdict(qp) == dataclasses.asdict(qr)
            assert PS.fingerprint(p, pq) == RS.fingerprint(r, rq)
            assert PS.quantized_key(qp) == RS.quantized_key(qr)
            assert PS.exact_fingerprint(p) == RS.exact_fingerprint(r)

    @pytest.mark.parametrize("ml", [False, True], ids=["single", "two_tier"])
    def test_certificates_match(self, ml):
        """The same quantized fields and periods through both
        certificates: within 1e-12 (bitwise here), equal flags; the
        port's numpy and tensor inputs agree bit for bit."""
        from repro.serve import batcher as RB
        from repro.sim import evaluate_grid, evaluate_multilevel_grid
        reqs = [RS.quantize_request(r, RS.Quantization())
                for r in RS.synthetic_requests(
                    96, seed=8, two_tier_frac=1.0 if ml else 0.0)]
        if ml:
            grid, m_values, m_max = RB.multilevel_grid(reqs)
            res = evaluate_multilevel_grid(grid, m_values=m_values,
                                           m_max=m_max)
            args = [np.asarray(a, dtype=np.float64) for a in (
                res.T_time, res.m_time, res.T_energy, res.m_energy)]
            ref_fn, port_fn = (RS.certified_bound_multilevel,
                               PS.certified_bound_multilevel)
        else:
            grid = RB.single_grid(reqs)
            res = evaluate_grid(grid)
            args = [np.asarray(a, dtype=np.float64)
                    for a in (res.T_time, res.T_energy)]
            ref_fn, port_fn = (RS.certified_bound_single,
                               PS.certified_bound_single)
        fields = {k: np.asarray(v, dtype=np.float64)
                  for k, v in grid.fields().items()}
        for q in ((1e-3, 1e-3, 1e-2), (1e-2, 5e-3, 1e-2), (1e-3, 0.0, 1e-2),
                  (0.0, 1e-3, 1e-2)):
            want = ref_fn(fields, *args, RS.Quantization(*q))
            got = port_fn(fields, *args, PS.Quantization(*q))
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(got), fin)
            assert np.all(np.abs(got[fin] - want[fin])
                          <= 1e-12 * np.abs(want[fin]))
            np.testing.assert_array_equal(got <= q[2], want <= q[2])
            tens = port_fn({k: torch.from_numpy(v) for k, v in fields.items()},
                           *[torch.from_numpy(a) for a in args],
                           PS.Quantization(*q))
            np.testing.assert_array_equal(tens, got)
        assert fin.sum() > 0.8 * fin.size

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_advise_many_matches_jitted_reference(self, seed):
        ref = RS.synthetic_requests(64, seed=seed, two_tier_frac=0.5)
        port = _port_reqs(64, seed, two_tier_frac=0.5)
        want = RS.AdvisorService(cache_name=None).advise_many(ref)
        got = _svc().advise_many(port)
        assert sum(r.is_multilevel for r in port) not in (0, len(port))
        ties = []
        for i, (req, a, b) in enumerate(zip(port, got, want)):
            for k in ("store", "valid", "exact", "cache_hit",
                      "closed_form_exact", "objective"):
                assert getattr(a, k) == getattr(b, k), (i, k)
            for k, T in (("m_time", "T_time"), ("m_energy", "T_energy")):
                if getattr(a, k) != getattr(b, k):
                    # allowed only where the two cadences' objectives tie
                    j = 0 if k == "m_time" else 1
                    va = _objective_values(req, getattr(a, T),
                                           getattr(a, k))[j]
                    vb = _objective_values(req, getattr(b, T),
                                           getattr(b, k))[j]
                    assert _rel(va, vb) <= 1e-13, (i, k, va, vb)
                    ties.append((i, k))
            if ties and ties[-1][0] == i:
                continue
            assert a.deep_every == b.deep_every
            for k in ("predicted_wall", "predicted_energy", "T_time",
                      "vs_single"):
                assert _rel(getattr(a, k), getattr(b, k)) <= 1e-13, (i, k)
            # the AlgoE period of a two-tier lane: 1e-11 (see the module
            # docstring), its objective 1e-13
            e_tol = 1e-11 if req.is_multilevel else 1e-13
            assert _rel(a.T_energy, b.T_energy) <= e_tol, i
            assert _rel(a.period, b.period) <= (
                e_tol if a.objective == "energy" else 1e-13), i
            if a.valid:
                ve = _objective_values(req, a.T_energy, a.m_energy)[1]
                we = _objective_values(req, b.T_energy, b.m_energy)[1]
                assert _rel(ve, we) <= 1e-13, i
            assert _rel(a.cert_bound, b.cert_bound) <= 1e-10, i
            assert (a.cert_bound <= QUANT.tol) == (b.cert_bound <= QUANT.tol)
        assert not ties, f"cadence ties (allowed, named): {ties}"

    def test_advise_many_bitwise_reference_op_by_op(self):
        """Against the reference's advisor run op by op (no XLA fusion):
        every served number and certificate bit for bit."""
        import jax
        ref = RS.synthetic_requests(24, seed=0, two_tier_frac=0.5)
        port = _port_reqs(24, 0, two_tier_frac=0.5)
        with jax.disable_jit():
            want = RS.AdvisorService(cache_name=None).advise_many(ref)
        got = _svc().advise_many(port)
        for a, b in zip(got, want):
            assert _same_advice(a, b)
            assert NAN_EQ(a.cert_bound, b.cert_bound)
            assert NAN_EQ(a.vs_single, b.vs_single)
            assert (a.valid, a.exact) == (b.valid, b.exact)

    def test_service_metrics_keys_match(self):
        reqs = _mixed_workload(n=8)
        a = _svc()
        a.advise_many(reqs)
        b = RS.AdvisorService(cache_name=None)
        b.advise_many(RS.synthetic_requests(8, seed=7, two_tier_frac=0.5,
                                            repeat_frac=0.25))
        ma, mb = a.metrics(), b.metrics()
        assert set(ma) == set(mb)
        for k in ("requests", "batches", "dispatched_solves",
                  "solved_lanes", "fallback_requests", "precision_policy"):
            assert ma[k] == mb[k], k
        assert ma["fingerprint_cache"] == mb["fingerprint_cache"]


# ---------------------------------------------------------------------------
# The reference's advisor tests, ported onto the port
# ---------------------------------------------------------------------------

class TestBatchingSemantics:
    def test_batched_equals_sequential_bit_identical(self):
        reqs = _mixed_workload()
        batched = _svc().advise_many(reqs)
        solo = _svc()
        for req, a in zip(reqs, batched):
            assert _same_advice(a, solo.advise(req)), req

    def test_burst_of_distinct_requests_is_one_dispatched_solve(self):
        reqs = _port_reqs(64, 5, two_tier_frac=0.0)
        svc = _svc()
        svc.advise_many(reqs)
        assert svc.metrics()["dispatched_solves"] == 1

    def test_mixed_shapes_take_one_solve_per_shape(self):
        reqs = _mixed_workload(repeat_frac=0.0)
        assert {r.is_multilevel for r in reqs} == {False, True}
        svc = _svc()
        svc.advise_many(reqs)
        assert svc.metrics()["dispatched_solves"] == 2

    def test_heterogeneous_cadence_caps_batch_and_match_solo(self):
        base = _port_reqs(6, 13, two_tier_frac=1.0)
        reqs = [dataclasses.replace(r, max_deep_every=cap)
                for r, cap in zip(base, (1, 2, 3, 5, 8, 12))]
        batched = _svc().advise_many(reqs)
        solo = _svc()
        for req, a in zip(reqs, batched):
            assert a.m_time <= req.max_deep_every
            assert a.m_energy <= req.max_deep_every
            assert _same_advice(a, solo.advise(req)), req

    def test_deep_every_one_recommends_deep_tier_only(self):
        req = _port_reqs(32, 2, two_tier_frac=1.0)[0]
        req = dataclasses.replace(req, max_deep_every=1)
        adv = _svc().advise(req)
        assert adv.deep_every == 1
        assert adv.store == req.deep.name

    def test_t_base_scales_predictions_not_period(self):
        svc = _svc()
        req = _port_reqs(1, 21)[0]
        a1 = svc.advise(dataclasses.replace(req, T_base=1.0))
        a9 = svc.advise(dataclasses.replace(req, T_base=9.0))
        assert a9.period == a1.period
        assert a9.deep_every == a1.deep_every
        assert a9.predicted_wall == pytest.approx(9.0 * a1.predicted_wall)
        assert a9.predicted_energy == pytest.approx(
            9.0 * a1.predicted_energy)

    def test_grids_take_one_upload_each(self, monkeypatch):
        """The batcher moves each grid's stacked rows (and the cadence
        caps) to the device in one copy."""
        calls = []
        real = PB._upload
        monkeypatch.setattr(PB, "_upload",
                            lambda rows, device: calls.append(len(rows))
                            or real(rows, device))
        reqs = [PS.quantize_request(r, QUANT) for r in _mixed_workload(
            repeat_frac=0.0)]
        plan = PB.plan_batch([(PS.quantized_key(r), r) for r in reqs])
        pg, mg, m_values, m_max = plan.grids(CPU)
        assert calls == [len(plan.single_reqs), len(plan.ml_reqs)]
        assert m_values == tuple(range(1, PS.DEFAULT_MAX_DEEP_EVERY + 1))
        assert m_max.dtype == torch.float64
        assert m_max.tolist() == [r.max_deep_every for r in plan.ml_reqs]
        assert pg.C.tolist() == [r.tiers[0].C for r in plan.single_reqs]
        assert mg.omega2.tolist() == [r.w2 for r in plan.ml_reqs]


def test_timings_split_a_window():
    """``timings`` collects each part of every window; off, it is None and
    collects nothing."""
    reqs = _mixed_workload(n=24, repeat_frac=0.0)
    svc = _svc()
    assert svc.timings is None
    svc.advise_many(reqs)
    svc.timings = {}
    t0 = time.perf_counter()
    svc.advise_many(_mixed_workload(n=24, seed=8, repeat_frac=0.0))
    wall = time.perf_counter() - t0
    assert set(svc.timings) == {"fingerprint", "grids", "solve_single",
                                "solve_ml", "certificate", "readback",
                                "advice"}
    assert all(v > 0.0 for v in svc.timings.values())
    assert sum(svc.timings.values()) <= wall


class TestFingerprintCache:
    def test_fingerprint_ignores_objective_t_base_and_names(self):
        req = _port_reqs(1, 3, two_tier_frac=1.0)[0]
        fp = PS.fingerprint(req, QUANT)
        assert PS.fingerprint(dataclasses.replace(req, objective="time"),
                              QUANT) == fp
        assert PS.fingerprint(dataclasses.replace(req, T_base=123.0),
                              QUANT) == fp
        renamed = dataclasses.replace(
            req, tiers=tuple(dataclasses.replace(t, name=f"x{i}")
                             for i, t in enumerate(req.tiers)))
        assert PS.fingerprint(renamed, QUANT) == fp

    def test_fingerprint_distinguishes_cadence_cap_and_process(self):
        req = _port_reqs(1, 3, two_tier_frac=1.0)[0]
        fp = PS.fingerprint(req, QUANT)
        assert PS.fingerprint(dataclasses.replace(req, max_deep_every=3),
                              QUANT) != fp
        assert PS.fingerprint(dataclasses.replace(req, process="weibull",
                                                  process_param=0.7),
                              QUANT) != fp

    def test_quantize_is_idempotent(self):
        for req in _port_reqs(8, 4, two_tier_frac=0.5):
            qr = PS.quantize_request(req, QUANT)
            assert PS.quantize_request(qr, QUANT) == qr
            assert PS.fingerprint(qr, QUANT) == PS.fingerprint(req, QUANT)

    def test_repeat_workload_hits_and_skips_solves(self):
        reqs = _mixed_workload(repeat_frac=0.0)
        svc = _svc()
        first = svc.advise_many(reqs)
        solves = svc.metrics()["dispatched_solves"]
        again = svc.advise_many(reqs)
        m = svc.metrics()
        assert m["dispatched_solves"] == solves      # all hits, no solve
        assert all(a.cache_hit for a in again)
        assert not any(a.cache_hit for a in first)
        for a, b in zip(first, again):
            assert _same_advice(a, b)
        fc = m["fingerprint_cache"]
        assert fc["hits"] >= len(reqs)
        assert fc["inserts"] == fc["size"] == len(
            {PS.fingerprint(r, svc.quant) for r in reqs})

    def test_uncertifiable_cell_falls_back_to_exact_solve(self):
        coarse = PS.Quantization(rel=0.5, absolute=0.25, tol=1e-2)
        reqs = _mixed_workload(n=12, repeat_frac=0.0)
        svc = _svc(quantization=coarse)
        exact = _svc(quantization=EXACT_Q)
        for a, req in zip(svc.advise_many(reqs), reqs):
            assert a.exact and a.cert_bound == 0.0
            assert _same_advice(a, exact.advise(req)), req
        assert svc.metrics()["fallback_requests"] == len(reqs)
        again = svc.advise_many(reqs)
        assert all(a.cache_hit for a in again)

    def test_eviction_changes_no_answers(self):
        reqs = _port_reqs(10, 17, two_tier_frac=0.0)
        big = _svc()
        tiny = _svc(cache_size=2)
        ref = big.advise_many(reqs)
        for _ in range(2):              # thrash the 2-entry cache
            tiny.advise_many(reqs)
        for req, want in zip(reqs, ref):
            assert _same_advice(tiny.advise(req), want)
        assert tiny.metrics()["fingerprint_cache"]["evictions"] > 0

    def test_cert_bound_does_not_depend_on_lane_position(self):
        """A lane's certificate is the same bits alone and at several
        positions of a 300-lane window (no position-dependent rounding)."""
        others = _port_reqs(300, 31, two_tier_frac=0.5)
        for probe in _port_reqs(4, 32, two_tier_frac=0.5):
            alone = _svc().advise(probe)
            for pos in (0, 1, 7, 8, 15, 16, 127, 150, 299):
                window = others[:pos] + [probe] + others[pos + 1:]
                got = _svc().advise_many(window)[pos]
                assert got.cert_bound == alone.cert_bound, pos
                assert _same_advice(got, alone), pos
                assert got.exact == alone.exact


class TestQuantizationTolerance:
    """The documented contract: served objective within tol of exact."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_served_objective_within_documented_tolerance(self, seed):
        reqs = _port_reqs(64, seed, two_tier_frac=0.5)
        quant = _svc()
        served = quant.advise_many(reqs)
        truth = _svc(quantization=EXACT_Q).advise_many(reqs)
        checked = 0
        for req, a, t in zip(reqs, served, truth):
            if not (a.valid and t.valid):
                continue
            if not a.exact:
                assert a.cert_bound <= quant.quant.tol
            sv_t, _ = _objective_values(req, a.T_time, a.m_time)
            _, sv_e = _objective_values(req, a.T_energy, a.m_energy)
            op_t, _ = _objective_values(req, t.T_time, t.m_time)
            _, op_e = _objective_values(req, t.T_energy, t.m_energy)
            slack = max(a.cert_bound, 1e-12)
            assert sv_t <= op_t * (1.0 + slack), (req, sv_t, op_t)
            assert sv_e <= op_e * (1.0 + slack), (req, sv_e, op_e)
            checked += 1
        assert checked >= len(reqs) // 2

    def test_cert_bound_is_conservative_for_cell_members(self):
        rng = np.random.default_rng(0)
        reqs = _port_reqs(24, 9, two_tier_frac=0.5)
        svc = _svc()
        exact = _svc(quantization=EXACT_Q)
        served = svc.advise_many(reqs)
        for req, a in zip(reqs, served):
            if not a.valid or a.exact:
                continue
            rep = PS.quantize_request(req, svc.quant)
            f = 1.0 + (rng.uniform(-0.49, 0.49) * svc.quant.rel)
            pert = dataclasses.replace(
                rep, mu=rep.mu * f, T_base=req.T_base,
                tiers=tuple(dataclasses.replace(t, C=t.C * f)
                            for t in rep.tiers))
            assert PS.fingerprint(pert, svc.quant) == \
                PS.fingerprint(req, svc.quant)
            b = svc.advise(pert)
            assert b.cache_hit and _same_advice(a, b)
            t = exact.advise(pert)
            if not t.valid:
                continue
            sv_t, _ = _objective_values(pert, b.T_time, b.m_time)
            _, sv_e = _objective_values(pert, b.T_energy, b.m_energy)
            op_t, _ = _objective_values(pert, t.T_time, t.m_time)
            _, op_e = _objective_values(pert, t.T_energy, t.m_energy)
            assert sv_t <= op_t * (1.0 + a.cert_bound + 1e-12)
            assert sv_e <= op_e * (1.0 + a.cert_bound + 1e-12)

    def test_reduced_precision_folds_objective_tol_into_certificates(self):
        """A compensated-f32 service (the CUDA default) adds its
        objective_tol to every certificate and still serves within
        cert_bound of an exact f64 solve."""
        reqs = _port_reqs(32, 4, two_tier_frac=0.5)
        f64 = _svc().advise_many(reqs)
        f32 = _svc(precision="compensated_f32")
        assert f32.metrics()["precision_policy"] == "compensated_f32"
        served = f32.advise_many(reqs)
        truth = _svc(quantization=EXACT_Q).advise_many(reqs)
        tol = TS.COMPENSATED_F32.objective_tol
        for req, a, b, t in zip(reqs, served, f64, truth):
            if not (a.valid and t.valid):
                continue
            if not (a.exact or b.exact):
                assert a.cert_bound == pytest.approx(b.cert_bound + tol,
                                                     rel=1e-3)
            for j, (T, m, To, mo) in enumerate((
                    (a.T_time, a.m_time, t.T_time, t.m_time),
                    (a.T_energy, a.m_energy, t.T_energy, t.m_energy))):
                sv = _objective_values(req, T, m)[j]
                op = _objective_values(req, To, mo)[j]
                assert sv <= op * (1.0 + a.cert_bound + tol), (req, j)


class TestThreadedAdvisor:
    def test_concurrent_submissions_match_direct_service(self):
        reqs = _mixed_workload(n=32, repeat_frac=0.3)
        want = _svc().advise_many(reqs)
        with PS.ThreadedAdvisor(_svc(), batch_window_s=5e-3) as advisor:
            futs = [advisor.submit(r) for r in reqs]
            got = [f.result(timeout=60) for f in futs]
            m = advisor.metrics()
        assert m["windows"] >= 1
        assert m["requests"] == len(reqs)
        for a, b in zip(want, got):
            assert _same_advice(a, b)

    def test_concurrent_callers_from_threads(self):
        reqs = _mixed_workload(n=24, repeat_frac=0.0)
        want = _svc().advise_many(reqs)
        got = [None] * len(reqs)
        with PS.ThreadedAdvisor(_svc(), batch_window_s=2e-3) as advisor:
            def caller(i):
                got[i] = advisor.advise(reqs[i])
            threads = [threading.Thread(target=caller, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        for a, b in zip(want, got):
            assert _same_advice(a, b)

    def test_direct_callers_from_many_threads_lose_no_update(self):
        """Many threads calling one service directly: its lock serializes
        the windows, so no counter update is lost and every answer is the
        one-window answer."""
        reqs = _mixed_workload(n=16, repeat_frac=0.0)
        want = _svc().advise_many(reqs)
        svc = _svc()
        n_threads, rounds = 4 * (os.cpu_count() or 1), 3
        errors = []

        def caller(k):
            try:
                for _ in range(rounds):
                    i = k % len(reqs)
                    assert _same_advice(svc.advise(reqs[i]), want[i])
            except BaseException as err:     # reported below
                errors.append(err)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=caller, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[0]
        m = svc.metrics()
        assert m["requests"] == m["batches"] == n_threads * rounds
        fc = m["fingerprint_cache"]
        assert fc["lookups"] == n_threads * rounds
        assert fc["inserts"] == fc["misses"] == len(reqs)

    def test_zero_window_still_serves(self):
        req = _port_reqs(1, 1)[0]
        with PS.ThreadedAdvisor(_svc(), batch_window_s=0.0) as advisor:
            assert advisor.advise(req).period > 0

    def test_close_is_idempotent_and_rejects_new_work(self):
        advisor = PS.ThreadedAdvisor(_svc())
        advisor.close()
        advisor.close()
        with pytest.raises(RuntimeError):
            advisor.submit(_port_reqs(1, 1)[0])

    def test_invalid_knobs_rejected(self):
        with pytest.raises(ValueError):
            PS.ThreadedAdvisor(_svc(), batch_window_s=-1.0)
        with pytest.raises(ValueError):
            PS.ThreadedAdvisor(_svc(), max_batch=0)

    def test_window_error_reaches_every_future(self):
        class Broken(PS.AdvisorService):
            def advise_many(self, reqs):
                time.sleep(0.01)
                raise FloatingPointError("solve failed")
        reqs = _port_reqs(6, 2)
        with PS.ThreadedAdvisor(Broken(cache_name=None, device=CPU),
                                batch_window_s=0.05) as advisor:
            futs = [advisor.submit(r) for r in reqs]
            for f in futs:
                with pytest.raises(FloatingPointError):
                    f.result(timeout=60)


class TestLoadGenerator:
    def test_open_loop_reports_throughput_and_hits(self):
        reqs = _port_reqs(40, 9, two_tier_frac=0.5, repeat_frac=0.5)
        with PS.ThreadedAdvisor(_svc(), batch_window_s=2e-3) as advisor:
            rep = PS.run_open_loop(advisor, reqs, rate_hz=2000.0,
                                   warmup=_port_reqs(8, 10))
        assert rep.n == 40 and rep.rps > 0.0
        assert rep.hit_rate > 0.0
        assert 0.0 <= rep.p50_ms <= rep.p99_ms <= rep.max_ms
        assert rep.windows >= 1
        assert rep.summary()["rps"] == rep.rps
        with pytest.raises(ValueError):
            PS.run_open_loop(advisor, reqs, rate_hz=0.0)

    def test_synthetic_requests_deterministic_and_shaped(self):
        a = _port_reqs(32, 6, two_tier_frac=0.5, repeat_frac=0.25)
        b = _port_reqs(32, 6, two_tier_frac=0.5, repeat_frac=0.25)
        assert a == b
        assert any(r.is_multilevel for r in a)
        assert any(not r.is_multilevel for r in a)
        fps = [PS.fingerprint(r, QUANT) for r in a]
        assert len(set(fps)) < len(fps)
        rng = np.random.default_rng(6)
        first = PS.synthetic_requests(16, rng)
        assert PS.synthetic_requests(16, rng) != first   # advanced in place


_T = dict(name="pfs", C=60.0, R=60.0, D=0.0, P_io=10.0)
BAD_REQUESTS = [
    dict(mu=0.0, tiers=(_T,)), dict(mu=100.0, tiers=()),
    dict(mu=100.0, tiers=(_T, _T, _T)),
    dict(mu=100.0, tiers=(_T,), objective="carbon"),
    dict(mu=100.0, tiers=(_T,), T_base=-1.0),
    dict(mu=100.0, tiers=(_T,), max_deep_every=0),
    dict(mu=100.0, tiers=(_T,), max_deep_every=13),
    dict(mu=100.0, tiers=(_T,), omega=1.5),
    dict(mu=100.0, tiers=(_T, _T), omega2=-0.1),
    dict(mu=100.0, tiers=(_T,), P_static=0.0),
    dict(mu=100.0, tiers=(_T,), P_cal=-1.0),
    dict(mu=float("inf"), tiers=(_T,)),
]
BAD_TIERS = [dict(name="bad", C=-1.0, R=0.0, D=0.0, P_io=0.0),
             dict(name="bad", C=1.0, R=0.0, D=0.0, P_io=0.0, q=1.5),
             dict(name="bad", C=float("nan"), R=0.0, D=0.0, P_io=0.0)]


class TestSchemaValidation:
    @pytest.mark.parametrize("kw", BAD_REQUESTS,
                             ids=[str(i) for i in range(len(BAD_REQUESTS))])
    def test_rejects_bad_requests_like_the_reference(self, kw):
        def build(pkg):
            tiers = tuple(pkg.StoreTier(**t) for t in kw["tiers"])
            return pkg.AdviceRequest(**dict(kw, tiers=tiers))
        with pytest.raises(ValueError) as want:
            build(RS)
        with pytest.raises(ValueError) as got:
            build(PS)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("kw", BAD_TIERS,
                             ids=[str(i) for i in range(len(BAD_TIERS))])
    def test_rejects_bad_tiers_like_the_reference(self, kw):
        with pytest.raises(ValueError) as want:
            RS.StoreTier(**kw)
        with pytest.raises(ValueError) as got:
            PS.StoreTier(**kw)
        assert str(got.value) == str(want.value)

    def test_exact_fingerprint_zero_width(self):
        req = _port_reqs(1, 1)[0]
        assert PS.exact_fingerprint(req) != PS.exact_fingerprint(
            dataclasses.replace(req, mu=req.mu * (1.0 + 1e-12)))

    def test_params_round_trip_like_the_reference(self):
        from repro.core import (EXASCALE_ML_POWER, EXASCALE_POWER_RHO55,
                                fig12_checkpoint)
        from repro.core import MultilevelCheckpointParams as RMC
        ck, pw = fig12_checkpoint(300.0), EXASCALE_POWER_RHO55
        mck = RMC(C1=2.0, R1=2.0, D1=0.5, C2=10.0, R2=10.0, D2=1.0,
                  mu=300.0, q=0.1, omega=0.5, omega2=0.8)
        want = RS.AdviceRequest.from_params(ck, pw, objective="time")
        got = PS.AdviceRequest.from_params(
            interop.ckpt_from_fields(dataclasses.asdict(ck)),
            interop.power_from_fields(dataclasses.asdict(pw)),
            objective="time")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [dataclasses.asdict(x) for x in got.single_params()] == \
            [dataclasses.asdict(x) for x in want.single_params()]
        want = RS.AdviceRequest.from_multilevel_params(mck,
                                                       EXASCALE_ML_POWER)
        got = PS.AdviceRequest.from_multilevel_params(
            interop.ml_ckpt_from_fields(dataclasses.asdict(mck)),
            interop.ml_power_from_fields(
                dataclasses.asdict(EXASCALE_ML_POWER)))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.w2 == want.w2 == 0.8
        assert [dataclasses.asdict(x) for x in got.multilevel_params()] == \
            [dataclasses.asdict(x) for x in want.multilevel_params()]
        for m in (1, 2, 5):
            assert PS.store_recommendation(got, m) == \
                RS.store_recommendation(want, m)


class TestCacheStatsRegistry:
    def test_named_caches_expose_counters(self):
        PD.reset_cache_stats()
        svc = PS.AdvisorService(cache_name="serve.fingerprints", device=CPU)
        reqs = _port_reqs(8, 14, two_tier_frac=0.0)
        svc.advise_many(reqs)
        svc.advise_many(reqs)
        stats = TS.cache_stats()
        fp = stats["serve.fingerprints"]
        assert fp["hits"] > 0 and fp["inserts"] > 0
        assert fp["lookups"] == fp["hits"] + fp["misses"]
        assert svc.metrics()["caches"]["serve.fingerprints"][
            "hits"] == fp["hits"]
        TS.reset_cache_stats()
        assert TS.cache_stats()["serve.fingerprints"]["lookups"] == 0
        assert len(svc.cache) == fp["size"]     # contents untouched

    def test_lru_order_counters_and_last_name_owns_the_slot(self):
        c = PD.LRUCache(2, name="test.lru")
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1               # a is now most recent
        c.put("c", 3)                        # evicts b
        assert "b" not in c and "a" in c and "c" in c
        assert c.get("b") is None
        assert c.stats.snapshot() == {"hits": 1, "misses": 1, "lookups": 2,
                                      "inserts": 3, "evictions": 1,
                                      "hit_rate": 0.5}
        assert TS.cache_stats()["test.lru"]["size"] == 2
        d = PD.LRUCache(5, name="test.lru")
        assert TS.cache_stats()["test.lru"]["maxsize"] == 5
        snap = TS.cache_stats(reset=True)["test.lru"]
        assert snap["lookups"] == 0 and d.stats.lookups == 0
        anon = PD.LRUCache(1, name=None)
        anon.put(1, 1)
        assert None not in TS.cache_stats()
        c.clear()
        assert len(c) == 0


class TestBackendAndDevices:
    def test_backend_info(self):
        assert PD.backend_info(CPU) == PD.BackendInfo(
            platform="cpu", device_kind="cpu", n_devices=1, virtual=False)
        assert TS.backend_info is PD.backend_info

    @pytest.mark.skipif(torch.cuda.is_available(),
                        reason="a CUDA device is present")
    def test_entry_points_default_to_cuda_and_raise_without_it(self):
        reqs = _port_reqs(2, 1)
        for call in (lambda: PD.backend_info(),
                     lambda: PS.AdvisorService(),
                     lambda: PS.single_grid(reqs),
                     lambda: PS.multilevel_grid(
                         _port_reqs(2, 1, two_tier_frac=1.0)),
                     lambda: bench_advisor.time_advisor_rps(
                         np.random.default_rng(0), n=2),
                     lambda: bench_advisor.time_advisor_regimes(
                         np.random.default_rng(0), np.random.default_rng(1))):
            with pytest.raises(RuntimeError, match="cuda"):
                call()

    def test_trace_policy_is_use_policy(self):
        assert trace_policy is use_policy
        from repro_torch.sim import precision
        with trace_policy(TS.COMPENSATED_F32):
            assert precision.active_policy() is TS.COMPENSATED_F32
        assert precision.active_policy() is TS.F64


class TestCompileCache:
    def test_enable_moves_the_build_directory(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
        monkeypatch.setattr(PC, "_active_dir", None)
        monkeypatch.delenv(PC.ENV_VAR, raising=False)
        before = _build.library_path("event_sweep.cu")
        target = tmp_path / "kernels"
        assert PC.enable_compile_cache(str(target)) == str(target)
        assert target.is_dir()
        assert PC.active_cache_dir() == str(target)
        after = _build.library_path("event_sweep.cu")
        assert after.parent == target
        assert after.name == before.name     # the key does not move
        monkeypatch.setenv(PC.ENV_VAR, str(tmp_path / "env"))
        assert PC.maybe_enable_from_env() == str(tmp_path / "env")
        assert _build.library_path("rglru_scan.cu").parent == \
            tmp_path / "env"

    def test_unusable_env_warns_and_keeps_the_default(self, tmp_path,
                                                      monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
        monkeypatch.setattr(PC, "_active_dir", None)
        default = _build.BUILD_DIR
        blocker = tmp_path / "file"
        blocker.write_text("")
        monkeypatch.setenv(PC.ENV_VAR, str(blocker / "sub"))
        with pytest.warns(RuntimeWarning, match="unusable"):
            assert PC.maybe_enable_from_env() is None
        assert _build.BUILD_DIR == default and PC.active_cache_dir() is None
        with pytest.raises(OSError):
            PC.enable_compile_cache(str(blocker / "sub"))
        monkeypatch.delenv(PC.ENV_VAR)
        assert PC.maybe_enable_from_env() is None

    def test_env_read_at_import(self, tmp_path):
        code = ("import warnings, repro_torch.sim as s\n"
                "from repro_torch.kernels import _build\n"
                "print(s.active_cache_dir(), _build.BUILD_DIR)\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_COMPILE_CACHE=str(tmp_path / "cc"))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True)
        assert out.stdout.split() == [str(tmp_path / "cc")] * 2
        blocker = tmp_path / "file"
        blocker.write_text("")
        env["REPRO_COMPILE_CACHE"] = str(blocker / "sub")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True)
        assert out.stdout.split()[0] == "None"
        assert "unusable" in out.stderr


class TestServeCLI:
    def test_advisor_parser_defaults_equal_the_reference(self):
        from repro.launch.serve import build_advisor_parser as ref_parser
        from repro_torch.launch.serve import build_advisor_parser
        got = vars(build_advisor_parser().parse_args([]))
        assert got.pop("device") == "cuda"
        assert got == vars(ref_parser().parse_args([]))
        args = build_advisor_parser().parse_args(
            ["--smoke", "--rate", "500", "--repeat-frac", "0.5",
             "--device", "cpu"])
        assert args.smoke and args.rate == 500.0 and args.device == "cpu"

    def test_advisor_smoke_leg_passes(self, capsys):
        from repro_torch.launch.serve import main
        rep = main(["advisor", "--smoke", "--device", "cpu"])
        assert rep.rps > 0.0 and rep.hit_rate > 0.0
        out = capsys.readouterr().out
        assert out.count("PASS") == 3

    def test_advisor_run_prints_its_report(self, capsys):
        from repro_torch.launch.serve import main
        rep = main(["advisor", "--device", "cpu", "--requests", "24",
                    "--warmup", "4", "--repeat-frac", "0.5"])
        assert rep.n == 24
        assert "dispatched solves" in capsys.readouterr().out

    def test_model_path_names_what_is_missing(self):
        """The launcher's model path (beside the advisor) serves an MoE
        arch too: dbrx, reduced, on the CPU."""
        from repro_torch.launch.serve import main
        run = main(["--arch", "dbrx-132b", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "16", "--new-tokens", "3"])
        assert run.cfg.n_experts and run.tokens.shape == (2, 3)
        assert bool(torch.isfinite(run.logits.float()).all())


class TestBenchAdvisor:
    def test_burst_is_one_solve_and_bitwise_the_naive_loop(self):
        out = bench_advisor.time_advisor_rps(np.random.default_rng(42),
                                             repeat=1, device=CPU, n=16)
        assert out["n_requests"] == 16
        assert out["naive_s"] > 0 and out["batched_warm_s"] > 0
        assert out["speedup_warm"] == out["naive_s"] / out["batched_warm_s"]
        assert 0.0 <= out["p50_ms"] <= out["p99_ms"]
        # the reference's burst: the same requests as seed 42
        ref = RS.synthetic_requests(16, seed=42, two_tier_frac=0.0)
        assert _port_reqs(16, 42, two_tier_frac=0.0) == [
            interop.advice_request_from_fields(dataclasses.asdict(r))
            for r in ref]

    def test_main_writes_its_json(self, tmp_path, monkeypatch):
        from repro_torch.benchmarks import _util
        monkeypatch.setattr(_util, "RESULTS", tmp_path)
        monkeypatch.setattr(bench_advisor, "BURST", 8)
        monkeypatch.setattr(bench_advisor, "_REGIME_N", 8)
        monkeypatch.setattr(bench_advisor, "REGIMES", ((2e-3, 0.8),))
        import json
        orig = bench_advisor.time_advisor_rps
        monkeypatch.setattr(bench_advisor, "time_advisor_rps",
                            lambda rng, device: orig(rng, 1, device, n=8))
        out = bench_advisor.main(np.random.default_rng(42),
                                 np.random.default_rng(11),
                                 np.random.default_rng(12), device=CPU)
        saved = json.loads((tmp_path / "bench_advisor.json").read_text())
        assert saved["advisor_rps"]["n_requests"] == 8
        assert set(saved["advisor_load_regimes"]) == {
            "n_requests", "rate_hz", "ungated", "window_2ms_repeat_0.8"}
        assert out["device"] == CPU


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device")
def test_card_matches_cpu_in_f64():
    reqs = _port_reqs(64, 11, two_tier_frac=0.5)
    card = PS.AdvisorService(cache_name=None, precision="f64",
                             device="cuda").advise_many(reqs)
    host = PS.AdvisorService(cache_name=None, precision="f64",
                             device=CPU).advise_many(reqs)
    for a, b in zip(card, host):
        for k in ("deep_every", "m_time", "m_energy", "store", "valid",
                  "exact"):
            assert getattr(a, k) == getattr(b, k)
        for k in ("period", "predicted_wall", "predicted_energy", "T_time",
                  "T_energy"):
            assert _rel(getattr(a, k), getattr(b, k)) <= 1e-12
