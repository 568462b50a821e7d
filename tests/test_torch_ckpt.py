"""The port's checkpoint runtime against the JAX package, on the CPU.

* Multilevel closed forms at 1e-13 relative (bitwise where the reference
  pins it: m = 1 with degenerate levels against the single-level forms)
  and the joint (T, m) solvers at 1e-8.
* ``CheckpointPolicy`` decisions over scripted observation sequences,
  every strategy: periods at 1e-8 (MSK at 1e-7: a golden-section argmin
  in a flat valley, which lands in the reference's final bracket but not
  within 1e-8, see ROADMAP "known differences"), cadences and step counts
  exactly.
* ``EnergyMeter`` reports, equal.
* The model-free scenarios of ``tests/test_ckpt_ft.py`` (store, manager,
  multilevel manager, energy meter) and of ``tests/test_faultinject.py``
  (fault plans, store injection, flush controller, manager faults,
  degraded policy re-solve), each run through both packages on the same
  numpy-seeded trees, with the same outcomes.
* A generation written by the JAX store with ``compress=True`` restores
  in the port bitwise, and the reverse; the two stores write the same
  manifest entries and payload arrays.
* ``chip_smoke.py``'s xLSTM-125M shape table against the reference's
  ``jax.eval_shape``, and the port's leaf order against ``jax.tree``.
"""
import dataclasses
import json
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as RC
import repro.core as R
import repro.core.policy as RPOL
import repro.energy as RE

import repro_torch.ckpt as TC
import repro_torch.core as P
import repro_torch.core.policy as TPOL
import repro_torch.energy as TE
from repro_torch import interop
from repro_torch.ckpt.tree import tree_flatten, tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CPU = "cpu"


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


# ---------------------------------------------------------------------------
# Multilevel closed forms and solvers
# ---------------------------------------------------------------------------

ML_CASES = {
    "buddy_pfs": dict(C1=1.0, R1=1.0, C2=10.0, R2=10.0, D1=0.5, D2=1.0,
                      mu=300.0, q=0.1, omega=0.5),
    "async_flush": dict(C1=0.3, R1=0.3, C2=1.5, R2=1.5, D1=0.1, D2=0.2,
                        mu=15.0, q=0.15, omega=0.2, omega2=0.9),
    "per_level_omega": dict(C1=2.0, R1=1.5, C2=30.0, R2=25.0, D1=1.0,
                            D2=3.0, mu=3000.0, q=0.05, omega=0.0,
                            omega1=0.4, omega2=0.7),
}
ML_POWERS = {"exascale_ml": R.EXASCALE_ML_POWER,
             "degenerate": R.MultilevelPowerParams.from_power(
                 R.EXASCALE_POWER_RHO7)}


def _ml_pair(case):
    ref = R.MultilevelCheckpointParams(**ML_CASES[case])
    return ref, interop.ml_ckpt_from_fields(dataclasses.asdict(ref))


class TestMultilevelModel:
    @pytest.mark.parametrize("case", ML_CASES)
    @pytest.mark.parametrize("pname", ML_POWERS)
    def test_closed_forms_match_reference(self, case, pname):
        ref, ck = _ml_pair(case)
        rpw = ML_POWERS[pname]
        pw = interop.ml_power_from_fields(dataclasses.asdict(rpw))
        for m in (1, 2, 3, 5):
            lo, hi = ref.valid_period_range(m)
            if hi <= lo:
                continue
            T = np.linspace(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), 9)
            assert _rel(P.ml_time_final(T, m, ck, device=CPU),
                        R.ml_time_final(T, m, ref)) <= 1e-13
            rph = R.ml_phase_times(T, m, ref)
            ph = P.ml_phase_times(T, m, ck, device=CPU)
            for f in rph._fields:
                assert _rel(getattr(ph, f), getattr(rph, f)) <= 1e-13, f
            for name in ("ml_energy_final", "ml_energy_final_prime",
                         "ml_K_factor", "ml_K_dE_dT"):
                got = getattr(P, name)(T, m, ck, pw, device=CPU)
                want = getattr(R.model, name)(T, m, ref, rpw)
                assert _rel(got, want) <= 1e-13, name
            eb = P.ml_energy_breakdown(T[4], m, ck, pw, device=CPU)
            rb = R.ml_energy_breakdown(T[4], m, ref, rpw)
            assert eb.keys() == rb.keys()
            assert all(_rel(eb[k], rb[k]) <= 1e-13 for k in rb)

    def test_params_derived_quantities_equal(self):
        for case in ML_CASES:
            ref, ck = _ml_pair(case)
            for m in (1, 2, 4):
                for name in ("C_mean", "C_omega_mean", "a", "b", "mu_eff",
                             "S2", "S2_omega", "expected_fixed_loss",
                             "flush_window", "valid_period_range"):
                    assert getattr(ck, name)(m) == getattr(ref, name)(m)
            assert dataclasses.asdict(ck.single_level()) == \
                dataclasses.asdict(ref.single_level())
            assert dataclasses.asdict(ck.buddy_only()) == \
                dataclasses.asdict(ref.buddy_only())
        assert dataclasses.asdict(P.EXASCALE_ML_POWER) == \
            dataclasses.asdict(R.EXASCALE_ML_POWER)
        assert P.EXASCALE_ML_POWER.rho2 == R.EXASCALE_ML_POWER.rho2
        with pytest.raises(ValueError):
            P.MultilevelCheckpointParams(C1=1, R1=1, C2=1, R2=1, D1=1, D2=1,
                                         mu=1.0, q=1.5)

    def test_m1_degenerate_levels_reduce_bitwise(self):
        """m = 1 on degenerate levels is the single-level model bit for bit
        (time at any q; energy at q = 0), in the port as in the
        reference."""
        ck = P.CheckpointParams(C=10.0, R=10.0, D=1.0, mu=300.0, omega=0.5)
        pw = P.EXASCALE_POWER_RHO55
        T = np.linspace(22.0, 250.0, 9)
        for q in (0.0, 0.3, 1.0):
            ml = P.MultilevelCheckpointParams.from_single(ck, q=q)
            assert torch.equal(P.ml_time_final(T, 1, ml, device=CPU),
                               P.time_final(T, ck, device=CPU))
        ml = P.MultilevelCheckpointParams.from_single(ck, q=0.0)
        mpw = P.MultilevelPowerParams.from_power(pw)
        np.testing.assert_allclose(
            P.ml_energy_final(T, 1, ml, mpw, device=CPU).numpy(),
            P.energy_final(T, ck, pw, device=CPU).numpy(), rtol=1e-13)
        T1, m1 = P.t_opt_time_multilevel(ml, device=CPU)
        assert m1 == 1 and T1 == P.t_opt_time(ck, device=CPU)

    @pytest.mark.parametrize("case", ML_CASES)
    @pytest.mark.parametrize("pname", ML_POWERS)
    def test_solvers_match_reference(self, case, pname):
        ref, ck = _ml_pair(case)
        rpw = ML_POWERS[pname]
        pw = interop.ml_power_from_fields(dataclasses.asdict(rpw))
        Tt, mt = P.t_opt_time_multilevel(ck, device=CPU)
        rTt, rmt = R.t_opt_time_multilevel(ref)
        assert mt == rmt and _rel(Tt, rTt) <= 1e-8
        Te, me = P.t_opt_energy_multilevel(ck, pw, device=CPU)
        rTe, rme = R.t_opt_energy_multilevel(ref, rpw)
        assert me == rme and _rel(Te, rTe) <= 1e-8
        for m in (1, 2, 3):
            c = P.ml_energy_quadratic_coefficients(ck, pw, m, device=CPU)
            rc = R.ml_energy_quadratic_coefficients(ref, rpw, m)
            assert _rel(c, rc) <= 1e-8

    def test_no_valid_m_raises(self):
        ck = P.MultilevelCheckpointParams(C1=50.0, R1=50.0, C2=500.0,
                                          R2=500.0, D1=1.0, D2=1.0, mu=100.0)
        with pytest.raises(ValueError, match="No valid"):
            P.t_opt_time_multilevel(ck, device=CPU)
        with pytest.raises(ValueError, match="No valid"):
            P.t_opt_energy_multilevel(ck, P.EXASCALE_ML_POWER, device=CPU)


# ---------------------------------------------------------------------------
# Policy: scripted observations, every strategy
# ---------------------------------------------------------------------------

STRATEGIES = ("algo_t", "algo_e", "young", "daly", "msk_energy", "fixed",
              "algo_t_ml", "algo_e_ml")

#: (method, kwargs) — one script drives both packages' policies.
SCRIPT = [
    ("observe_step_time", dict(seconds=2.0)),
    ("observe_checkpoint", dict(duration_s=40.0, slowdown_work_fraction=0.6,
                                level=2)),
    ("observe_checkpoint", dict(duration_s=5.0, slowdown_work_fraction=0.3,
                                level=1)),
    ("observe_step_time", dict(seconds=2.2)),
    ("observe_failure", dict(wall_time_s=20000.0)),
    ("observe_recovery", dict(recovery_s=50.0, downtime_s=8.0, level=2)),
    ("observe_failure", dict(wall_time_s=70000.0)),
    ("observe_recovery", dict(recovery_s=4.0, downtime_s=2.0, level=1)),
    ("observe_checkpoint", dict(duration_s=90.0, slowdown_work_fraction=0.9,
                                level=2)),
    ("set_deep_available", dict(available=False)),
    ("observe_step_time", dict(seconds=1.7)),
    ("set_deep_available", dict(available=True)),
    ("observe_failure", dict(wall_time_s=95000.0)),
    ("observe_checkpoint", dict(duration_s=3.0, level=1)),
]


def _policies(strategy, **kw):
    prof_r, prof_t = RE.PAPER_EXASCALE_ML_PROFILE, TE.PAPER_EXASCALE_ML_PROFILE
    cfg = dict(strategy=strategy, C_s=60.0, R_s=60.0, D_s=6.0,
               mu_s=24 * 3600.0, omega=0.5, C1_s=6.0, R1_s=6.0, q=0.1,
               fixed_period_s=900.0)
    cfg.update(kw)
    ref = RPOL.CheckpointPolicy(RPOL.PolicyConfig(**cfg),
                                prof_r.power_params(),
                                ml_power=prof_r.ml_power_params())
    got = TPOL.CheckpointPolicy(TPOL.PolicyConfig(**cfg),
                                prof_t.power_params(),
                                ml_power=prof_t.ml_power_params(),
                                device=CPU)
    return ref, got


def _same_decision(ref, got, tol):
    assert _rel(got.period_seconds(), ref.period_seconds()) <= tol
    assert got.deep_every() == ref.deep_every()
    assert got.period_steps() == ref.period_steps()
    for m in (None, 3):
        a, b = got.operating_point(m), ref.operating_point(m)
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], str):
                assert a[k] == b[k]
            else:
                assert _rel(a[k], b[k]) <= tol, k
    a, b = got.report(), ref.report()
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], (str, bool)):
            assert a[k] == b[k], k
        elif not (isinstance(b[k], float) and np.isnan(b[k])):
            assert _rel(a[k], b[k]) <= tol, k


class TestPolicy:
    @pytest.mark.parametrize("strategy", STRATEGIES)
    def test_decisions_over_scripted_observations(self, strategy):
        tol = 1e-7 if strategy == "msk_energy" else 1e-8
        ref, got = _policies(strategy)
        _same_decision(ref, got, tol)
        for method, kw in SCRIPT:
            getattr(ref, method)(**kw)
            getattr(got, method)(**kw)
            _same_decision(ref, got, tol)
            assert got.deep_available == ref.deep_available
            for ml in (False, True):
                a = (got.checkpoint_params_ml() if ml
                     else got.checkpoint_params())
                b = (ref.checkpoint_params_ml() if ml
                     else ref.checkpoint_params())
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert got.overlap_for(1) == ref.overlap_for(1)
            assert got.overlap_for(2) == ref.overlap_for(2)

    def test_infinite_mtbf_never_checkpoints(self):
        ref, got = _policies("algo_e", mu_s=float("inf"),
                             mu_from_observations=False)
        assert got.period_seconds() == ref.period_seconds() == float("inf")
        assert got.period_steps() == ref.period_steps() == 10 ** 9

    def test_default_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="cuda"):
            TPOL.CheckpointPolicy(TPOL.PolicyConfig(strategy="algo_t"),
                                  P.EXASCALE_POWER_RHO55)


# ---------------------------------------------------------------------------
# The reference's model-free runtime scenarios, through both packages
# ---------------------------------------------------------------------------

class Pkg:
    """One package's checkpoint runtime behind a common face."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.ck, self.pol, self.en = RC, RPOL, RE
            self.kw = {}
        else:
            self.ck, self.pol, self.en = TC, TPOL, TE
            self.kw = {"device": CPU}
        self.PW = self.en.PAPER_EXASCALE_PROFILE.power_params()

    def store(self, root, **kw):
        return self.ck.ShardedStore(self.ck.StoreConfig(root=str(root), **kw,
                                                        **self.kw))

    def policy(self, strategy="fixed", period=10.0, **kw):
        return self.pol.CheckpointPolicy(
            self.pol.PolicyConfig(strategy=strategy, fixed_period_s=period,
                                  **kw), self.PW, **self.kw)

    def manager(self, root, policy=None, store_kw=None, **cfg):
        return self.ck.CheckpointManager(
            self.store(root, **(store_kw or {})),
            policy if policy is not None else self.policy(),
            self.ck.ManagerConfig(**cfg) if cfg else None)

    def tree(self, npt):
        if self.name == "jax":
            return jax.tree.map(jnp.asarray, npt)
        return interop.state_from_numpy(npt, CPU)

    def leaves(self, tree):
        if self.name == "jax":
            return [np.asarray(x) for x in jax.tree.leaves(tree)]
        return [x.numpy() for x in tree_leaves(tree)]


def small_tree(seed=0):
    """The reference's ``small_tree`` shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((128, 64)).astype(np.float32),
            "nested": {"b": np.arange(10, dtype=np.int32),
                       "c": rng.standard_normal((4096, 32)).astype(
                           np.float32)}}


def fi_tree(seed=0):
    """``tests/test_faultinject.py``'s ``small_tree`` shapes."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((256, 64)).astype(np.float32),
            "b": np.arange(7, dtype=np.int32)}


def _fp(leaves):
    """A comparable fingerprint of restored leaves."""
    return [(x.dtype.str, x.shape, x.tobytes()) for x in leaves]


def _corrupt(path, at):
    data = bytearray(path.read_bytes())
    data[at] ^= 0xFF
    path.write_bytes(bytes(data))


# -- TestStore ---------------------------------------------------------------

def sc_store_roundtrip(K, tmp):
    store = K.store(tmp)
    npt = small_tree()
    store.save(5, K.tree(npt))
    out, step = store.restore(K.tree(npt))
    assert step == 5
    for a, b in zip(jax.tree.leaves(npt), K.leaves(out)):
        np.testing.assert_array_equal(a, b)
    return step, _fp(K.leaves(out))


def sc_store_retention_gc(K, tmp):
    store = K.store(tmp, retain=2)
    tree = K.tree(small_tree())
    for s in (1, 2, 3, 4):
        store.save(s, tree)
    gens = [g.name for g in store.generations()]
    assert gens == ["step_000000003", "step_000000004"]
    return gens


def sc_store_corruption_falls_back(K, tmp):
    store = K.store(tmp)
    t1, t2 = K.tree(small_tree(1)), K.tree(small_tree(2))
    store.save(1, t1)
    store.save(2, t2)
    _corrupt(next(store.generations()[-1].glob("shard_*.npz")), 100)
    out, step = store.restore(t1)
    assert step == 1
    np.testing.assert_array_equal(K.leaves(out)[0], small_tree(1)["a"])
    return step, _fp(K.leaves(out))


def sc_store_torn_write_invisible(K, tmp):
    store = K.store(tmp)
    tree = K.tree(small_tree())
    store.save(1, tree)
    torn = Path(tmp) / "step_000000009"
    torn.mkdir()
    (torn / "shard_00000.npz").write_bytes(b"garbage")
    _, step = store.restore(tree)
    assert step == 1
    return step


def sc_store_compressed_smaller_and_close(K, tmp):
    plain, comp = K.store(Path(tmp) / "p"), K.store(Path(tmp) / "c",
                                                   compress=True)
    w = np.random.default_rng(0).standard_normal((512, 512)).astype(
        np.float32)
    tree = K.tree({"w": w})
    m1, m2 = plain.save(1, tree), comp.save(1, tree)
    assert m2["bytes"] < 0.4 * m1["bytes"]
    out, _ = comp.restore(tree)
    got = K.leaves(out)[0]
    assert np.max(np.abs(got - w)) / np.max(np.abs(w)) < 0.01
    return m1["bytes"], m2["bytes"], _fp([got])


def sc_store_restore_empty(K, tmp):
    out, step = K.store(tmp).restore(K.tree(small_tree()))
    assert out is None and step is None
    return step


# -- TestManager -------------------------------------------------------------

def sc_manager_async_checkpoint_and_restore(K, tmp):
    mgr = K.manager(tmp)
    tree = K.tree(small_tree())
    mgr.checkpoint(3, tree)
    mgr.wait()
    out, step, source = mgr.restore(tree)
    assert step == 3 and source == "store"
    return step, source, _fp(K.leaves(out))


def sc_manager_buddy_recovery_when_store_lost(K, tmp):
    mgr = K.manager(tmp)
    tree = K.tree(small_tree())
    mgr.checkpoint(7, tree, block=True)
    for g in mgr.store.generations():
        for p in sorted(g.glob("**/*"), reverse=True):
            p.unlink()
        g.rmdir()
    out, step, source = mgr.restore(tree)
    assert step == 7 and source == "buddy"
    np.testing.assert_array_equal(K.leaves(out)[0], small_tree()["a"])
    return step, source, _fp(K.leaves(out))


def sc_manager_policy_cadence(K, tmp):
    pol = K.policy(period=5.0)
    for _ in range(5):
        pol.observe_step_time(1.0)
    mgr = K.manager(tmp, policy=pol)
    tree = K.tree(small_tree())
    saved = [s for s in range(1, 21) if mgr.maybe_checkpoint(s, tree)]
    mgr.wait()
    assert saved == [1, 6, 11, 16]
    return saved


def sc_manager_measured_C_feeds_policy(K, tmp):
    pol = K.policy(strategy="algo_t", C_s=99.0, mu_s=3600.0)
    mgr = K.manager(tmp, policy=pol)
    mgr.checkpoint(1, K.tree(small_tree()), block=True)
    assert pol.checkpoint_params().C < 10.0
    return "measured"


# -- TestManagerMultilevel ---------------------------------------------------

def sc_ml_maybe_checkpoint_honors_pfs_every_m(K, tmp):
    pol = K.policy(period=1.0)
    for _ in range(3):
        pol.observe_step_time(1.0)
    mgr = K.manager(tmp, policy=pol, async_write=False, pfs_every=3)
    tree = K.tree(small_tree())
    saved = [s for s in range(1, 10) if mgr.maybe_checkpoint(s, tree)]
    assert saved == list(range(1, 10))
    gens = [g.name for g in mgr.store.generations()]
    assert gens == ["step_000000004", "step_000000007"]
    levels = [s["level"] for s in mgr.stats]
    assert levels == [2, 1, 1] * 3
    _, step, source = mgr.restore(tree)
    assert source == "buddy" and step == 9
    return saved, gens, levels, step, source


def sc_ml_buddy_restore_after_torn_pfs_write(K, tmp):
    mgr = K.manager(tmp, async_write=False, pfs_every=2)
    t1, t2 = K.tree(small_tree(1)), K.tree(small_tree(2))
    mgr.checkpoint(1, t1)
    mgr.checkpoint(2, t2)
    _corrupt(next(mgr.store.generations()[-1].glob("shard_*.npz")), 50)
    out, step, source = mgr.restore(t1)
    assert source == "buddy" and step == 2
    np.testing.assert_array_equal(K.leaves(out)[0], small_tree(2)["a"])
    return step, source, _fp(K.leaves(out))


def sc_ml_compressed_roundtrip_through_recovery(K, tmp):
    mgr = K.manager(tmp, store_kw=dict(compress=True), async_write=False,
                    use_buddy=False)
    w = np.random.default_rng(3).standard_normal((512, 512)).astype(
        np.float32)
    tree = K.tree({"w": w})
    mgr.checkpoint(11, tree)
    out, step, source = mgr.restore(tree)
    assert step == 11 and source == "store"
    got = K.leaves(out)[0]
    assert np.max(np.abs(got - w)) / np.max(np.abs(w)) < 0.01
    return step, source, _fp([got])


def sc_ml_pfs_every_without_buddy_rejected(K, tmp):
    with pytest.raises(ValueError):
        K.manager(tmp, use_buddy=False, pfs_every=2)
    return "rejected"


def sc_ml_shallow_override_without_buddy_rejected(K, tmp):
    mgr = K.manager(tmp, async_write=False, use_buddy=False)
    with pytest.raises(ValueError):
        mgr.checkpoint(1, K.tree(small_tree()), deep=False)
    assert mgr.stats == [] and mgr._last_ckpt_step is None
    return "rejected"


# -- TestEnergyMeter ---------------------------------------------------------

def sc_meter_phase_integration(K, tmp):
    m = K.en.EnergyMeter(K.en.PAPER_EXASCALE_PROFILE)
    m.add(K.en.Phase.COMPUTE, 10.0)
    m.add(K.en.Phase.CHECKPOINT_IO, 2.0)
    m.add(K.en.Phase.CHECKPOINT_IO, 1.0, advances_wall=False)
    m.add(K.en.Phase.DOWN, 1.0)
    e = m.energy_j()
    assert e["static"] == pytest.approx(13.0 * 10.0)
    assert e["compute"] == pytest.approx(10.0 * 10.0)
    assert e["io"] == pytest.approx(3.0 * 100.0)
    assert m.report()["rho"] == pytest.approx(5.5)
    return e, m.report()


def sc_meter_two_level_report(K, tmp):
    ph = K.en.Phase
    out = []
    for prof in (K.en.PAPER_EXASCALE_ML_PROFILE, K.en.TPU_V5E_HOST_PROFILE):
        m = K.en.EnergyMeter(prof)
        for phase, s, adv in ((ph.COMPUTE, 7.5, True),
                              (ph.CHECKPOINT_IO_BUDDY, 0.5, True),
                              (ph.RECOVERY_IO_BUDDY, 0.25, True),
                              (ph.RECOVERY_IO, 1.5, True),
                              (ph.COMPUTE, 0.125, False), (ph.IDLE, 2.0, True)):
            m.add(phase, s, advances_wall=adv)
        out.append((m.report(), dataclasses.asdict(prof.ml_power_params())))
    return out


def sc_meter_negative_interval_raises(K, tmp):
    m = K.en.EnergyMeter(K.en.PAPER_EXASCALE_PROFILE)
    with pytest.raises(ValueError):
        m.add(K.en.Phase.COMPUTE, -1.0)
    return "raised"


# -- test_faultinject: TestFaultPlan -----------------------------------------

def sc_plan_rejects_unknown_point_and_kind(K, tmp):
    with pytest.raises(ValueError):
        K.ck.FaultPlan(fail_at="nonsense")
    with pytest.raises(ValueError):
        K.ck.FaultPlan(kind="nonsense")
    return K.ck.FAULT_POINTS


def sc_plan_wrong_point_is_noop(K, tmp):
    plan = K.ck.FaultPlan(fail_at="manifest_commit", kind="error")
    assert plan.take("shard_write") is None and plan.fired == 0
    return plan.fired


def sc_plan_error_honors_trigger_budget(K, tmp):
    plan = K.ck.FaultPlan(fail_at="shard_write", kind="error", max_triggers=2)
    for _ in range(2):
        with pytest.raises(IOError):
            plan.take("shard_write")
    assert plan.take("shard_write") is None and plan.fired == 2
    return plan.fired


def sc_plan_transient_burst_then_clean(K, tmp):
    plan = K.ck.FaultPlan(fail_at="shard_write", kind="transient",
                          transient_errors=3)
    for _ in range(3):
        with pytest.raises(K.ck.TransientIOError):
            plan.take("shard_write")
    assert plan.take("shard_write") is None
    return plan.fired


def sc_plan_stall_interruptible_by_abort(K, tmp):
    plan = K.ck.FaultPlan(fail_at="shard_write", kind="stall", stall_s=30.0)
    abort = threading.Event()
    abort.set()
    with pytest.raises(K.ck.FlushAborted):
        plan.take("shard_write", abort=abort)
    return plan.fired


# -- TestStoreInjection ------------------------------------------------------

def sc_inj_torn_write_leaves_uncommitted_generation(K, tmp):
    store = K.store(tmp)
    tree = K.tree(fi_tree())
    store.save(1, tree)
    store.fault_plan = K.ck.FaultPlan(fail_at="shard_write", kind="torn",
                                      torn_after_bytes=128)
    with pytest.raises(IOError):
        store.save(2, tree)
    _, step = store.restore(tree)
    assert step == 1
    torn = store.root / "step_000000002"
    assert torn.exists() and not (torn / "manifest.json").exists()
    size = (torn / "shard_00000.npz.tmp").stat().st_size
    store.fault_plan = None
    store.save(3, tree)
    assert not torn.exists()
    return step, size


def sc_inj_gc_keeps_newer_uncommitted_generation(K, tmp):
    store = K.store(tmp)
    tree = K.tree(fi_tree())
    store.save(1, tree)
    inflight = store.root / "step_000000009"
    inflight.mkdir()
    (inflight / "shard_00000.npz.tmp").write_bytes(b"partial")
    store.save(2, tree)
    assert inflight.exists()
    return "kept"


def sc_inj_corruption_commits_but_fails_validation(K, tmp):
    store = K.store(tmp)
    tree = K.tree(fi_tree())
    store.save(1, tree)
    store.fault_plan = K.ck.FaultPlan(fail_at="manifest_commit",
                                      kind="corrupt")
    store.save(2, tree)
    gen2 = store.root / "step_000000002"
    assert (gen2 / "manifest.json").exists() and not store.validate(gen2)
    _, step = store.restore(tree)
    assert step == 1
    return step


def sc_inj_abort_event_interrupts_save(K, tmp):
    store = K.store(tmp)
    abort = threading.Event()
    abort.set()
    with pytest.raises(K.ck.FlushAborted):
        store.save(5, K.tree(fi_tree()), abort=abort)
    assert store.latest() is None
    assert store.invalidate(5) and store.generations() == []
    return "aborted"


def sc_inj_invalidate_missing_generation(K, tmp):
    assert not K.store(tmp).invalidate(42)
    return False


# -- TestFlushController -----------------------------------------------------

def _controller(K, tmp, **cfg):
    store = K.store(tmp)
    ctl = K.ck.FlushController(store, **cfg)
    outcomes = []
    return store, ctl, outcomes, (
        lambda step, outcome, payload: outcomes.append(outcome))


def sc_flush_transient_errors_absorbed_by_retry(K, tmp):
    store, ctl, outcomes, done = _controller(K, tmp, retries=2,
                                             backoff_s=0.001)
    store.fault_plan = K.ck.FaultPlan(fail_at="shard_write",
                                      kind="transient", transient_errors=2)
    tree = K.tree(fi_tree())
    ctl.run_sync(1, lambda abort: store.save(1, tree, abort=abort), done)
    assert outcomes == ["ok"] and store.validate(store.latest())
    return outcomes


def sc_flush_retry_budget_exhausted_fails(K, tmp):
    store, ctl, outcomes, done = _controller(K, tmp, retries=1,
                                             backoff_s=0.001)
    store.fault_plan = K.ck.FaultPlan(fail_at="shard_write",
                                      kind="transient", transient_errors=5)
    tree = K.tree(fi_tree())
    ctl.run_sync(1, lambda abort: store.save(1, tree, abort=abort), done)
    assert outcomes == ["failed"] and store.latest() is None
    return outcomes


def sc_flush_abort_interrupts_backoff(K, tmp):
    store, ctl, outcomes, done = _controller(K, tmp, retries=3,
                                             backoff_s=60.0)
    store.fault_plan = K.ck.FaultPlan(fail_at="shard_write",
                                      kind="transient", transient_errors=5)
    tree = K.tree(fi_tree())
    ctl.submit(1, lambda abort: store.save(1, tree, abort=abort), done)
    assert ctl.abort()
    assert outcomes == ["aborted"]
    return outcomes


def sc_flush_injected_fault_during_retry_backoff(K, tmp):
    store, ctl, outcomes, done = _controller(K, tmp, retries=3,
                                             backoff_s=0.001)
    store.fault_plan = K.ck.FaultPlan(fail_at="retry_backoff", kind="error")

    def write(abort):
        raise K.ck.TransientIOError("first attempt fails")
    ctl.run_sync(1, write, done)
    assert outcomes == ["failed"]
    return outcomes


# -- TestManagerFaults -------------------------------------------------------

def sc_mf_discard_in_flight_rejects_raced_commit(K, tmp):
    mgr = K.manager(tmp, async_write=False)
    t1, t2 = K.tree(fi_tree(1)), K.tree(fi_tree(2))
    mgr.checkpoint(1, t1)
    mgr.checkpoint(2, t2)
    mgr.discard_in_flight(2, level=2)
    out, step, source = mgr.restore(t1)
    assert step == 1
    np.testing.assert_array_equal(K.leaves(out)[0], fi_tree(1)["a"])
    return step, source


def sc_mf_buddy_revert_falls_back_one_generation(K, tmp):
    mgr = K.manager(tmp, async_write=False, pfs_every=2)
    t1, t2 = K.tree(fi_tree(1)), K.tree(fi_tree(2))
    mgr.checkpoint(1, t1)
    mgr.checkpoint(2, t2)
    mgr.discard_in_flight(2, level=1)
    _, step, source = mgr.restore(t1)
    assert (step, source) == (1, "store")
    return step, source


def sc_mf_degrades_after_consecutive_failures_then_heals(K, tmp):
    store = K.store(tmp)
    alarms = []
    mgr = K.ck.CheckpointManager(
        store, K.policy(period=0.0),
        K.ck.ManagerConfig(async_write=False, pfs_every=1, flush_retries=0,
                           degrade_after=2, heal_every=2),
        on_alarm=alarms.append)
    tree = K.tree(fi_tree())
    store.fault_plan = K.ck.FaultPlan(fail_at="shard_write", kind="error",
                                      max_triggers=2)
    trace = [mgr.checkpoint(1, tree), mgr.checkpoint(2, tree), mgr.degraded,
             mgr.policy.deep_available, mgr.due(3), mgr.checkpoint(3, tree),
             mgr.due(4), mgr.checkpoint(4, tree), mgr.degraded,
             mgr.policy.deep_available]
    assert trace == [2, 2, True, False, 1, 1, 2, 2, False, True]
    kinds = [a["kind"] for a in alarms]
    assert kinds == ["pfs_degraded", "pfs_healed"]
    assert store.validate(store.latest())
    return trace, kinds


def sc_mf_aborts_do_not_count_toward_degradation(K, tmp):
    mgr = K.manager(tmp, async_write=False, degrade_after=1)
    tree = K.tree(fi_tree())
    for step in (1, 2, 3):
        mgr.checkpoint(step, tree)
        mgr.discard_in_flight(step, level=2)
    assert not mgr.degraded and mgr.alarms == []
    return mgr.degraded


# -- TestPolicyDegradedSolve -------------------------------------------------

def sc_pol_buddy_only_resolve_and_restore(K, tmp):
    prof = K.en.PAPER_EXASCALE_ML_PROFILE
    pol = K.pol.CheckpointPolicy(
        K.pol.PolicyConfig(strategy="algo_t_ml", C_s=1.5, R_s=1.5, D_s=0.2,
                           C1_s=0.3, R1_s=0.3, D1_s=0.1, q=0.15, mu_s=15.0,
                           omega=0.0, mu_from_observations=False),
        prof.power_params(), ml_power=prof.ml_power_params(), **K.kw)
    T_full, m_full = pol.period_seconds(), pol.deep_every()
    assert m_full >= 1
    pol.set_deep_available(False)
    assert pol.deep_every() == 1
    T_deg = pol.period_seconds()
    pol.set_deep_available(True)
    assert (pol.period_seconds(), pol.deep_every()) == (T_full, m_full)
    return T_full, m_full, T_deg


def sc_pol_overlap_for_levels(K, tmp):
    pol = K.policy(strategy="algo_t_ml", omega=0.2, omega2=0.9,
                   mu_from_observations=False)
    single = K.policy(strategy="algo_t", omega=0.4)
    out = (pol.overlap_for(1), pol.overlap_for(2), single.overlap_for(2))
    assert out == pytest.approx((0.2, 0.9, 0.4))
    return out


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}


def _close(a, b):
    """Outcomes equal; floats (solved periods) to 1e-8 relative."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or _rel(a, b) <= 1e-8
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("name", SCENARIOS)
def test_runtime_scenario_same_outcome_in_both_packages(name, tmp_path):
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = SCENARIOS[name](Pkg(pkg), d)
    assert _close(out["jax"], out["torch"])


# ---------------------------------------------------------------------------
# Generations across the two packages
# ---------------------------------------------------------------------------

def _cross_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((300, 70)).astype(np.float32),
            "bias": rng.standard_normal(700).astype(np.float32),
            "emb": (rng.lognormal(size=(1024, 33)) * 1e-3).astype(np.float32),
            "step": np.int32(17),
            "ids": np.arange(5000, dtype=np.int32),
            "stack": ({"k": rng.standard_normal((64, 64)).astype(np.float32)},
                      {"k": rng.standard_normal((4096,)).astype(np.float32)})}


def _u8(a):
    return np.ascontiguousarray(np.atleast_1d(a)).view(np.uint8)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_compressed_generation_reads_across_packages(writer, tmp_path):
    npt = _cross_tree()
    W = Pkg(writer)
    W.store(tmp_path, compress=True).save(4, W.tree(npt))
    outs = {}
    for reader in ("jax", "torch"):
        K = Pkg(reader)
        tree, step = K.store(tmp_path, compress=True).restore(K.tree(npt))
        assert step == 4
        outs[reader] = K.leaves(tree)
    for a, b, x in zip(outs["jax"], outs["torch"], jax.tree.leaves(npt)):
        assert a.dtype == b.dtype == x.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_u8(a), _u8(b))
    man = json.loads((tmp_path / "step_000000004" / "manifest.json")
                     .read_text())
    assert sum(e["compressed"] for e in man["leaves"]) == 4


def test_both_stores_write_the_same_payload(tmp_path):
    npt = _cross_tree(1)
    mans, payloads = {}, {}
    for pkg in ("jax", "torch"):
        K = Pkg(pkg)
        K.store(tmp_path / pkg, compress=True).save(2, K.tree(npt))
        gen = tmp_path / pkg / "step_000000002"
        mans[pkg] = json.loads((gen / "manifest.json").read_text())["leaves"]
        with np.load(gen / "shard_00000.npz") as data:
            payloads[pkg] = {k: data[k] for k in data.files}
    assert mans["jax"] == mans["torch"]
    assert payloads["jax"].keys() == payloads["torch"].keys()
    for k, a in payloads["jax"].items():
        b = payloads["torch"][k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(_u8(a), _u8(b))


def test_restored_leaves_land_on_the_like_tree_devices(tmp_path):
    store = TC.ShardedStore(TC.StoreConfig(str(tmp_path), compress=True,
                                           device=CPU))
    tree = interop.state_from_numpy(_cross_tree(), CPU)
    store.save(1, tree)
    assert set(store.last_save) == {"h2d", "quant", "npz", "write", "crc",
                                    "commit"}
    out, _ = store.restore(tree)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in tree_leaves(out))
    assert set(store.last_restore) == {"latest", "read", "h2d", "dequant"}
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            TC.ShardedStore(TC.StoreConfig(str(tmp_path)))


# ---------------------------------------------------------------------------
# Trees: leaf order, interop, and the xLSTM-125M table
# ---------------------------------------------------------------------------

def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


@pytest.fixture(scope="module")
def xlstm_shapes():
    from repro.configs import get_config
    from repro.models import build
    from repro.optim import adamw
    m = build(get_config("xlstm-125m"))
    params = jax.eval_shape(m.init, jax.random.key(0))
    opt = jax.eval_shape(lambda p: adamw.init_state(p, adamw.AdamWConfig()),
                         params)
    return params, opt


def test_xlstm_table_matches_reference_eval_shape(xlstm_shapes):
    params, opt = xlstm_shapes
    ref = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
           for p, x in jax.tree_util.tree_flatten_with_path(params)[0]]
    got = [(_keystr(p), tuple(s), "float32")
           for p, s in chip_smoke.XLSTM_125M_LEAVES]
    assert got == ref
    n = sum(int(np.prod(s)) for _, s in chip_smoke.XLSTM_125M_LEAVES)
    assert n == 173_090_352
    big = [s for _, s in chip_smoke.XLSTM_125M_LEAVES if np.prod(s) >= 4096]
    assert len(big) == 19

    # the whole checkpointed state, flattened by the port, against the
    # reference's flatten of (params, AdamWState)
    state = chip_smoke.xlstm_state(
        lambda kind, shape: torch.empty(
            shape, dtype=torch.int32 if kind == "step" else torch.float32,
            device="meta"))
    leaves = tree_leaves(state)
    rleaves = jax.tree.leaves((params, opt))
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in leaves] \
        == [(tuple(x.shape), str(x.dtype)) for x in rleaves]
    assert len(leaves) == 67


def test_port_tree_flatten_order_matches_jax():
    from repro.optim import adamw
    rng = np.random.default_rng(0)
    params = {"z": rng.standard_normal(3).astype(np.float32),
              "a": {"y": np.ones(2, np.float32), "b": np.zeros(1, np.int32)},
              "stages": ({"q": np.full(2, 3.0, np.float32)},
                         {"k": np.full(2, 4.0, np.float32)}),
              "tail": ()}
    ref_state = jax.device_get((params, adamw.init_state(
        jax.tree.map(jnp.asarray, params), adamw.AdamWConfig())))
    state = interop.state_from_numpy(ref_state, CPU)
    got = [x.numpy() for x in tree_leaves(state)]
    want = [np.asarray(x) for x in jax.tree.leaves(ref_state)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # structure survives: dicts, tuples, the namedtuple, None
    assert type(state[1]).__name__ == "AdamWState"
    assert state[0]["tail"] == ()
    back = tree_map(lambda x: x + 0, state)
    assert type(back[1]) is type(state[1])
    leaves, td = tree_flatten({"b": None, "a": [1, (2, None)]})
    assert leaves == [1, 2] and str(td) == "{'a': [*, (*, None)], 'b': None}"


def test_interop_carries_multilevel_params():
    for case in ML_CASES:
        ref = R.MultilevelCheckpointParams(**ML_CASES[case])
        got = interop.ml_ckpt_from_fields(dataclasses.asdict(ref))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    got = interop.ml_power_from_fields(dataclasses.asdict(
        R.EXASCALE_ML_POWER))
    assert dataclasses.asdict(got) == dataclasses.asdict(R.EXASCALE_ML_POWER)


def test_tree_functions_leave_no_reference_cycle():
    """``tree_flatten``, ``tree_unflatten`` and ``tree_map`` free a tree's
    leaves as soon as the caller drops them, without waiting for the
    cyclic garbage collector: their recursive helpers referred to
    themselves through their closures, and on the card a served model's
    weights outlived the run that made them."""
    import gc
    import weakref
    from repro_torch.ckpt.tree import tree_unflatten
    was = gc.isenabled()
    gc.disable()
    try:
        x = torch.zeros(4)
        ref = weakref.ref(x)
        tree = {"a": (x, [x * 2]), "b": None}
        leaves, td = tree_flatten(tree)
        tree_unflatten(td, leaves)
        tree_map(lambda t: t + 1, tree)
        del x, tree, leaves
        assert ref() is None
    finally:
        if was:
            gc.enable()
