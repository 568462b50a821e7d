"""The port's fault-tolerant training runtime (``repro_torch.ft``) against
the JAX package's, on the CPU.

* Trackers: the same records, stdout lines and JSONL bytes for the same
  calls.  Watchdog: the same events on the same step-time series.
* Injector: failure times, hardness and ``n_hard`` bitwise the
  reference's for exponential, Weibull(0.7), log-normal and trace replay
  at several seeds, with q in {0, 0.5}.
* The trainer against the reference's on reduced xLSTM (the port's
  ``--smoke`` width), the reference's initialised parameters and AdamW
  state carried across: four of ``validate_runtime``'s families at one
  seed.  The wall time, every energy phase, the operating point, the
  policy report and ``predicted`` within 1e-12 relative; the counts and
  the (step, level) sequence of checkpoints exactly; the losses within
  3e-2, the reference's bf16 tolerance.
* The port's own rollback identity (``tests/test_ckpt_ft.py``'s
  kill-anywhere property) and the fault-point sweep
  (``tests/test_faultinject.py``'s ``SWEEP_POINTS``): final parameters
  bitwise equal to a failure-free run.
* ``build`` and ``execute`` default to ``cuda`` and raise without a GPU.

Every test runs the port in one intra-op thread (restored afterwards):
the sLSTM's eager time loop is several times slower when its tiny ops
are split across threads.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import ft as RF
from repro.core import failures as RCF
from repro.ft import run as RR

from repro_torch import ft as TF
from repro_torch import interop
from repro_torch.ckpt import (CheckpointManager, FaultPlan, ManagerConfig,
                              ShardedStore, StoreConfig)
from repro_torch.ckpt.tree import tree_leaves
from repro_torch.configs import get_config, reduced
from repro_torch.core import failures as TCF
from repro_torch.core.policy import CheckpointPolicy, PolicyConfig
from repro_torch.data import synthetic
from repro_torch.energy import EnergyMeter, PAPER_EXASCALE_PROFILE
from repro_torch.ft import run as TR
from repro_torch.models import build as build_model
from repro_torch.optim import adamw

CPU = "cpu"
PW = PAPER_EXASCALE_PROFILE.power_params()
REL = 1e-12
LOSS_TOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# Trackers and watchdog
# ---------------------------------------------------------------------------

RECORDS = [
    {"kind": "step", "t": 1.0, "step": 1, "step_s": 1.0, "loss": 6.25},
    {"kind": "checkpoint", "t": 2.5, "step": 2, "level": 2,
     "C_s": np.float64(1.5)},
    {"kind": "failure", "t": 3.14159265358979, "hard": True,
     "downtime_s": 0.2, "recovery_s": 1.5, "level": 2, "source": "store",
     "to_step": 2},
    {"kind": "alarm", "t": 4.0, "step": 3, "what": np.int64(7),
     "shape": (2, 3)},
    {"kind": "summary", "t": 1.23456789e-7, "final_step": 3,
     "wall_s": 12345.678901, "energy_total_j": np.float32(2.5)},
    {"step": 9, "note": "no kind"},
]


def test_memory_tracker_records_and_kinds():
    r, t = RF.MemoryTracker(), TF.MemoryTracker()
    for rec in RECORDS:
        r.log(rec)
        t.log(rec)
    assert t.records == r.records
    for kind in ("step", "failure", "summary", "missing"):
        assert t.of_kind(kind) == r.of_kind(kind)
    t.close()
    TF.NullTracker().log(RECORDS[0])


@pytest.mark.parametrize("kinds", [None, ("failure", "summary"), ()])
def test_stdout_tracker_lines(capsys, kinds):
    for mod in (RF, TF):
        tr = mod.StdoutTracker(kinds=kinds)
        for rec in RECORDS:
            tr.log(rec)
        tr.close()
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert len(out) == 2 * half and out[:half] == out[half:]


def test_jsonl_and_composite_trackers_write_the_same_bytes(tmp_path):
    files = {}
    for name, mod in (("ref", RF), ("port", TF)):
        mem = mod.MemoryTracker()
        path = tmp_path / f"{name}.jsonl"
        tr = mod.CompositeTracker(mod.JsonlTracker(path), mem)
        for rec in RECORDS + [{"kind": "odd", "v": set}]:
            tr.log(rec)
        tr.close()
        files[name] = path.read_bytes()
    assert files["port"] == files["ref"]
    back = [json.loads(line) for line in files["port"].decode().splitlines()]
    assert back[0] == RECORDS[0] and back[1]["C_s"] == 1.5
    assert back[-1]["v"] == str(set)
    assert isinstance(TF.MemoryTracker(), TF.Tracker)


def _step_series(seed: int) -> list:
    rng = np.random.default_rng(seed)
    xs = list(1.0 + 0.05 * rng.standard_normal(200))
    for i in (20, 21, 22, 60, 100, 101, 150, 151, 152, 153):
        xs[i] *= 3.0 + rng.random()
    return xs


@pytest.mark.parametrize("cfg", [
    {}, {"ewma_alpha": 0.3, "sigma_threshold": 2.0, "min_samples": 3,
         "consecutive_to_escalate": 2}], ids=["default", "tight"])
@pytest.mark.parametrize("seed", [0, 1])
def test_watchdog_events_equal_the_reference(cfg, seed):
    xs = _step_series(seed)
    got = {}
    for name, mod in (("ref", RF), ("port", TF)):
        seen = []
        wd = mod.StepTimeWatchdog(mod.WatchdogConfig(**cfg),
                                  on_straggler=seen.append)
        flags = [wd.observe(i, x) for i, x in enumerate(xs)]
        got[name] = (flags, wd.events, seen, wd.mean, wd.var, wd.n,
                     wd.consecutive)
    assert got["port"] == got["ref"]
    assert any(got["port"][0]) and any(e["escalate"] for e in got["port"][1])


def test_watchdog_configs_not_shared():
    w1, w2 = TF.StepTimeWatchdog(), TF.StepTimeWatchdog()
    w1.cfg.sigma_threshold = 99.0
    assert w2.cfg.sigma_threshold != 99.0


# ---------------------------------------------------------------------------
# Failure injector
# ---------------------------------------------------------------------------

PROCESS_CASES = {
    "exponential": lambda cf: None,
    "weibull": lambda cf: cf.get_process("weibull", shape=0.7),
    "lognormal": lambda cf: cf.get_process("lognormal", sigma=1.0),
    "trace": lambda cf: cf.get_process("trace",
                                       gaps=[5.0, 9.0, 4.0, 12.0, 6.0]),
}


def _poll(mod, cf, process: str, seed: int, q: float, mu: float = 7.0):
    inj = mod.FailureInjector(mod.FailureModel(
        mu_s=mu, downtime_s=0.1, downtime_hard_s=0.4, seed=seed,
        buddy_loss_prob=q, process=PROCESS_CASES[process](cf)))
    first = inj.next_failure_time
    now, hard, est = 0.0, [], []
    for _ in range(1000):
        now += 0.37
        if inj.check(now):
            hard.append(inj.last_was_hard)
            est.append(inj.mtbf_estimate())
            # the trainer jumps past the downtime after a failure
            now += inj.downtime_for(inj.last_was_hard)
    return (first, inj.failure_times, hard, inj.n_failures, inj.n_hard,
            est, inj.next_failure_time, inj.downtime_for(True),
            inj.downtime_for(False))


@pytest.mark.parametrize("q", [0.0, 0.5])
@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("process", sorted(PROCESS_CASES))
def test_injector_bitwise_the_reference(process, seed, q):
    ref = _poll(RF, RCF, process, seed, q)
    got = _poll(TF, TCF, process, seed, q)
    assert got == ref
    assert got[3] >= 10 and (got[4] > 0) == (q > 0)


def test_injector_hardness_leaves_the_schedule_alone():
    """The same gaps with q = 0 and q = 0.5 (the hard downtime moves the
    poll clock, so one run sees more of them)."""
    a = _poll(TF, TCF, "weibull", 5, 0.0)
    b = _poll(TF, TCF, "weibull", 5, 0.5)
    n = min(len(a[1]), len(b[1]))
    assert n >= 10 and a[1][:n] == b[1][:n] and b[4] > 0


def test_injector_disabled_and_from_platform():
    for mu in (float("inf"), 0.0):
        inj = TF.FailureInjector(TF.FailureModel(mu_s=mu))
        assert not inj.enabled and not inj.check(1e30)
        assert inj.next_failure_time == np.inf
        assert inj.mtbf_estimate() is None
    fm = TF.FailureModel.from_platform(n_nodes=1000, mu_ind_s=3.6e6,
                                       seed=4, downtime_s=3.0)
    rm = RF.FailureModel.from_platform(n_nodes=1000, mu_ind_s=3.6e6,
                                       seed=4, downtime_s=3.0)
    assert dataclasses.asdict(fm) == dataclasses.asdict(rm)
    assert fm.mu_s == 3600.0


# ---------------------------------------------------------------------------
# The trainer against the reference's, reference params carried across
# ---------------------------------------------------------------------------

#: the port's smoke width: 2 layers (an mLSTM and an sLSTM), d 64, one
#: mLSTM head of 128.
_BASE = dict(arch="xlstm-125m", layers=2, d_model=64, n_heads=1,
             batch=2, seq=16, total_steps=60, step_s=1.0, omega=0.0)
_SL = dict(_BASE, mu_s=15.0, C_s=0.5, R_s=0.5, D_s=0.1, use_buddy=False)
_ML = dict(_BASE, mu_s=15.0, C_s=1.5, R_s=1.5, D_s=0.2, C1_s=0.3,
           R1_s=0.3, D1_s=0.1, q=0.15, profile="paper_ml")
_WEIBULL = dict(process="weibull", process_kwargs={"shape": 0.7})

FAMILIES = {
    "single_exp": dict(_SL, strategy="algo_t", seed=0),
    "single_weibull": dict(_SL, strategy="algo_t", seed=1, **_WEIBULL),
    "ml_exp_q015": dict(_ML, strategy="algo_t_ml", seed=3),
    "ml_async_w2_05": dict(_ML, strategy="algo_t_ml", omega2=0.5, seed=0),
}


def _port_cfg(spec):
    return reduced(get_config(spec.arch), n_layers=spec.layers,
                   d_model=spec.d_model, n_heads=spec.n_heads)


def _run_both(kw, tmp_path):
    rspec = RR.RunSpec(ckpt_dir=str(tmp_path / "ref"), **kw)
    rt = RR.build(rspec)
    rparams, ropt = jax.device_get(rt.state)
    rmem, tmem = RF.MemoryTracker(), TF.MemoryTracker()
    rt.tracker = rmem
    rrep = rt.run()
    rrep["predicted"] = RR.predictions(rspec, rrep)

    tspec = TR.RunSpec(ckpt_dir=str(tmp_path / "port"), **kw)
    tt = TR.build(tspec, tracker=tmem, device=CPU)
    tt.state = (interop.params_from_numpy(rparams, _port_cfg(tspec),
                                          device=CPU),
                interop.opt_state_from_numpy(ropt, device=CPU))
    trep = tt.run()
    trep["predicted"] = TR.predictions(tspec, trep, device=CPU)
    return rrep, trep, rmem, tmem


def _close_dict(got: dict, ref: dict, what: str):
    assert set(got) == set(ref), what
    for k, v in ref.items():
        if isinstance(v, float):
            assert _rel(got[k], v) <= REL, (what, k, got[k], v)
        else:
            assert got[k] == v, (what, k, got[k], v)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_runs(request, tmp_path_factory):
    name = request.param
    return name, _run_both(FAMILIES[name], tmp_path_factory.mktemp(name))


def test_trainer_report_equals_the_reference(family_runs):
    name, (rrep, trep, rmem, tmem) = family_runs
    assert trep["final_step"] == rrep["final_step"] == 60
    for key in ("n_failures", "n_hard_failures", "n_rollbacks",
                "flush_aborts", "flush_errors", "straggler_events",
                "straggler_escalations", "pfs_degraded", "alarms"):
        assert trep[key] == rrep[key], (name, key)
    assert rrep["n_failures"] >= 1
    assert _rel(trep["wall_s"], rrep["wall_s"]) <= REL
    _close_dict(trep["energy"], rrep["energy"], "energy")
    _close_dict(trep["operating_point"], rrep["operating_point"], "op")
    _close_dict(trep["policy"], rrep["policy"], "policy")
    _close_dict(trep["predicted"], rrep["predicted"], "predicted")
    # the written checkpoints in the trainer's (virtual-time) order; the
    # report's list is in the order the flush thread finished them, and
    # holds a flush that committed before its abort landed
    seq = lambda mem: [(r["step"], r["level"], r["C_s"])
                       for r in mem.of_kind("checkpoint")]
    assert seq(tmem) == seq(rmem) and len(seq(tmem)) >= 10
    if not rrep["flush_aborts"]:
        stats = lambda rep: sorted((c["step"], c["level"], c["C_s"])
                                   for c in rep["checkpoints"])
        assert stats(trep) == stats(rrep)


def test_trainer_losses_within_bf16_tolerance(family_runs):
    name, (rrep, trep, _, _) = family_runs
    assert len(trep["losses"]) == len(rrep["losses"])
    worst = max(_rel(a, b) for a, b in zip(trep["losses"], rrep["losses"]))
    assert worst <= LOSS_TOL, (name, worst)
    assert all(math.isfinite(x) for x in trep["losses"])


def test_trainer_tracker_stream_equals_the_reference(family_runs):
    name, (_, _, rmem, tmem) = family_runs
    strip = lambda recs: [{k: v for k, v in r.items() if k != "loss"}
                          for r in recs]
    got, ref = strip(tmem.records), strip(rmem.records)
    assert [r["kind"] for r in got] == [r["kind"] for r in ref]
    for g, r in zip(got, ref):
        _close_dict(g, r, name)


def test_async_family_aborts_a_flush(family_runs):
    """The ω2 family exercises the in-flight window (a failure inside it
    aborts the deep flush), the others never abort one."""
    name, (rrep, trep, _, _) = family_runs
    if name == "ml_async_w2_05":
        assert trep["flush_aborts"] >= 1
    else:
        assert trep["flush_aborts"] == 0


# ---------------------------------------------------------------------------
# The port's rollback identity and the fault-point sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_rig():
    cfg = reduced(get_config("xlstm-125m"))
    m = build_model(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    params = m.init(torch.Generator().manual_seed(0), device=CPU)
    return cfg, m, ocfg, m.make_train_step(ocfg), params


def _trainer(tmp, rig, mu_s, seed=0, steps=20, strategy="algo_t",
             process=None, pfs_every=1, q=0.0, fault_plan=None,
             manager_kw=None, omega2=None):
    cfg, m, ocfg, step_fn, params = rig
    opt = adamw.init_state(params, ocfg, device=CPU)
    data = synthetic.for_arch(cfg, batch=2, seq_len=16, seed=1, device=CPU)
    pol = CheckpointPolicy(PolicyConfig(strategy=strategy, C_s=0.05,
                                        R_s=0.05, D_s=0.1, mu_s=mu_s,
                                        omega=0.5, omega2=omega2), PW,
                           device=CPU)
    store = ShardedStore(StoreConfig(root=str(tmp), device=CPU))
    store.fault_plan = fault_plan
    mgr = CheckpointManager(store, pol, ManagerConfig(
        pfs_every=pfs_every, **(manager_kw or {})))
    inj = TF.FailureInjector(TF.FailureModel(
        mu_s=mu_s, downtime_s=0.1, seed=seed, process=process,
        buddy_loss_prob=q))
    return TF.FaultTolerantTrainer(
        train_step=step_fn, state=(params, opt), data=data, policy=pol,
        manager=mgr, meter=EnergyMeter(PAPER_EXASCALE_PROFILE), failures=inj,
        config=TF.TrainerConfig(total_steps=steps, sim_seconds_per_step=1.0))


def _assert_same_params(a, b):
    for x, y in zip(tree_leaves(a.state[0]), tree_leaves(b.state[0])):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def clean_run(tiny_rig, tmp_path_factory):
    t = _trainer(tmp_path_factory.mktemp("clean"), tiny_rig,
                 mu_s=float("inf"))
    return t, t.run()


class TestRollbackIdentity:
    def test_failures_do_not_change_result(self, tmp_path, tiny_rig,
                                           clean_run):
        t_clean, rep_c = clean_run
        t = _trainer(tmp_path, tiny_rig, mu_s=7.0, seed=3)
        rep = t.run()
        assert rep["n_failures"] >= 1
        assert rep["final_step"] == rep_c["final_step"] == 20
        _assert_same_params(t, t_clean)

    @pytest.mark.parametrize("process_kw", [
        {"process": TCF.get_process("weibull", shape=0.7), "seed": 5},
        {"process": TCF.get_process("trace",
                                    gaps=[5.0, 9.0, 4.0, 12.0, 6.0],
                                    rescale=False), "seed": 0},
    ], ids=["weibull", "trace_replay"])
    def test_rollback_identity_any_process(self, tmp_path, tiny_rig,
                                           clean_run, process_kw):
        t_clean, rep_c = clean_run
        t = _trainer(tmp_path, tiny_rig, mu_s=7.0, **process_kw)
        rep = t.run()
        assert rep["n_failures"] >= 1
        assert rep["final_step"] == rep_c["final_step"]
        _assert_same_params(t, t_clean)

    def test_rollback_identity_multilevel(self, tmp_path, tiny_rig):
        """Buddy-only checkpoints every period, PFS every 3rd, and hard
        failures (q = 0.5) that drop the buddy and recover deep."""
        t_clean = _trainer(tmp_path / "clean", tiny_rig, mu_s=float("inf"),
                           pfs_every=3)
        rep_c = t_clean.run()
        t = _trainer(tmp_path / "fail", tiny_rig, mu_s=5.0, seed=2,
                     pfs_every=3, q=0.5)
        rep = t.run()
        assert rep["n_failures"] >= 2 and rep["n_hard_failures"] >= 1
        assert {c["level"] for c in t.manager.stats} == {1, 2}
        assert rep["final_step"] == rep_c["final_step"]
        _assert_same_params(t, t_clean)

    def test_hard_failure_recovers_from_store(self, tmp_path, tiny_rig,
                                              clean_run):
        """q = 1: every failure drops the buddy; every recovery reads the
        deep level and the run still ends bit-identical."""
        t_clean, rep_c = clean_run
        t = _trainer(tmp_path, tiny_rig, mu_s=8.0, seed=2, q=1.0)
        rep = t.run()
        assert rep["final_step"] == rep_c["final_step"]
        assert rep["n_failures"] >= 1
        assert rep["n_hard_failures"] == rep["n_failures"]
        sources = [e["source"] for e in t.log if e.get("event") == "rollback"]
        assert sources and all(s == "store" for s in sources)
        _assert_same_params(t, t_clean)

    def test_watchdog_wired_to_tracker_and_report(self, tmp_path, tiny_rig):
        t = _trainer(tmp_path, tiny_rig, mu_s=float("inf"), steps=4)
        t.tracker = TF.MemoryTracker()
        for i in range(10):
            t.watchdog.observe(i, 1.0)
        for i in range(3):
            t.watchdog.observe(10 + i, 6.0)
        rep = t.run()
        stragglers = t.tracker.of_kind("straggler")
        assert len(stragglers) == 3 and stragglers[-1]["escalate"]
        assert rep["straggler_events"] == 3
        assert rep["straggler_escalations"] == 1
        assert t.tracker.of_kind("step")

    def test_loss_decreases_and_failures_cost_time(self, tmp_path, tiny_rig,
                                                   clean_run):
        _, rep_c = clean_run
        assert rep_c["losses"][-1] < rep_c["losses"][0]
        rep_f = _trainer(tmp_path, tiny_rig, mu_s=6.0, seed=1).run()
        assert rep_f["wall_s"] > rep_c["wall_s"]
        assert rep_f["energy"]["E_total_j"] > rep_c["energy"]["E_total_j"]

    def test_trainer_configs_not_shared(self, tmp_path, tiny_rig):
        t1 = _trainer(tmp_path / "a", tiny_rig, mu_s=float("inf"))
        t2 = _trainer(tmp_path / "b", tiny_rig, mu_s=float("inf"))
        t1.cfg.total_steps = 999
        assert t2.cfg.total_steps != 999


class _Chain:
    """Several FaultPlans consulted in sequence (duck-typed for
    ``store.fault_plan``): a scripted fault can then reach points that
    only exist downstream of another failure (``retry_backoff``)."""

    def __init__(self, *plans):
        self.plans = plans

    @property
    def fired(self):
        return sum(p.fired for p in self.plans)

    def take(self, point, abort=None):
        out = None
        for p in self.plans:
            r = p.take(point, abort=abort)
            out = out if r is None else r
        return out


def _plan_for(point, kind):
    if point == "retry_backoff":
        return _Chain(
            FaultPlan(fail_at="shard_write", kind="transient",
                      transient_errors=1),
            FaultPlan(fail_at=point, kind=kind, max_triggers=2))
    return FaultPlan(fail_at=point, kind=kind, max_triggers=2,
                     transient_errors=2, stall_s=0.005,
                     torn_after_bytes=512)


#: the reference's sweep (tests/test_faultinject.py).
SWEEP_POINTS = [
    ("snapshot", "stall"),
    ("shard_write", "torn"),
    ("shard_write", "transient"),
    ("shard_rename", "error"),
    ("manifest_commit", "error"),
    ("manifest_commit", "corrupt"),
    ("buddy_push", "error"),
    ("retry_backoff", "error"),
]


def _sweep_trainer(tmp, rig, mu_s, seed=0, steps=16, fault_plan=None,
                   manager_kw=None):
    return _trainer(tmp, rig, mu_s, seed=seed, steps=steps,
                    pfs_every=2, fault_plan=fault_plan,
                    manager_kw=dict(flush_backoff_s=0.001,
                                    **(manager_kw or {})))


@pytest.mark.faultinject
class TestFaultPointSweep:
    @pytest.fixture(scope="class")
    def baseline(self, tiny_rig, tmp_path_factory):
        t = _sweep_trainer(tmp_path_factory.mktemp("sweep_clean"), tiny_rig,
                           mu_s=float("inf"))
        return t, t.run()

    @pytest.mark.parametrize("point,kind", SWEEP_POINTS,
                             ids=[f"{p}-{k}" for p, k in SWEEP_POINTS])
    def test_rollback_identity_with_fault(self, tiny_rig, tmp_path,
                                          baseline, point, kind):
        t_clean, rep_c = baseline
        plan = _plan_for(point, kind)
        t = _sweep_trainer(tmp_path, tiny_rig, mu_s=5.0, seed=3,
                           fault_plan=plan)
        rep = t.run()
        assert rep["n_failures"] >= 1
        assert plan.fired >= 1
        assert rep["final_step"] == rep_c["final_step"]
        _assert_same_params(t, t_clean)
        store = t.manager.store
        for gen in store.generations():
            if (gen / "manifest.json").exists() and kind != "corrupt":
                assert store.validate(gen)
        if store.latest() is not None:
            assert store.validate(store.latest())

    def test_degrade_alarm_resolve_heal(self, tiny_rig, tmp_path):
        """A persistently failing PFS: the run completes buddy-only under
        a degradation alarm, then heals, bit-identical throughout."""
        t_clean = _sweep_trainer(tmp_path / "clean", tiny_rig,
                                 mu_s=float("inf"), steps=24)
        rep_c = t_clean.run()
        plan = FaultPlan(fail_at="shard_write", kind="error",
                         max_triggers=4)
        t = _sweep_trainer(tmp_path / "fault", tiny_rig, mu_s=6.0, seed=1,
                           steps=24, fault_plan=plan,
                           manager_kw=dict(flush_retries=0, degrade_after=2,
                                           heal_every=2))
        rep = t.run()
        kinds = [a["kind"] for a in rep["alarms"]]
        assert "pfs_degraded" in kinds and "pfs_healed" in kinds
        assert rep["flush_errors"] >= 2 and not rep["pfs_degraded"]
        assert t.policy.deep_available
        assert 1 in {c["level"] for c in rep["checkpoints"]}
        assert rep["final_step"] == rep_c["final_step"]
        _assert_same_params(t, t_clean)


# ---------------------------------------------------------------------------
# RunSpec and the device convention
# ---------------------------------------------------------------------------

def test_runspec_fields_and_derived_equal_the_reference():
    ref = {f.name: f.default for f in dataclasses.fields(RR.RunSpec)
           if f.default is not dataclasses.MISSING}
    got = {f.name: f.default for f in dataclasses.fields(TR.RunSpec)
           if f.default is not dataclasses.MISSING}
    assert got == ref
    assert [f.name for f in dataclasses.fields(TR.RunSpec)] == \
        [f.name for f in dataclasses.fields(RR.RunSpec)]
    for kw in (FAMILIES["ml_exp_q015"], FAMILIES["single_exp"],
               dict(step_s=None)):
        r, t = RR.RunSpec(**kw), TR.RunSpec(**kw)
        assert (t.scaled_time, t.inject, t.level1()) == \
            (r.scaled_time, r.inject, r.level1())
        assert dataclasses.asdict(t.ml_params()) == \
            dataclasses.asdict(r.ml_params())
    assert not TR.RunSpec(mu_s=0.0).inject
    assert sorted(TR.PROFILES) == sorted(RR.PROFILES)
    for k in TR.PROFILES:
        assert dataclasses.asdict(TR.PROFILES[k]) == \
            dataclasses.asdict(RR.PROFILES[k])


def test_no_prediction_without_failures(tmp_path):
    spec = TR.RunSpec(layers=2, d_model=64, n_heads=1, batch=2, seq=16,
                      total_steps=5, step_s=1.0, ckpt_dir=str(tmp_path))
    rep = TR.execute(spec, device=CPU)
    assert rep["predicted"] == {} and rep["n_failures"] == 0
    assert rep["final_step"] == 5 and rep["spec"] == dataclasses.asdict(spec)


def test_moe_attention_arch_trains_through_the_runtime(tmp_path):
    """An MoE arch trains through the runtime on the CPU (attention's
    blocked backward, the routing): every step runs and the losses are
    finite."""
    spec = TR.RunSpec(arch="dbrx-132b", layers=1, d_model=32,
                      n_heads=2, batch=2, seq=16, total_steps=2,
                      ckpt_dir=str(tmp_path))
    rep = TR.execute(spec, device=CPU)
    assert rep["final_step"] == 2
    assert all(np.isfinite(rep["losses"]))


@pytest.mark.parametrize("entry", ["build", "execute"])
def test_entry_points_default_to_cuda_and_raise_without_a_gpu(entry,
                                                              tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = TR.RunSpec(ckpt_dir=str(tmp_path / "never"))
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(TR, entry)(spec)
    assert not (tmp_path / "never").exists()
