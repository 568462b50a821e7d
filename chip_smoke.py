#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no result line is printed then):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; requires ``torch.cuda.is_available()``.
2. build: compiles the event kernel from ``src/repro_torch/csrc`` and
   prints the build time and the compiler's register report.
3. parity: the kernel against its plain PyTorch version on the card,
   bitwise, under both precision policies, on a dyadic schedule, a ragged
   shape (B=37, N=333, F=200) and the exhaustion/truncation case.
4. model sweep: ``evaluate_grid`` on the 1,000,000-point
   ``mu_rho_grid(linspace(30,600,1000), linspace(1,10,1000))`` under both
   policies; the compensated periods, re-evaluated in f64, must be within
   ``objective_tol`` (1e-6) of the f64 objectives and ``argmin_rtol``
   (1e-2) of the f64 periods.
5. Monte-Carlo: ``simulate_trajectories`` on
   ``mu_rho_grid(geomspace(120,1200,32), linspace(2,10,32))`` at the AlgoT
   and AlgoE periods, T_base = 4000, 4096 trials, Exponential and
   Weibull(0.7), both policies.  Gates: no truncated or exhausted lane;
   kernel launched, plain version never called; at least 64 lanes per f64
   run replayed through the scalar oracle ``simulate_once(gaps=...)``
   (floats <= 1e-12 relative, equal failure counts, checkpoint counts
   within one); compensated per-point means within 1e-5 of f64.  The
   MC-to-model gaps are reported, not gated.
6. times: CUDA-event medians of 5 warm runs of the kernel and of the
   plain version over each run's schedules (compared bitwise again at
   these shapes), the schedule sampling, and the end-to-end calls; the
   kernel's bound from the bytes it consumes.

Near the end it prints one JSON line ``{"gates": {...}}`` with every
gate's numbers, then one ``{"kernels": [...]}`` line, then the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published peaks per H100 variant (NVIDIA data sheets): device-memory
#: bytes/s, FP64 and FP32 FLOP/s outside the tensor cores.
_PEAKS = {"PCIe": (2.0e12, 25.6e12, 51.2e12),
          "NVL": (3.9e12, 30.0e12, 60.0e12),
          "SXM": (3.35e12, 34.0e12, 67.0e12)}

#: per-lane output bytes of the event kernel: 4 f64 + 2 int32 + 2 bool.
_OUT_BYTES = 4 * 8 + 2 * 4 + 2 * 1

#: floating-point operations per kernel iteration (one gap), counted from
#: the source with a divide as one: 26 shared by both branches plus up to
#: 14 in the taken branch; the compensated mode forms 5 increments (~16)
#: and folds each in with a 6-operation Neumaier step.
_OPS_PER_GAP = {"f64": 40, "compensated_f32": 72}

#: the reference's CPU figures for the largest MC-vs-model gaps on the MC
#: grid (512 trials): AlgoT time/energy, AlgoE time/energy.
_REF_GAPS = {"algo_t": (0.047, 0.033), "algo_e": (0.127, 0.111)}

N_TRIALS = 4096
T_BASE = 4000.0
#: (mu, rho) points of the model sweep and of the MC grid.
SWEEP_SHAPE = (1000, 1000)
MC_SHAPE = (32, 32)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=False)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi unavailable (rc {smi.returncode})"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    name = torch.cuda.get_device_name(0)
    variant = next((k for k in ("PCIe", "NVL") if k in name), "SXM")
    return card, _PEAKS[variant]


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> float:
    from repro_torch.kernels import _build, event_sweep as es
    t0 = time.perf_counter()
    es.load_library()
    secs = time.perf_counter() - t0
    log(f"build: event_sweep.cu in {secs:.3f} s")
    for line in _build.build_log("event_sweep.cu").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return secs


# ---------------------------------------------------------------------------
# 3. kernel vs plain version on the card
# ---------------------------------------------------------------------------

def _compare(a: dict, b: dict) -> tuple:
    """(bitwise equal, max abs float difference) over the 8 outputs."""
    import torch
    equal, err = True, 0.0
    for k in a:
        x, y = a[k], b[k]
        if not torch.equal(x, y):
            equal = False
        if x.dtype == torch.float64:
            finite = torch.isfinite(x) & torch.isfinite(y)
            if bool(finite.any()):
                err = max(err, float((x - y)[finite].abs().max()))
    return equal, err


def _parity_cases(dev):
    import numpy as np
    import torch
    from repro_torch.sim import get_scenario, grid_from_scenarios
    rng = np.random.default_rng(2024)
    scens = [get_scenario("fig12", mu_min=120.0),
             get_scenario("exascale_rho7", mu_min=300.0),
             get_scenario("fig12", mu_min=600.0),
             get_scenario("fig3", n_nodes=1e6)]
    grid = grid_from_scenarios(scens, device=dev)
    mu = grid.mu.cpu().numpy()
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                  device=dev)
    cases = []
    # (a) dyadic schedule: every quantity exactly representable
    g = rng.exponential(1.0, size=(4, 256, 256)) * mu[:, None, None]
    g = np.maximum(np.round(g * 2.0**16) / 2.0**16, 2.0**-16)
    cases.append(("dyadic", grid, t([40.0, 60.0, 80.0, 14.0]), 500.0,
                  t(g), 257))
    # (b) ragged shape, ordinary exponential schedule
    pick = np.arange(37) % 4
    sub = grid.take(torch.as_tensor(pick, device=dev))
    g = rng.exponential(1.0, size=(37, 333, 200)) * mu[pick][:, None, None]
    T = np.array([40.0, 60.0, 80.0, 14.0])[pick] * (1 + 0.01 * np.arange(37))
    cases.append(("ragged", sub, t(T), 3000.0, t(g), 257))
    # (c) exhaustion (two short gaps) and truncation (two steps only)
    one = grid.take(torch.as_tensor([2], device=dev))
    cases.append(("exhaustion", one, t([60.0]), 4000.0,
                  t(np.array([[[50.0, 70.0]]])), 3))
    g = rng.exponential(1.0, size=(1, 4, 64)) * mu[2]
    cases.append(("truncation", one, t([60.0]), 50000.0, t(g), 2))
    return cases


def phase_parity(dev) -> float:
    import torch
    from repro_torch.kernels.event_sweep import event_sweep, event_sweep_plain
    from repro_torch.sim import COMPENSATED_F32, F64
    max_err = 0.0
    before = event_sweep.launches
    for name, grid, T, T_base, gaps, n_steps in _parity_cases(dev):
        for pol in (F64, COMPENSATED_F32):
            c = pol.cast
            args = (c(T), c(grid.C), c(grid.R), c(grid.D), c(grid.omega),
                    c(torch.full_like(T, T_base)), c(gaps))
            kw = dict(n_steps=n_steps, compensated=pol.compensated)
            ker = event_sweep(*args, **kw)
            ref = event_sweep_plain(*args, **kw)
            torch.cuda.synchronize()
            equal, err = _compare(ker, ref)
            max_err = max(max_err, err)
            flags = (f"exhausted={int(ker['gaps_exhausted'].sum())} "
                     f"truncated={int(ker['truncated'].sum())}")
            log(f"parity {name:10s} {pol.name:15s} shape "
                f"{tuple(gaps.shape)}: bitwise={equal} max_abs_err={err} "
                f"{flags}")
            if not equal:
                fail(f"kernel != plain version on {name}/{pol.name}")
            if name == "exhaustion" and not bool(ker["gaps_exhausted"].all()):
                fail("exhaustion case did not flag gaps_exhausted")
            if name == "truncation" and not bool(ker["truncated"].any()):
                fail("truncation case did not flag truncated")
    if event_sweep.launches <= before:
        fail("the launch counter did not increase")
    return max_err


# ---------------------------------------------------------------------------
# 4 + 5. the main path
# ---------------------------------------------------------------------------

def _sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_main_path(dev):
    """Drive the main path once; returns everything the gates and the
    timing phase need.  Counters are read by the caller around it."""
    import numpy as np
    from repro_torch.core import Exponential, Weibull
    from repro_torch.sim import (COMPENSATED_F32, F64, evaluate_grid,
                                 mu_rho_grid, simulate_trajectories)
    big = mu_rho_grid(np.linspace(30, 600, SWEEP_SHAPE[0]),
                      np.linspace(1, 10, SWEEP_SHAPE[1]), device=dev)
    sweeps = {}
    for pol in (F64, COMPENSATED_F32):
        sweeps[pol.name], secs = _sync_time(
            lambda: evaluate_grid(big, precision=pol, device=dev))
        log(f"evaluate_grid 1e6 points [{pol.name}]: {secs:.4f} s (cold)")

    mc_grid = mu_rho_grid(np.geomspace(120, 1200, MC_SHAPE[0]),
                          np.linspace(2, 10, MC_SHAPE[1]), device=dev)
    model = evaluate_grid(mc_grid, T_base=T_BASE, precision=F64, device=dev)
    runs = {}
    for proc in (Exponential(), Weibull(shape=0.7)):
        for pol in (F64, COMPENSATED_F32):
            for algo, T in (("algo_t", model.T_time),
                            ("algo_e", model.T_energy)):
                key = (proc.name, pol.name, algo)
                runs[key], secs = _sync_time(lambda: simulate_trajectories(
                    T, mc_grid, T_base=T_BASE, n_trials=N_TRIALS, seed=7,
                    process=proc, precision=pol, device=dev))
                log(f"simulate_trajectories {key}: {secs:.4f} s (cold)")
    return big, sweeps, mc_grid, model, runs


def gate_sweep(big, sweeps) -> None:
    import torch
    from repro_torch.sim import COMPENSATED_F32
    from repro_torch.sim.sweep import energy_final_batched, time_final_batched
    r64, r32 = sweeps["f64"], sweeps["compensated_f32"]
    if not torch.equal(r64.valid, r32.valid):
        fail("evaluate_grid: valid masks differ between policies")
    valid = r64.valid.reshape(-1)
    p = {k: v.reshape(-1)[valid] for k, v in big.fields().items()}
    pol = COMPENSATED_F32
    for name, objective in (("T_time", time_final_batched),
                            ("T_energy", energy_final_batched)):
        T64 = getattr(r64, name).reshape(-1)[valid]
        T32 = getattr(r32, name).reshape(-1)[valid]
        arg = float(((T32 - T64).abs() / T64.abs()).max())
        f32 = objective(T32, p, 1.0)
        f64 = objective(T64, p, 1.0)
        obj = float(((f32 - f64).abs() / f64.abs()).max())
        log(f"sweep gate {name}: valid points {int(valid.sum())}, max "
            f"argmin rel {arg:.3e} (<= {pol.argmin_rtol}), max objective "
            f"rel {obj:.3e} (<= {pol.objective_tol})")
        if not (arg <= pol.argmin_rtol and obj <= pol.objective_tol):
            fail(f"compensated evaluate_grid outside its gates on {name}")


def _oracle_lanes(mc_grid, T, n_lanes: int = 72):
    """(point, trial) lanes for the oracle: the smallest-mu and the
    largest-T points first, then a spread over the grid."""
    import numpy as np
    mu = mc_grid.mu.reshape(-1).cpu().numpy()
    Tn = T.reshape(-1).cpu().numpy()
    pts = [int(np.argmin(mu)), int(np.argmax(Tn)),
           int(np.argmax(mu)), int(np.argmin(Tn))]
    pts += [int(i) for i in np.linspace(0, mu.size - 1, 5).astype(int)]
    pts = list(dict.fromkeys(pts))
    per = -(-n_lanes // len(pts))
    trials = np.linspace(0, N_TRIALS - 1, per).astype(int)
    return [(p, int(t)) for p in pts for t in trials]


def gate_mc(mc_grid, model, runs, dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import Exponential, Weibull, simulate_once
    from repro_torch.sim import sampled_schedules
    report = {}
    for key, tb in runs.items():
        bad = int(tb.truncated.sum()) + int(tb.gaps_exhausted.sum())
        if bad:
            fail(f"{key}: {bad} truncated or exhausted lanes")
    procs = {"exponential": Exponential(), "weibull": Weibull(shape=0.7)}
    for (pname, polname, algo), tb in runs.items():
        if polname != "f64":
            continue
        T = model.T_time if algo == "algo_t" else model.T_energy
        lanes = _oracle_lanes(mc_grid, T)
        want = {}
        for p, t in lanes:
            want.setdefault(p, []).append(t)
        rows = {}
        for blk in sampled_schedules(T, mc_grid, T_BASE, N_TRIALS, seed=7,
                                     process=procs[pname], device=dev):
            pts = blk.points.cpu().numpy()
            for i, p in enumerate(pts):
                for t in want.get(int(p), ()):
                    if t in blk.trials:
                        rows[(int(p), t)] = blk.gaps[
                            i, t - blk.trials.start].cpu().numpy()
        worst, ckpt_ties = 0.0, 0
        flat = mc_grid.ravel()
        Tn = T.reshape(-1).cpu().numpy()
        out = {f: getattr(tb, f).reshape(flat.size, N_TRIALS)
               for f in ("wall_time", "energy", "work_executed", "io_time",
                         "down_time", "n_failures", "n_checkpoints")}
        for (p, t), row in rows.items():
            ref = simulate_once(float(Tn[p]), flat.ckpt_at(p),
                                flat.power_at(p), T_BASE, gaps=row)
            for f in ("wall_time", "energy", "work_executed", "io_time",
                      "down_time"):
                got = float(out[f][p, t])
                want_v = getattr(ref, f)
                rel = abs(got - want_v) / max(abs(want_v), 1e-300)
                worst = max(worst, rel)
            if int(out["n_failures"][p, t]) != ref.n_failures:
                fail(f"oracle: n_failures differ at {(pname, algo, p, t)}")
            dc = abs(int(out["n_checkpoints"][p, t]) - ref.n_checkpoints)
            if dc > 1:
                fail(f"oracle: n_checkpoints differ by {dc} at "
                     f"{(pname, algo, p, t)}")
            ckpt_ties += dc
        log(f"oracle {pname}/{algo}: {len(rows)} lanes, max float rel "
            f"{worst:.3e} (<= 1e-12), n_checkpoints ties {ckpt_ties}")
        if len(rows) < 64 or worst > 1e-12:
            fail(f"oracle check failed for {(pname, algo)}")
        report[f"oracle/{pname}/{algo}"] = {"lanes": len(rows),
                                           "max_rel": worst,
                                           "ckpt_ties": ckpt_ties}

    # The compensated runs read the same f64 draws cast to f32.  Rounding a
    # gap or a period to f32 moves a failure by ~1 f32 ulp; one that lands
    # that close to a completion or checkpoint boundary falls on the other
    # side (a checkpoint commits in one run and not in the other, and the
    # lane's wall time jumps by about a period).  Such "flipped" lanes are
    # counted and bounded (<= 1e-3 of lanes); every other lane agrees to
    # 1e-5 relative, and so do the per-point means over those lanes.  The
    # unfiltered per-point means are held to a tenth of the MC standard
    # error.
    fields = ("wall_time", "energy", "work_executed", "io_time")
    for pname in procs:
        for algo in ("algo_t", "algo_e"):
            a = runs[(pname, "f64", algo)]
            b = runs[(pname, "compensated_f32", algo)]
            lane_rel = torch.stack([
                (getattr(b, f) - getattr(a, f)).abs() / getattr(a, f).abs()
                for f in fields]).amax(0)
            same = lane_rel <= 1e-5
            flipped = int((~same).sum())
            n_same = same.sum(-1)
            rels, raw, se_ratio = [], [], []
            for f in fields:
                x, y = getattr(a, f), getattr(b, f)
                ma = torch.where(same, x, 0.0).sum(-1) / n_same
                mb = torch.where(same, y, 0.0).sum(-1) / n_same
                rels.append(float(((mb - ma).abs() / ma.abs()).max()))
                d = (y.mean(-1) - x.mean(-1)).abs()
                raw.append(float((d / x.mean(-1).abs()).max()))
                se = x.std(-1) / math.sqrt(x.shape[-1])
                se_ratio.append(float((d / se).max()))
            lanes = a.n_failures.numel()
            log(f"compensated vs f64 {pname}/{algo}: {flipped} of {lanes} "
                f"lanes flipped (<= 1e-3 of lanes); max per-point mean rel "
                f"{max(rels):.3e} over the others (<= 1e-5); unfiltered "
                f"{max(raw):.3e} = {max(se_ratio):.3e} standard errors "
                f"(<= 0.1)")
            if (flipped > 1e-3 * lanes or max(rels) > 1e-5
                    or max(se_ratio) > 0.1):
                fail(f"compensated MC off f64 for {(pname, algo)}")
            report[f"compensated/{pname}/{algo}"] = {
                "lanes_flipped": flipped, "max_mean_rel": max(rels),
                "max_mean_rel_unfiltered": max(raw),
                "max_mean_diff_in_se": max(se_ratio)}

    for pname in procs:
        for algo, Tf, E in (("algo_t", model.Tf_time, model.E_time),
                            ("algo_e", model.Tf_energy, model.E_energy)):
            tb = runs[(pname, "f64", algo)]
            gt = float(((tb.wall_time.mean(-1) - Tf).abs() / Tf).max())
            ge = float(((tb.energy.mean(-1) - E).abs() / E).max())
            rt, re_ = _REF_GAPS[algo]
            log(f"MC-vs-model gap {pname}/{algo}: time {gt:.4f}, energy "
                f"{ge:.4f} (reference CPU, exponential, 512 trials: "
                f"{rt}, {re_}) — reported, not gated")
            report[f"model_gap/{pname}/{algo}"] = {"time": gt, "energy": ge}
    torch.cuda.synchronize()
    return report


# ---------------------------------------------------------------------------
# 6. times
# ---------------------------------------------------------------------------

def _events_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` warm runs of ``fn`` timed by CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _host_s(fn, reps: int = 5) -> float:
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_times(big, mc_grid, model, runs, peaks, dev) -> list:
    import torch
    from repro_torch.core import Exponential, Weibull
    from repro_torch.kernels.event_sweep import event_sweep, event_sweep_plain
    from repro_torch.sim import (COMPENSATED_F32, F64, evaluate_grid,
                                 fail_capacity_points, sampled_schedules,
                                 simulate_trajectories)
    bw, f64_peak, f32_peak = peaks
    for pol in (F64, COMPENSATED_F32):
        s = _host_s(lambda: evaluate_grid(big, precision=pol, device=dev))
        log(f"time evaluate_grid 1e6 [{pol.name}]: {s:.4f} s (median of 5)")
    procs = {"exponential": Exponential(), "weibull": Weibull(shape=0.7)}
    flat = mc_grid.ravel()
    variants = []
    for (pname, polname, algo), tb in runs.items():
        pol = F64 if polname == "f64" else COMPENSATED_F32
        T = (model.T_time if algo == "algo_t" else model.T_energy).reshape(-1)
        kw = dict(T_base=T_BASE, n_trials=N_TRIALS, seed=7,
                  process=procs[pname], device=dev)
        sample_ms = _events_ms(lambda: [b.gaps for b in sampled_schedules(
            T, flat, **kw)])
        e2e = _host_s(lambda: simulate_trajectories(
            T, flat, precision=pol, **kw))
        c = pol.cast
        Tb = torch.full_like(T, T_BASE)
        calls = []
        for blk in sampled_schedules(T, flat, **kw):
            p = blk.points
            calls.append(((c(T[p]), c(flat.C[p]), c(flat.R[p]), c(flat.D[p]),
                           c(flat.omega[p]), c(Tb[p]),
                           c(blk.gaps).contiguous()),
                          dict(n_steps=blk.n_steps,
                               compensated=pol.compensated)))
        run_k = lambda: [event_sweep(*a, **k) for a, k in calls]
        run_p = lambda: [event_sweep_plain(*a, **k) for a, k in calls]
        ker_ms = _events_ms(run_k)
        plain_ms = _events_ms(run_p)
        equal, err = True, 0.0
        for ko, po in zip(run_k(), run_p()):
            e, x = _compare(ko, po)
            equal, err = equal and e, max(err, x)
        if not equal:
            fail(f"kernel != plain version at main-path shapes "
                 f"{(pname, polname, algo)}")
        item = 4 if pol.compensated else 8
        lanes = tb.n_failures.numel()
        F_of = torch.as_tensor(fail_capacity_points(
            T, flat, T_BASE, process=procs[pname]), device=dev)
        reads = torch.minimum(
            tb.n_failures.reshape(flat.size, -1).to(torch.int64) + 1,
            F_of[:, None])
        n_gaps = int(reads.sum())
        nbytes = n_gaps * item + lanes * _OUT_BYTES + 6 * flat.size * item
        bytes_ms = nbytes / bw * 1e3
        ops_ms = n_gaps * _OPS_PER_GAP[pol.name] / (
            f32_peak if pol.compensated else f64_peak) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        v = {"process": pname, "policy": polname, "period": algo,
             "blocks": len(calls), "lanes": lanes, "gaps_read": n_gaps,
             "kernel_ms": ker_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms,
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "sampling_ms": sample_ms, "simulate_trajectories_s": e2e,
             "bitwise_vs_plain": equal, "max_abs_err": err}
        log(f"time {pname}/{polname}/{algo}: kernel {ker_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({v['bound_by']}), "
            f"sampling {sample_ms:.4f} ms, simulate_trajectories "
            f"{e2e:.4f} s, gaps read {n_gaps}")
        variants.append(v)
        del calls
        torch.cuda.empty_cache()
    return variants


def main() -> None:
    card, peaks = phase_device()
    import torch
    dev = torch.device("cuda:0")
    build_s = phase_build()
    parity_err = phase_parity(dev)

    from repro_torch.kernels.event_sweep import event_sweep, event_sweep_plain
    event_sweep.launches = 0
    event_sweep_plain.calls = 0
    big, sweeps, mc_grid, model, runs = run_main_path(dev)
    torch.cuda.synchronize()
    launches, plain_calls = event_sweep.launches, event_sweep_plain.calls
    log(f"main path: event_sweep launches {launches}, plain-version calls "
        f"{plain_calls}")
    if launches <= 0:
        fail("the main path never launched the event kernel")
    if plain_calls != 0:
        fail("the main path called the plain version")

    gate_sweep(big, sweeps)
    report = gate_mc(mc_grid, model, runs, dev)
    variants = phase_times(big, mc_grid, model, runs, peaks, dev)

    kernels = [{
        "name": "event_sweep", "route": "cuda",
        "source": "src/repro_torch/csrc/event_sweep.cu",
        "replaces": "src/repro/kernels/event_sweep.py:65",
        "launches": launches,
        "max_abs_err": max([parity_err] + [v["max_abs_err"]
                                           for v in variants]),
        "parity": "bitwise",
        "ms": sum(v["kernel_ms"] for v in variants),
        "plain_ms": sum(v["plain_ms"] for v in variants),
        "bound_ms": sum(v["bound_ms"] for v in variants),
        "bound_by": ("bytes" if all(v["bound_by"] == "bytes"
                                    for v in variants) else "operations"),
        "library_ms": None,
        "build_s": build_s,
        "variants": variants,
    }]
    print(json.dumps({"gates": report}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
