"""Per-point vs batched sweep and engine timings -> bench_sweep.json (+ a
regression check).

Counterpart of the reference's ``benchmarks/bench_sweep.py``, on the
port's paths and on one device (default ``cuda``; raises without a GPU
unless ``--device cpu`` is asked for).  Each entry keeps the reference's
key and its ``speedup_warm`` (a ratio of two timings of one run, so the
check is machine-normalized):

* ``fig2_seed_grid``, ``dense_grid`` -- the per-point loop
  (``core.tradeoff.sweep_mu_rho(engine="scalar")``) against one
  ``sim.sweep_mu_rho_grid`` call, both in f64, cross-checked to 1e-9;
* ``weibull_step_engine_reference`` -- the step scan's Weibull(0.7) vs
  exponential ratio on the canonical 12-point x 128-trial workload
  (``"ungated"``, as in the reference);
* ``weibull_event_engine`` -- the event path against the scalar oracle
  (``core.simulator.simulate``, a loop over points) on that workload;
* ``pallas_event_engine`` -- the event kernel (on the card, the sampled
  kernel drawing its gaps; on the CPU its plain version) against the step
  scan on that workload, their per-point means cross-checked, the gated
  ratio capped at 1.5 as the reference's;
* ``mc_solver_warm`` -- the MC surrogate's warm argmin, step vs event;
* ``sharded_dense_grid`` -- the device split (``sim.dispatch.pieces``)
  against one device on 512 points x 128 trials, bitwise; on a machine
  with one card the split has one piece (``n_devices`` says how many);
* ``chunked_dense_1m`` -- the 10^6-point sweep under the 2 GiB budget
  against one unchunked call, bitwise;
* ``cold_start_cached`` -- a fresh interpreter's first sweep and MC call
  with the kernel libraries already built in its build directory, against
  one that builds them first;
* ``async_overlap_collapse`` -- the deterministic overhead collapse as the
  deep flush overlaps (pure model arithmetic);
* ``advisor_rps``, ``advisor_load_regimes`` -- from ``bench_advisor``.

Left out: none of the reference's keys.  Its ``recompile_budget`` entry has
no place here: the port's budgets live in
``src/repro_torch/sanitize_budget.json`` (``repro_torch.sanitize``).

Output: ``build/repro_torch_results/bench_sweep.json`` and
``bench_sweep_table.md`` (with the card's name and power limit).  No
baseline is committed: ``--check BASELINE`` compares this run's gated
``speedup_warm`` entries against a file the caller names and fails on a
drop of more than ``REGRESSION_FACTOR`` (2.0).  ``--quick`` shrinks the
sizes for a smoke run and leaves out ``advisor_load_regimes`` (its four
open-loop regimes arrive at a fixed rate: ~12 s whatever the device) and
``cold_start_cached`` (two fresh interpreters and a build of every kernel
library).

    python -m repro_torch.benchmarks.bench_sweep --quick
    python -m repro_torch.benchmarks.bench_sweep --check old.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..launch.serve import generator
from . import _util
from ._util import emit

SEED_MUS = [30, 60, 90, 120, 180, 240, 300, 420, 600]
SRC = Path(__file__).resolve().parents[2]
#: >2x warm-speedup drop against the baseline fails ``--check``.
REGRESSION_FACTOR = 2.0
#: caps on gated ratios that depend on the machine (the reference's).
_PALLAS_GATE_CAP = 1.5
_SHARDED_GATE_CAP = 2.0


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a host array."""
    import torch
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _best_of(fn, repeat, device="cpu"):
    best = float("inf")
    for _ in range(repeat):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _time_pair(mus, rhos, scalar_repeat, batched_repeat, device):
    from ..core.tradeoff import sweep_mu_rho
    from ..sim import F64, sweep_mu_rho_grid

    scalar_s = _best_of(lambda: sweep_mu_rho(mus, rhos, engine="scalar",
                                             device=device),
                        scalar_repeat, device)
    batched = lambda: sweep_mu_rho_grid(mus, rhos, device=device,
                                        precision=F64)
    _sync(device)
    t0 = time.perf_counter()
    res = batched()
    _sync(device)
    cold_s = time.perf_counter() - t0
    batched_s = _best_of(batched, batched_repeat, device)
    ref = sweep_mu_rho(mus, rhos, engine="scalar", device=device)
    got = _host(res.energy_ratio)
    err = max(abs(float(got[i][j]) - ref[i][j].energy_ratio)
              for i in range(len(mus)) for j in range(len(rhos)))
    assert err < 1e-9, f"scalar/batched sweep disagree: {err}"
    return {"n_points": len(mus) * len(rhos), "scalar_s": scalar_s,
            "batched_cold_s": cold_s, "batched_warm_s": batched_s,
            "speedup_warm": scalar_s / batched_s}


def _weibull_workload(device, n_points=12, n_trials=128, shape=0.7):
    """The canonical non-exponential engine workload: a mixed-mu exascale
    grid."""
    import torch
    from ..core import EXASCALE_POWER_RHO55, fig12_checkpoint
    from ..core.failures import Weibull
    from ..sim import ParamGrid

    mus = torch.as_tensor(np.linspace(120.0, 600.0, n_points),
                          dtype=torch.float64, device=device)
    base = ParamGrid.from_params(fig12_checkpoint(300.0),
                                 EXASCALE_POWER_RHO55, device=device)
    grid = ParamGrid(**{f: (mus if f == "mu" else v.expand(n_points).clone())
                        for f, v in base.fields().items()})
    return grid, Weibull(shape=shape), 60.0, 1500.0, n_trials


def _time_weibull_step_engine_reference(device, n_points, n_trials,
                                        repeat=5):
    from ..sim.engine import simulate_trajectories

    grid, proc, T, T_base, n = _weibull_workload(device, n_points, n_trials)
    run = lambda p: simulate_trajectories(T, grid, T_base, n_trials=n,
                                          seed=0, process=p,
                                          engine_kind="step", device=device)
    t0 = time.perf_counter()
    run(proc)
    _sync(device)
    cold_s = time.perf_counter() - t0
    run(None)
    weibull_s = _best_of(lambda: run(proc), repeat, device)
    exp_s = _best_of(lambda: run(None), repeat, device)
    return {"n_points": n_points, "n_trials": n, "weibull_shape": 0.7,
            "ungated": True, "exp_warm_s": exp_s, "batched_cold_s": cold_s,
            "batched_warm_s": weibull_s, "speedup_warm": exp_s / weibull_s}


def _time_weibull_event_engine(device, n_points, n_trials, repeat=5):
    from ..core.simulator import simulate
    from ..sim.engine import simulate_trajectories

    grid, proc, T, T_base, n = _weibull_workload(device, n_points, n_trials)
    host = grid.to("cpu")

    def run_scalar():
        for i in range(host.size):
            simulate(T, host.ckpt_at(i), host.power_at(i), T_base,
                     generator(0), n_trials=n, process=proc)

    run_event = lambda: simulate_trajectories(T, grid, T_base, n_trials=n,
                                              seed=0, process=proc,
                                              device=device)
    t0 = time.perf_counter()
    run_event()
    _sync(device)
    cold_s = time.perf_counter() - t0
    event_s = _best_of(run_event, repeat, device)
    scalar_s = _best_of(run_scalar, 1)
    return {"n_points": host.size, "n_trials": n, "weibull_shape": 0.7,
            "scalar_s": scalar_s, "batched_cold_s": cold_s,
            "batched_warm_s": event_s, "speedup_warm": scalar_s / event_s}


def _time_event_kernel(device, n_points, n_trials, repeat=5):
    """The event kernel's path against the step scan (the reference's
    ``pallas_event_engine`` row)."""
    import torch
    from ..sim.engine import simulate_trajectories

    grid, proc, T, T_base, n = _weibull_workload(device, n_points, n_trials)
    run = lambda kind: simulate_trajectories(
        T, grid, T_base, n_trials=n, seed=0, process=proc, engine_kind=kind,
        device=device)
    r_step = run("step")
    _sync(device)
    t0 = time.perf_counter()
    r_event = run("event")
    _sync(device)
    cold_s = time.perf_counter() - t0
    for f in ("wall_time", "energy"):
        a = _host(getattr(r_step, f)).mean(-1)
        b = _host(getattr(r_event, f)).mean(-1)
        rel = float((np.abs(a - b) / np.abs(a)).max())
        assert rel <= 1e-9, f"event kernel path diverged from the step " \
                            f"scan on {f}: {rel}"
    step_s = _best_of(lambda: run("step"), repeat, device)
    event_s = _best_of(lambda: run("event"), repeat, device)
    ratio = step_s / event_s
    dev = torch.device(device)
    return {"n_points": grid.size, "n_trials": n, "weibull_shape": 0.7,
            "backend": dev.type,
            "device_kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "kernel": dev.type == "cuda",
            "step_warm_s": step_s,
            "batched_cold_s": cold_s, "batched_warm_s": event_s,
            "kernel_speedup": ratio,
            "speedup_warm": min(ratio, _PALLAS_GATE_CAP)}


def _time_mc_solver(device, n_trials=96, repeat=3):
    from ..core import EXASCALE_POWER_RHO55, fig12_checkpoint
    from ..core.failures import Weibull
    from ..core.optimal import MCSurrogate

    ck = fig12_checkpoint(300.0)
    solve = lambda kind: MCSurrogate(
        ck, EXASCALE_POWER_RHO55, Weibull(shape=0.7), T_base=1500.0,
        n_trials=n_trials, rng=generator(0), engine_kind=kind,
        device=device).argmin("time")
    t0 = time.perf_counter()
    t_event = solve("event")
    cold_s = time.perf_counter() - t0
    t_step = solve("step")
    assert abs(t_event - t_step) <= 5e-3 * t_step, (t_event, t_step)
    event_s = _best_of(lambda: solve("event"), repeat, device)
    step_s = _best_of(lambda: solve("step"), repeat, device)
    return {"n_trials": n_trials, "weibull_shape": 0.7,
            "step_warm_s": step_s, "batched_cold_s": cold_s,
            "batched_warm_s": event_s, "speedup_warm": step_s / event_s}


def _time_device_split(device, n_points, n_trials, repeat=3):
    """The grid axis split over the sweep mesh (``dispatch.pieces``)
    against one device, bitwise."""
    import torch
    from ..core import EXASCALE_POWER_RHO55, fig12_checkpoint
    from ..core.failures import Weibull
    from ..sim import DispatchConfig, ParamGrid, dispatch, \
        simulate_trajectories

    mus = torch.as_tensor(np.linspace(120.0, 600.0, n_points),
                          dtype=torch.float64, device=device)
    base = ParamGrid.from_params(fig12_checkpoint(300.0),
                                 EXASCALE_POWER_RHO55, device=device)
    grid = ParamGrid(**{f: (mus if f == "mu" else v.expand(n_points).clone())
                        for f, v in base.fields().items()})
    kw = dict(T_base=1500.0, n_trials=n_trials, seed=0,
              process=Weibull(shape=0.7), device=device)
    single, split = DispatchConfig(shard=False), DispatchConfig()
    r1 = simulate_trajectories(60.0, grid, dispatch=single, **kw)
    r2 = simulate_trajectories(60.0, grid, dispatch=split, **kw)
    eq = all(np.array_equal(_host(getattr(r1, f)), _host(getattr(r2, f)))
             for f in ("wall_time", "energy"))
    assert eq, "the split sweep diverged from one device"
    single_s = _best_of(lambda: simulate_trajectories(
        60.0, grid, dispatch=single, **kw), repeat, device)
    split_s = _best_of(lambda: simulate_trajectories(
        60.0, grid, dispatch=split, **kw), repeat, device)
    ratio = single_s / split_s
    return {"n_points": n_points, "n_trials": n_trials,
            "n_devices": dispatch.effective_devices(split,
                                                    torch.device(device)),
            "bit_equal": eq, "single_warm_s": single_s,
            "batched_warm_s": split_s, "sharded_speedup": ratio,
            "speedup_warm": min(ratio, _SHARDED_GATE_CAP)}


def _time_chunked(device, side, repeat=2):
    """A side x side sweep chunked under the default 2 GiB budget (``side``
    1000: 10^6 points) against one unchunked call, bitwise; below 10^6
    points the chunk is forced to a quarter of the grid."""
    from ..sim import DispatchConfig, evaluate_grid, mu_rho_grid

    grid = mu_rho_grid(list(np.linspace(30.0, 600.0, side)),
                       list(np.linspace(1.0, 10.0, side)), device=device)
    n = side * side
    unchunked = DispatchConfig(shard=False, memory_mb=1 << 20)
    chunked = DispatchConfig(shard=False, chunk=None if side >= 1000
                             else -(-n // 4))
    t0 = time.perf_counter()
    ref = evaluate_grid(grid, dispatch=chunked, device=device)
    _sync(device)
    cold_s = time.perf_counter() - t0
    out = evaluate_grid(grid, dispatch=unchunked, device=device)
    for f in ("T_time", "T_energy", "time_ratio", "energy_ratio"):
        a, b = _host(getattr(ref, f)), _host(getattr(out, f))
        assert np.array_equal(a, b, equal_nan=True), \
            f"chunked sweep diverged from unchunked on {f}"
    chunked_s = _best_of(lambda: evaluate_grid(grid, dispatch=chunked,
                                               device=device), repeat, device)
    unchunked_s = _best_of(lambda: evaluate_grid(grid, dispatch=unchunked,
                                                 device=device),
                           repeat, device)
    return {"n_points": n, "memory_budget_bytes": DispatchConfig().budget(),
            "unchunked_warm_s": unchunked_s, "batched_cold_s": cold_s,
            "batched_warm_s": chunked_s,
            "speedup_warm": unchunked_s / chunked_s}


_COLD_START_SCRIPT = r"""
import sys, time
sys.path.insert(0, %(src)r)
import numpy as np
import torch
from repro_torch.sim import enable_compile_cache
enable_compile_cache(%(cache)r)
from repro_torch.core import EXASCALE_POWER_RHO55, fig12_checkpoint
from repro_torch.core.failures import Weibull
from repro_torch.sim import ParamGrid, evaluate_grid, mu_rho_grid, \
    simulate_trajectories
dev = %(device)r
t0 = time.perf_counter()
evaluate_grid(mu_rho_grid([30, 60, 90, 120, 180, 240, 300, 420, 600],
                          list(np.linspace(1.0, 10.0, 10)), device=dev),
              device=dev)
mus = torch.as_tensor(np.linspace(120.0, 600.0, 12), dtype=torch.float64,
                      device=dev)
base = ParamGrid.from_params(fig12_checkpoint(300.0), EXASCALE_POWER_RHO55,
                             device=dev)
grid = ParamGrid(**{f: (mus if f == "mu" else v.expand(12).clone())
                    for f, v in base.fields().items()})
simulate_trajectories(60.0, grid, 1500.0, n_trials=128, seed=0,
                      process=Weibull(shape=0.7), device=dev)
if dev.startswith("cuda"):
    torch.cuda.synchronize()
print("COLD_S", time.perf_counter() - t0)
"""


def _time_cold_start(device):
    """Fresh interpreters' first sweep and MC call (measured inside them):
    with the kernel libraries already built in the build directory, and in
    an empty one, where they are built first."""
    from ..kernels import _build

    def one(cache_dir):
        script = _COLD_START_SCRIPT % {"src": str(SRC), "cache": cache_dir,
                                       "device": str(device)}
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f"cold-start subprocess failed:\n"
                               f"{out.stderr[-3000:]}")
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("COLD_S")][-1]
        return float(line.split()[1])

    if str(device).startswith("cuda"):   # the libraries built first, here
        for src in sorted(p.name for p in _build.CSRC.glob("*.cu")):
            _build.build(src)
    cached_s = one(str(_build.BUILD_DIR))
    with tempfile.TemporaryDirectory(prefix="repro-torch-build-") as d:
        uncached_s = one(d)
    return {"cold_uncached_s": uncached_s, "batched_cold_s": cached_s,
            "batched_warm_s": cached_s, "speedup_warm": uncached_s / cached_s}


def _time_async_overlap_collapse(device, repeat=5):
    """The time overhead above failure-free execution collapses as the
    deep flush overlaps (omega2 -> 1); the gated ratio is that collapse,
    pure model arithmetic."""
    from ..core import model, optimal
    from ..core.params import (MultilevelCheckpointParams,
                               MultilevelPowerParams)

    pw = MultilevelPowerParams(P_static=10.0, P_cal=10.0, P_io1=20.0,
                               P_io2=100.0)
    grid = [0.0, 0.5, 0.9, 1.0]

    def solve():
        rows = []
        for w2 in grid:
            ck = MultilevelCheckpointParams(C1=1.0, R1=1.0, C2=10.0, R2=10.0,
                                            D1=0.5, D2=1.0, mu=300.0, q=0.1,
                                            omega=0.0, omega2=w2)
            T_t, m_t = optimal.t_opt_time_multilevel(ck, device=device)
            T_e, m_e = optimal.t_opt_energy_multilevel(ck, pw, device=device)
            overhead = float(model.ml_time_final(T_t, m_t, ck,
                                                 device=device)) - 1.0
            e_pen = (float(model.ml_energy_final(T_t, m_t, ck, pw,
                                                 device=device))
                     / float(model.ml_energy_final(T_e, m_e, ck, pw,
                                                   device=device)) - 1.0)
            rows.append((T_t, m_t, T_e, m_e, overhead, e_pen))
        return rows

    warm_s = _best_of(solve, repeat, device)
    rows = solve()
    overheads = [r[4] for r in rows]
    if not all(b < a for a, b in zip(overheads, overheads[1:])):
        raise AssertionError(f"time overhead must fall as omega2 -> 1, got "
                             f"{overheads}")
    return {"omega2_grid": grid,
            "T_opt_time": [round(r[0], 6) for r in rows],
            "m_opt_time": [r[1] for r in rows],
            "T_opt_energy": [round(r[2], 6) for r in rows],
            "m_opt_energy": [r[3] for r in rows],
            "time_overhead": [round(r[4], 9) for r in rows],
            "energy_penalty_at_time_opt": [round(r[5], 9) for r in rows],
            "batched_warm_s": warm_s,
            "speedup_warm": overheads[0] / overheads[-1]}


#: sizes: (seed rhos, dense (mus, rhos), engine (points, trials), split
#: (points, trials), chunked side, advisor burst, advisor repeat).
SIZES = {"full": (10, (96, 100), (12, 128), (512, 128), 1000, 512, 3),
         "quick": (4, (12, 10), (4, 32), (16, 32), 100, 32, 1)}


def run(device="cuda", quick: bool = False) -> dict:
    from .._device import resolve_device
    from .bench_advisor import time_advisor_regimes, time_advisor_rps
    dev = resolve_device(device)
    n_rho, dense, eng, split, side, burst, rep = \
        SIZES["quick" if quick else "full"]
    seed = _time_pair(SEED_MUS, list(np.linspace(1.0, 10.0, n_rho)),
                      scalar_repeat=1 if quick else 5,
                      batched_repeat=3 if quick else 10, device=dev)
    dense_grid = _time_pair(list(np.linspace(30.0, 600.0, dense[0])),
                            list(np.linspace(1.0, 10.0, dense[1])),
                            scalar_repeat=1, batched_repeat=3, device=dev)
    r = 1 if quick else 5
    entries = {
        "weibull_step_engine_reference":
            lambda: _time_weibull_step_engine_reference(dev, *eng, repeat=r),
        "weibull_event_engine":
            lambda: _time_weibull_event_engine(dev, *eng, repeat=r),
        "pallas_event_engine": lambda: _time_event_kernel(dev, *eng,
                                                          repeat=r),
        "mc_solver_warm": lambda: _time_mc_solver(
            dev, n_trials=eng[1] if quick else 96,
            repeat=1 if quick else 3),
        "sharded_dense_grid": lambda: _time_device_split(
            dev, *split, repeat=1 if quick else 3),
        "chunked_dense_1m": lambda: _time_chunked(dev, side,
                                                  repeat=1 if quick else 2),
        "async_overlap_collapse":
            lambda: _time_async_overlap_collapse(dev, repeat=r),
        "advisor_rps": lambda: time_advisor_rps(
            generator(42), repeat=rep, device=dev, n=burst),
    }
    if not quick:
        entries["cold_start_cached"] = lambda: _time_cold_start(dev)
        entries["advisor_load_regimes"] = lambda: time_advisor_regimes(
            generator(11), generator(12), device=dev)
    payload = {"benchmark": "fig2_mu_rho_sweep", "unit": "seconds",
               "device": str(dev), "quick": quick, "fig2_seed_grid": seed,
               "dense_grid": dense_grid}
    entry_s = {}
    for key, entry in entries.items():
        t0 = time.perf_counter()
        payload[key] = entry()
        entry_s[key] = time.perf_counter() - t0
    payload["entry_s"] = entry_s
    return payload


def write_timing_table(payload: dict, card: str, path=None) -> str:
    """The payload as a warm/cold timing table with the card's name and
    power limit."""
    path = path or _util.out_path("bench_sweep_table.md")
    lines = ["# bench_sweep timings", "", f"Card: {card}; device "
             f"{payload.get('device')}; quick: {payload.get('quick')}.", "",
             "| grid | cold (s) | warm (s) | reference (s) | speedup_warm |",
             "|---|---|---|---|---|"]
    for grid, entry in payload.items():
        if not (isinstance(entry, dict) and "speedup_warm" in entry):
            continue
        ref = next((entry[k] for k in ("scalar_s", "exp_warm_s",
                                       "step_warm_s", "single_warm_s",
                                       "unchunked_warm_s",
                                       "cold_uncached_s", "naive_s")
                    if k in entry), float("nan"))
        cold = entry.get("batched_cold_s")
        tag = " (ungated ref)" if entry.get("ungated") else ""
        lines.append(
            f"| {grid}{tag} | {'—' if cold is None else format(cold, '.4g')} "
            f"| {entry['batched_warm_s']:.4g} | {ref:.4g} "
            f"| {entry['speedup_warm']:.2f}x |")
    text = "\n".join(lines) + "\n"
    Path(path).write_text(text)
    return str(path)


def check_regression(baseline: dict, payload: dict,
                     factor: float = REGRESSION_FACTOR) -> list:
    """Gated ``speedup_warm`` entries of ``payload`` more than ``factor``
    below ``baseline``'s, and gated entries present in one and not the
    other (the reference's rule, in both directions)."""
    def gated(entry) -> bool:
        return (isinstance(entry, dict) and "speedup_warm" in entry
                and not entry.get("ungated"))

    regressions = []
    for grid in sorted(baseline):
        if not gated(baseline[grid]):
            continue
        if not gated(payload.get(grid)):
            regressions.append(f"{grid}: in the baseline but missing from "
                               f"this run's payload")
            continue
        base = baseline[grid]["speedup_warm"]
        now = payload[grid]["speedup_warm"]
        if now * factor < base:
            regressions.append(
                f"{grid}: speedup_warm {now:.2f}x is {base / now:.1f}x "
                f"below the baseline {base:.2f}x (limit {factor:g}x)")
    for grid in sorted(payload):
        if gated(payload[grid]) and not gated(baseline.get(grid)):
            regressions.append(f"{grid}: gated entry missing from the "
                               f"baseline")
    return regressions


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", type=Path, default=None, metavar="BASELINE",
                    help="compare the gated speedups against BASELINE (a "
                         "bench_sweep.json); exit non-zero on a >2x drop")
    ap.add_argument("--quick", action="store_true",
                    help="small sizes, for a smoke run")
    ap.add_argument("--device", default="cuda",
                    help="default cuda; raises without a GPU unless 'cpu' "
                         "is asked for")
    args = ap.parse_args(argv)
    from .roofline import card_line

    t0 = time.perf_counter()
    payload = run(args.device, quick=args.quick)
    card = card_line(args.device)
    payload["card"] = card
    out = _util.out_path("bench_sweep.json")
    out.write_text(json.dumps(payload, indent=2) + "\n")
    table = write_timing_table(payload, card)
    s, d, ev = (payload["fig2_seed_grid"], payload["dense_grid"],
                payload["weibull_event_engine"])
    emit("bench_sweep", (time.perf_counter() - t0) * 1e6,
         f"fig2 {s['n_points']}pts speedup={s['speedup_warm']:.1f}x; "
         f"dense {d['n_points']}pts speedup={d['speedup_warm']:.1f}x; "
         f"event vs scalar={ev['speedup_warm']:.1f}x; event kernel vs step="
         f"{payload['pallas_event_engine']['kernel_speedup']:.2f}x; "
         f"mc solver step/event="
         f"{payload['mc_solver_warm']['speedup_warm']:.1f}x; "
         f"advisor {payload['advisor_rps']['rps']:.0f} rps ({card}) "
         f"-> {out} + {table}")
    if args.check is not None:
        regressions = check_regression(json.loads(args.check.read_text()),
                                       payload)
        if regressions:
            raise SystemExit("benchmark regression check FAILED:\n  "
                             + "\n  ".join(regressions))
        print(f"bench_sweep --check OK: warm speedups within "
              f"{REGRESSION_FACTOR:g}x of {args.check}")
    return payload


if __name__ == "__main__":
    main()
