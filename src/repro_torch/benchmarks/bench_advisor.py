"""Advisor serving benchmarks: micro-batched burst + open-loop regimes.

The counterpart of the reference's ``benchmarks/bench_advisor.py`` with
its sizes and definitions, on ``device``:

``advisor_rps``
    A 512-request synthetic burst of DISTINCT single-level platforms,
    answered by one warm ``advise_many`` call — asserted to issue exactly
    ONE dispatched solve and to be bit-identical to the naive
    one-solve-per-request loop it replaces.  ``speedup_warm`` is
    naive/batched measured in the same run (the reference's floor is
    20x).  Requests/sec and the open-loop p50/p99 ride along.

``advisor_load_regimes``
    Open-loop load-generator runs across batch-window x workload-repeat
    regimes: requests/sec, p50/p99 latency, fingerprint-cache hit rate
    and mean window per regime.

The requests come from the caller's numpy generators:
``np.random.default_rng(42)`` draws the reference's burst, ``(11)`` and
``(12)`` its regimes' requests and warm-up.  The results are written as
JSON to ``build/repro_torch_results/bench_advisor.json``.

    python -m repro_torch.benchmarks.bench_advisor [--device cuda]
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np

from . import _util

#: burst size of the gated entry (the reference's 512).
BURST = 512
#: (batch_window_s, repeat_frac) grid of the open-loop entry.
REGIMES = ((0.0, 0.0), (0.0, 0.8), (2e-3, 0.0), (2e-3, 0.8))
_REGIME_N = 256
_REGIME_RATE_HZ = 4000.0


def _best_of(fn, repeat):
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _same(a, b) -> bool:
    """The reference's check: period, cadence and predicted energy bitwise
    (NaN == NaN)."""
    return (a.period == b.period and a.deep_every == b.deep_every
            and (a.predicted_energy == b.predicted_energy
                 or (np.isnan(a.predicted_energy)
                     and np.isnan(b.predicted_energy))))


def time_advisor_rps(rng: np.random.Generator, repeat: int = 3,
                     device="cuda", n: int = BURST) -> dict:
    """The burst entry (see module docstring): ``n`` distinct single-level
    requests drawn from ``rng`` (advanced in place)."""
    from ..serve import (AdvisorService, ThreadedAdvisor, run_open_loop,
                         synthetic_requests)

    reqs = synthetic_requests(n, rng, two_tier_frac=0.0, repeat_frac=0.0)
    service = lambda: AdvisorService(cache_name=None, device=device)

    # -- batched: one advise_many call, one dispatched solve ---------------
    svc = service()
    t0 = time.perf_counter()
    batched = svc.advise_many(reqs)
    cold_s = time.perf_counter() - t0
    m = svc.metrics()
    assert m["dispatched_solves"] == 1, \
        f"burst took {m['dispatched_solves']} dispatched solves, wanted 1"
    batched_s = _best_of(lambda: service().advise_many(reqs), repeat)

    # -- naive: one solve per request --------------------------------------
    naive_svc = service()
    naive = [naive_svc.advise(r) for r in reqs]      # also warms the path
    n_naive = naive_svc.metrics()["dispatched_solves"]
    assert n_naive == n, f"naive loop solved {n_naive}x, wanted {n}"
    assert all(_same(a, b) for a, b in zip(batched, naive)), \
        "batched advisor diverged from the naive per-request loop"

    def naive_once():
        s = service()
        for r in reqs:
            s.advise(r)

    naive_s = _best_of(naive_once, max(1, repeat - 1))

    # -- open-loop latency of the same burst shape -------------------------
    with ThreadedAdvisor(service(), batch_window_s=2e-3,
                         max_batch=n) as advisor:
        rep = run_open_loop(advisor, reqs, rate_hz=_REGIME_RATE_HZ,
                            warmup=reqs[:32])

    return {"n_requests": n,
            "naive_s": naive_s,
            "batched_cold_s": cold_s,
            "batched_warm_s": batched_s,
            "rps": n / batched_s,
            "open_loop_rps": rep.rps,
            "p50_ms": rep.p50_ms,
            "p99_ms": rep.p99_ms,
            "speedup_warm": naive_s / batched_s}


def time_advisor_regimes(rng: np.random.Generator,
                         rng_warm: np.random.Generator,
                         device="cuda") -> dict:
    """The batch-window x cache-hit-rate open-loop sweep; every regime
    draws its requests from a copy of ``rng`` and its warm-up from a copy
    of ``rng_warm`` (the reference reseeds both per regime)."""
    from ..serve import (AdvisorService, ThreadedAdvisor, run_open_loop,
                         synthetic_requests)

    out = {"n_requests": _REGIME_N, "rate_hz": _REGIME_RATE_HZ,
           "ungated": True}
    for window_s, repeat_frac in REGIMES:
        reqs = synthetic_requests(_REGIME_N, copy.deepcopy(rng),
                                  two_tier_frac=0.5,
                                  repeat_frac=repeat_frac)
        warm = synthetic_requests(32, copy.deepcopy(rng_warm),
                                  two_tier_frac=0.5)
        with ThreadedAdvisor(AdvisorService(cache_name=None, device=device),
                             batch_window_s=window_s) as advisor:
            rep = run_open_loop(advisor, reqs, rate_hz=_REGIME_RATE_HZ,
                                warmup=warm)
        key = f"window_{window_s * 1e3:g}ms_repeat_{repeat_frac:g}"
        out[key] = {"rps": rep.rps, "p50_ms": rep.p50_ms,
                    "p99_ms": rep.p99_ms, "hit_rate": rep.hit_rate,
                    "mean_window": rep.mean_window}
    return out


def main(rng_burst: np.random.Generator, rng_regimes: np.random.Generator,
         rng_warm: np.random.Generator, device="cuda") -> dict:
    """Both entries; prints one row and writes ``bench_advisor.json``."""
    burst = time_advisor_rps(rng_burst, device=device)
    regimes = time_advisor_regimes(rng_regimes, rng_warm, device=device)
    hot = regimes["window_2ms_repeat_0.8"]
    _util.emit("bench_advisor", burst["batched_warm_s"] / BURST * 1e6,
               f"{BURST}-req burst {burst['rps']:.0f} rps "
               f"(speedup vs naive {burst['speedup_warm']:.0f}x); "
               f"open loop p50={burst['p50_ms']:.1f}ms "
               f"p99={burst['p99_ms']:.1f}ms; "
               f"2ms-window repeated workload {hot['rps']:.0f} rps "
               f"@ hit rate {hot['hit_rate']:.0%}")
    out = {"device": str(device), "advisor_rps": burst,
           "advisor_load_regimes": regimes}
    _util.out_path("bench_advisor.json").write_text(
        json.dumps(out, indent=1) + "\n")
    return out


def cli(argv=None) -> dict:
    from ..launch.serve import generator
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    return main(generator(42), generator(11), generator(12), a.device)


if __name__ == "__main__":
    cli()
