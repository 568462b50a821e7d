"""Synthetic open-loop load generator for the advisor service.

Open loop means arrivals follow a fixed schedule (``rate_hz``) that does
NOT slow down when the server lags — the honest way to measure a serving
path, since closed-loop generators hide queueing collapse by waiting for
the previous answer before issuing the next request.  Latency of request
``i`` is measured from its SCHEDULED arrival time to its future's
completion, so schedule slip shows up as latency, not as a lower rate.

``synthetic_requests`` draws platforms log-uniformly around the paper's
ranges (MTBFs from minutes to days, checkpoint costs seconds to tens of
minutes, the rho sweep of power envelopes), with knobs for the two-tier
fraction and for a repeated-workload fraction that exercises the
fingerprint cache's hit path.  It draws from the caller's numpy
generator: ``np.random.default_rng(s)`` draws the requests the
reference's ``synthetic_requests(n, seed=s)`` draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from .schema import AdviceRequest, StoreTier
from .service import ThreadedAdvisor


def synthetic_requests(n: int, rng: np.random.Generator,
                       two_tier_frac: float = 0.5,
                       repeat_frac: float = 0.0,
                       objectives: Sequence[str] = ("time", "energy"),
                       ) -> List[AdviceRequest]:
    """Draw ``n`` requests from ``rng`` (advanced in place).

    ``repeat_frac`` of the requests (after the first) duplicate an
    earlier draw's platform — the cache-hit knob of the load benchmark.
    Duplicates may still differ in ``objective`` and ``T_base``, which
    the fingerprint ignores (that's the point).
    """
    reqs: List[AdviceRequest] = []
    for i in range(n):
        if reqs and rng.random() < repeat_frac:
            src = reqs[int(rng.integers(len(reqs)))]
            reqs.append(dataclasses.replace(
                src, objective=str(rng.choice(objectives)),
                T_base=float(rng.uniform(0.5, 50.0))))
            continue
        mu = float(np.exp(rng.uniform(np.log(600.0), np.log(172800.0))))
        # deep-tier checkpoint cost: seconds to tens of minutes, kept
        # clear of the degenerate C ~ mu regime so most draws are valid.
        C2 = float(np.exp(rng.uniform(np.log(5.0),
                                      np.log(min(1800.0, mu / 12.0)))))
        omega = float(rng.uniform(0.0, 1.0))
        rho = float(rng.uniform(0.2, 1.0))
        P_static, P_cal = 10.0, 10.0
        P_io2 = P_cal / rho
        deep = StoreTier(name="pfs", C=C2, R=C2 * float(rng.uniform(0.8, 1.5)),
                         D=C2 * float(rng.uniform(0.0, 0.5)), P_io=P_io2)
        two = rng.random() < two_tier_frac
        if two:
            ratio = float(rng.uniform(0.02, 0.5))   # buddy write / PFS write
            C1 = C2 * ratio
            fast = StoreTier(name="buddy", C=C1,
                             R=C1 * float(rng.uniform(0.8, 1.5)),
                             D=C1 * float(rng.uniform(0.0, 0.5)),
                             P_io=P_io2 * float(rng.uniform(0.3, 1.0)),
                             q=float(rng.uniform(0.0, 0.2)))
            tiers = (fast, deep)
        else:
            tiers = (deep,)
        reqs.append(AdviceRequest(
            mu=mu, tiers=tiers, omega=omega, P_static=P_static,
            P_cal=P_cal, P_down=float(rng.choice([0.0, P_static])),
            objective=str(rng.choice(objectives)),
            T_base=float(rng.uniform(0.5, 50.0))))
    return reqs


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """One open-loop run's measurements (latencies in milliseconds)."""

    n: int
    duration_s: float
    rps: float
    p50_ms: float
    p99_ms: float
    mean_ms: float
    max_ms: float
    hit_rate: float
    windows: int
    mean_window: float

    def summary(self) -> dict:
        return dataclasses.asdict(self)


def run_open_loop(advisor: ThreadedAdvisor,
                  requests: Sequence[AdviceRequest],
                  rate_hz: float,
                  warmup: Optional[Sequence[AdviceRequest]] = None,
                  ) -> LoadReport:
    """Drive ``advisor`` with a fixed-rate schedule; measure rps + tails.

    ``warmup`` requests (if any) are served first, outside the measured
    window — use them to pay one-time set-up costs, or to pre-populate
    the cache for hit-regime measurements.
    """
    if rate_hz <= 0.0:
        raise ValueError("rate_hz must be > 0")
    if warmup:
        advisor.service.advise_many(list(warmup))
    m0 = advisor.metrics()
    done = [0.0] * len(requests)
    futs = []
    start = time.monotonic()
    sched = [start + i / rate_hz for i in range(len(requests))]

    def _mark(i):
        def cb(_fut):
            done[i] = time.monotonic()
        return cb

    for i, req in enumerate(requests):
        delay = sched[i] - time.monotonic()
        if delay > 0.0:
            time.sleep(delay)
        fut = advisor.submit(req)
        fut.add_done_callback(_mark(i))
        futs.append(fut)
    for fut in futs:
        fut.result()                    # re-raises worker errors
    end = time.monotonic()
    m1 = advisor.metrics()

    lat_ms = 1e3 * (np.array(done) - np.array(sched))
    lookups = (m1["fingerprint_cache"]["lookups"]
               - m0["fingerprint_cache"]["lookups"])
    hits = (m1["fingerprint_cache"]["hits"]
            - m0["fingerprint_cache"]["hits"])
    windows = m1["windows"] - m0["windows"]
    duration = end - start
    return LoadReport(
        n=len(requests), duration_s=duration,
        rps=len(requests) / duration if duration > 0 else float("inf"),
        p50_ms=float(np.percentile(lat_ms, 50)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        mean_ms=float(lat_ms.mean()), max_ms=float(lat_ms.max()),
        hit_rate=hits / lookups if lookups else 0.0,
        windows=windows,
        mean_window=len(requests) / windows if windows else 0.0)
