"""Serving entry points.

Advisor path: drive the checkpoint-advisor service (``repro_torch.serve``)
with a synthetic open-loop workload and print throughput/latency/cache
statistics.  ``--smoke`` runs the short self-checking workload.

    python -m repro_torch.launch.serve advisor --requests 512 \\
        --rate 2000 --repeat-frac 0.5 --batch-window-ms 2
    python -m repro_torch.launch.serve advisor --smoke [--device cpu]

The model path of the reference's launcher (prefill, then greedy decode)
needs the port's model zoo, which does not exist yet: without
``advisor`` this launcher exits with an error naming what is missing.
"""
from __future__ import annotations

import argparse

import numpy as np


def generator(seed: int) -> np.random.Generator:
    """The numpy generator a ``--seed`` flag stands for; the library takes
    generators from its callers, and this CLI is one."""
    return np.random.default_rng(seed)  # reprolint: disable=RPL001 (the CLI entry point turns its --seed flag into the generator the library takes; the reference seeds at its approved loadgen site, the port's library never does)


def build_advisor_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve advisor",
        description="Open-loop load run against the checkpoint advisor.")
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--two-tier-frac", type=float, default=0.5)
    ap.add_argument("--repeat-frac", type=float, default=0.0)
    ap.add_argument("--warmup", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="short self-checking run")
    ap.add_argument("--device", default="cuda",
                    help="where the service solves (cuda or cpu)")
    return ap


def advisor_main(argv=None):
    from ..serve import (AdvisorService, ThreadedAdvisor, run_open_loop,
                         synthetic_requests)

    args = build_advisor_parser().parse_args(argv)
    if args.smoke:
        return _advisor_smoke(args.device)

    reqs = synthetic_requests(args.requests, generator(args.seed),
                              two_tier_frac=args.two_tier_frac,
                              repeat_frac=args.repeat_frac)
    warm = synthetic_requests(args.warmup, generator(args.seed + 1),
                              two_tier_frac=args.two_tier_frac)
    with ThreadedAdvisor(AdvisorService(device=args.device),
                         batch_window_s=args.batch_window_ms * 1e-3,
                         max_batch=args.max_batch) as advisor:
        rep = run_open_loop(advisor, reqs, rate_hz=args.rate, warmup=warm)
        metrics = advisor.metrics()
    print(f"served {rep.n} requests in {rep.duration_s:.3f}s "
          f"-> {rep.rps:.0f} rps")
    print(f"latency p50={rep.p50_ms:.2f}ms p99={rep.p99_ms:.2f}ms "
          f"max={rep.max_ms:.2f}ms")
    print(f"cache hit rate {rep.hit_rate:.1%}; "
          f"{rep.windows} windows, mean size {rep.mean_window:.1f}")
    print(f"dispatched solves: {metrics['dispatched_solves']} "
          f"({metrics['solved_lanes']} lanes), "
          f"exact fallbacks: {metrics['fallback_requests']}")
    return rep


def _advisor_smoke(device="cuda"):
    """Self-check: throughput > 0, hits on repeats, batched == unbatched."""
    from ..serve import (AdvisorService, ThreadedAdvisor, run_open_loop,
                         synthetic_requests)

    reqs = synthetic_requests(48, generator(7), two_tier_frac=0.5,
                              repeat_frac=0.5)

    # batched answers == unbatched single-request answers, bit for bit
    batched = AdvisorService(cache_name=None,
                             device=device).advise_many(reqs)
    solo_svc = AdvisorService(cache_name=None, device=device)
    for req, a in zip(reqs, batched):
        b = solo_svc.advise(req)
        same = (a.period == b.period and a.deep_every == b.deep_every
                and (a.predicted_energy == b.predicted_energy
                     or (a.predicted_energy != a.predicted_energy
                         and b.predicted_energy != b.predicted_energy)))
        if not same:
            raise SystemExit(f"FAIL: batched != unbatched for {req}")
    print("PASS batched == unbatched (48 requests, bit-identical)")

    with ThreadedAdvisor(AdvisorService(cache_name=None, device=device),
                         batch_window_s=2e-3) as advisor:
        rep = run_open_loop(advisor, reqs, rate_hz=2000.0,
                            warmup=synthetic_requests(8, generator(8)))
    if not rep.rps > 0.0:
        raise SystemExit("FAIL: zero throughput")
    print(f"PASS open loop: {rep.rps:.0f} rps, p50={rep.p50_ms:.2f}ms, "
          f"p99={rep.p99_ms:.2f}ms")
    if not rep.hit_rate > 0.0:
        raise SystemExit("FAIL: no cache hits on repeated workload")
    print(f"PASS cache hit rate {rep.hit_rate:.1%} on repeated workload")
    return rep


def main(argv=None):
    import sys
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "advisor":
        return advisor_main(argv[1:])
    raise SystemExit(
        "repro_torch.launch.serve: the model-serving path (prefill and "
        "decode of a model) needs repro_torch.models, which is not ported "
        "yet; only the 'advisor' subcommand runs")


if __name__ == "__main__":
    main()
