"""Fault-tolerant training launcher (the paper's technique end-to-end).

Counterpart of the reference's ``repro/launch/train.py``: a thin CLI over
:class:`repro_torch.ft.run.RunSpec` with the reference's flags, defaults
and choices, plus ``--device`` (default ``cuda``; ``cpu`` runs on the
host).  It builds an architecture (full or reduced), wires the FT trainer
with the checkpoint-period policy (single-level AlgoT/AlgoE/... or the
joint multilevel ``algo_t_ml`` / ``algo_e_ml`` which also chooses the
buddy/PFS cadence m), injects failures from any renewal process
(exponential / weibull / lognormal), runs in scaled virtual time, and
prints the measured report next to the model's predictions
(``ml_time_final`` / ``ml_energy_final`` at the executed operating point).

    python -m repro_torch.launch.train --arch xlstm-125m --reduce \\
        --steps 300 --strategy algo_e --mtbf 120
    python -m repro_torch.launch.train --arch xlstm-125m --no-reduce \\
        --batch 8 --seq 256 --steps 12 --strategy algo_e_ml --mtbf 20 \\
        --q 1 --compress --profile paper_ml --sim-step-seconds 0
    python -m repro_torch.launch.train --smoke [--device cpu]

Only the recurrent archs train in the port so far: an attention, MoE or
RG-LRU arch raises ``NotImplementedError`` (ROADMAP A9c) at its first step.
"""
from __future__ import annotations

import argparse
import json

from ..core.failures import PROCESSES
from ..core.optimal import STRATEGIES

#: the ``--smoke`` run: the reference's spec (120 steps of ``algo_t_ml``
#: at mu 15 s, C 1.5/0.3, R 1.5/0.3, D 0.2/0.1, q 0.15, ``paper_ml``,
#: seed 3) on reduced xLSTM-125M in place of the reference's reduced
#: starcoder2-3b, whose attention forward the port does not have yet
#: (ROADMAP A9c).  In scaled time every duration is virtual, so the
#: failure schedule is the only randomness and the report (wall, energy,
#: failures, checkpoints, the operating point) does not depend on the
#: model: the reference's smoke gives the same report on either arch;
#: only the losses differ.  One mLSTM head of 2 * 64 = 128 wide (the
#: card's kernel takes 128, 256 or 384).
SMOKE_SPEC = dict(arch="xlstm-125m", layers=2, d_model=64, n_heads=1,
                  batch=2, seq=16, total_steps=120, step_s=1.0,
                  strategy="algo_t_ml", mu_s=15.0, C_s=1.5, R_s=1.5,
                  D_s=0.2, C1_s=0.3, R1_s=0.3, D1_s=0.1, q=0.15,
                  profile="paper_ml", seed=3)


def build_parser() -> argparse.ArgumentParser:
    """CLI (kept separate so tests can parse without building state)."""
    from ..ft.run import PROFILES, RunSpec
    d = RunSpec()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=d.arch)
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=d.layers)
    ap.add_argument("--d-model", type=int, default=d.d_model)
    ap.add_argument("--steps", type=int, default=d.total_steps)
    ap.add_argument("--batch", type=int, default=d.batch)
    ap.add_argument("--seq", type=int, default=d.seq)
    ap.add_argument("--lr", type=float, default=d.lr)
    ap.add_argument("--strategy", default="algo_t",
                    choices=list(STRATEGIES) + ["algo_t_ml", "algo_e_ml",
                                                "fixed"])
    ap.add_argument("--mtbf", type=float, default=float("inf"),
                    help="platform MTBF in (sim) seconds; inf = no failures")
    ap.add_argument("--process", default="exponential",
                    choices=sorted(PROCESSES),
                    help="inter-failure renewal process")
    ap.add_argument("--process-param", type=float, default=None,
                    help="shape (weibull) / sigma (lognormal)")
    ap.add_argument("--ckpt-cost", type=float, default=d.C_s,
                    help="deep (PFS) checkpoint cost C2 in sim seconds")
    ap.add_argument("--recovery", type=float, default=d.R_s,
                    help="deep recovery cost R2 in sim seconds")
    ap.add_argument("--downtime", type=float, default=d.D_s,
                    help="downtime D (D2) in sim seconds")
    ap.add_argument("--c1", type=float, default=None,
                    help="buddy checkpoint cost C1 (default: = C2)")
    ap.add_argument("--r1", type=float, default=None,
                    help="buddy recovery cost R1 (default: = R2)")
    ap.add_argument("--q", type=float, default=d.q,
                    help="P[failure also loses the buddy copy]")
    ap.add_argument("--omega", type=float, default=d.omega,
                    help="checkpoint overlap factor")
    ap.add_argument("--pfs-every", type=int, default=None,
                    help="deep-write cadence m (default: policy-chosen)")
    ap.add_argument("--buddy", action=argparse.BooleanOptionalAction,
                    default=True, help="in-memory buddy replica level")
    ap.add_argument("--inject-failures", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="inject failures (needs a finite --mtbf)")
    ap.add_argument("--compress", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="int8 blockwise checkpoint compression")
    ap.add_argument("--profile", default="paper",
                    choices=sorted(PROFILES))
    ap.add_argument("--sim-step-seconds", type=float, default=1.0,
                    help="virtual seconds per step (<= 0: real wall time)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--jsonl", default=None,
                    help="write per-step/-event metrics to this jsonl file")
    ap.add_argument("--quiet", action=argparse.BooleanOptionalAction,
                    default=False, help="suppress per-event stdout metrics")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="short self-checking run")
    ap.add_argument("--device", default="cuda",
                    help="where the run trains (cuda or cpu)")
    return ap


def spec_from_args(args) -> "RunSpec":
    from ..ft.run import RunSpec
    pk = {}
    if args.process == "weibull" and args.process_param is not None:
        pk["shape"] = args.process_param
    if args.process == "lognormal" and args.process_param is not None:
        pk["sigma"] = args.process_param
    return RunSpec(
        arch=args.arch, reduce=args.reduce, layers=args.layers,
        d_model=args.d_model, batch=args.batch, seq=args.seq, lr=args.lr,
        seed=args.seed, total_steps=args.steps,
        strategy=args.strategy, pfs_every=args.pfs_every,
        use_buddy=args.buddy,
        step_s=(args.sim_step_seconds if args.sim_step_seconds > 0
                else None),
        mu_s=args.mtbf if args.inject_failures else float("inf"),
        C_s=args.ckpt_cost, R_s=args.recovery, D_s=args.downtime,
        C1_s=args.c1, R1_s=args.r1, q=args.q, omega=args.omega,
        process=args.process, process_kwargs=pk,
        profile=args.profile, ckpt_dir=args.ckpt_dir,
        compress=args.compress)


def _make_tracker(args):
    from ..ft.tracker import (CompositeTracker, JsonlTracker, NullTracker,
                              StdoutTracker)
    backends = []
    if args.jsonl:
        backends.append(JsonlTracker(args.jsonl))
    if not args.quiet:
        backends.append(StdoutTracker(kinds=("failure", "summary")))
    if not backends:
        return NullTracker()
    return backends[0] if len(backends) == 1 else CompositeTracker(*backends)


def _smoke(device="cuda", ckpt_dir=None):
    """A short multilevel scaled-time run must finish all steps and land
    measured wall/energy near the model's prediction."""
    from ..ft.run import RunSpec, execute

    spec = RunSpec(ckpt_dir=ckpt_dir, **SMOKE_SPEC)
    rep = execute(spec, device=device)
    if rep["final_step"] != spec.total_steps:
        raise SystemExit(f"FAIL: stopped at step {rep['final_step']}")
    print(f"PASS completed {rep['final_step']} steps with "
          f"{rep['n_failures']} failures ({rep['n_rollbacks']} rollbacks)")
    pred = rep["predicted"]
    for key in ("wall_ratio", "energy_ratio"):
        r = pred[key]
        if not 0.7 < r < 1.3:
            raise SystemExit(f"FAIL: {key} {r:.3f} outside [0.7, 1.3]")
    print(f"PASS measured/predicted wall {pred['wall_ratio']:.3f}, "
          f"energy {pred['energy_ratio']:.3f} (single seed, loose gate)")
    op = rep["operating_point"]
    if op["deep_every"] < 1 or op["period_steps"] < 1:
        raise SystemExit(f"FAIL: degenerate operating point {op}")
    print(f"PASS policy chose T={op['period_solved_s']:.2f}s, "
          f"m={op['deep_every']}, k={op['period_steps']} steps")
    return rep


def main(argv=None):
    from ..ft.run import execute

    args = build_parser().parse_args(argv)
    if args.smoke:
        return _smoke(args.device, args.ckpt_dir)
    spec = spec_from_args(args)
    report = execute(spec, tracker=_make_tracker(args), device=args.device)
    if report["losses"]:
        report["losses"] = [report["losses"][0], report["losses"][-1]]
    print(json.dumps(report, indent=1, default=str))
    return report


if __name__ == "__main__":
    main()
