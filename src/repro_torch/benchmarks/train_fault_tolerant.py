"""End-to-end example: train a language model for a few hundred steps under
injected failures, with the paper's checkpoint-period policy closing the
loop (measured C/omega/mu -> AlgoT or AlgoE period -> energy report).

Counterpart of the reference's ``examples/train_fault_tolerant.py``.
Default is a reduced xLSTM (4 layers, d 256); ``--full-125m`` trains the
full xlstm-125m config (~173M params, the launcher's default batch and
sequence), sized for the card.  (The reference's flag leaves the
launcher's ``--reduce`` default on, so there it trains the reduced config;
here it passes ``--no-reduce``.)

    python -m repro_torch.benchmarks.train_fault_tolerant --steps 200
    python -m repro_torch.benchmarks.train_fault_tolerant --full-125m
"""
from __future__ import annotations

import argparse

from ..launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--strategy", default="algo_t")
    ap.add_argument("--mtbf", type=float, default=60.0)
    ap.add_argument("--full-125m", action="store_true")
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args(argv)

    argv = ["--arch", "xlstm-125m", "--steps", str(args.steps),
            "--strategy", args.strategy, "--mtbf", str(args.mtbf),
            "--inject-failures", "--sim-step-seconds", "1.0",
            "--device", args.device]
    if args.full_125m:
        argv += ["--no-reduce"]
    else:
        argv += ["--reduce", "--layers", "4", "--d-model", "256",
                 "--batch", "8", "--seq", "128"]
    report = train_mod.main(argv)
    e = report["energy"]
    print(f"\nsummary: {report['final_step']} steps, "
          f"{report['n_failures']} failures, "
          f"{report['n_rollbacks']} rollbacks, "
          f"E_total={e['E_total_j']:.0f} J over {e['T_wall_s']:.0f} s")
    return report


if __name__ == "__main__":
    main()
