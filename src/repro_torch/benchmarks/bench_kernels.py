"""Kernel microbenchmarks of the port: the reference's five rows
(``benchmarks/bench_kernels.py``) on the port's kernels.

    python -m repro_torch.benchmarks.bench_kernels [--device cuda]
        [--out PATH] [--seed N]

Rows ``name,us_per_call,derived`` at the reference's shapes: flash
attention, causal, (B, S, H, Dh) = (2, 512, 4, 128) in bf16; the RG-LRU
scan (4, 1024, 256); the mLSTM (2, 2, 512, 128) with chunk 128; quantize
of a 1024 x 1024 array; the event sweep over 16 points x 128 trials x 32
gaps in f64.  Each row is the best of 3 host-clock calls after one warm-up
(synchronized on CUDA), through the public wrappers (``kernels.ops``,
``kernels.event_sweep``), so on CUDA the kernels run and on the CPU their
plain versions.  Inputs come from a ``torch.Generator`` seeded with
``--seed`` on the device.  The rows are printed and written to
``build/repro_torch_results/bench_kernels.csv`` (or ``--out``).  The
default device is ``cuda``, which raises without a GPU; ``main(...,
small=True)`` shrinks every shape (for tests).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from .._device import resolve_device
from ..kernels import ops
from ..kernels.event_sweep import event_sweep

RESULTS = Path(__file__).resolve().parents[3] / "build" / "repro_torch_results"

#: (flash (B, S, H, Dh), RG-LRU (B, S, W), mLSTM (B, H, S, Dh, chunk),
#: quantize (N, D), event sweep (points, trials, gaps)).
SHAPES = {False: ((2, 512, 4, 128), (4, 1024, 256), (2, 2, 512, 128, 128),
                  (1024, 1024), (16, 128, 32)),
          True: ((1, 128, 2, 128), (2, 64, 128), (1, 2, 128, 128, 64),
                 (128, 256), (4, 16, 8))}


def timed(fn, device: torch.device, repeat: int = 3):
    """(result, best microseconds) of ``repeat`` calls after a warm-up."""
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    out = fn()
    sync()
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return out, best * 1e6


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def main(device="cuda", out=None, seed: int = 0, small: bool = False):
    """Time the five kernels; returns the rows ``(name, us, derived)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    (fB, fS, fH, fD), (rB, rS, rW), (mB, mH, mS, mD, mC), (qN, qD), \
        (eB, eN, eF) = SHAPES[small]
    rows = []

    def row(name, us, derived):
        rows.append((name, us, derived))
        emit(name, us, derived)

    q, k, v = (randn(fB, fS, fH, fD).to(torch.bfloat16) for _ in range(3))
    _, us = timed(lambda: ops.flash_attention(q, k, v, mode="causal"), dev)
    flops = 4 * fB * fH * fS * fS * fD / 2
    row(f"flash_attention_{fS}", us,
        f"{flops / (us / 1e6) / 1e9:.2f} GFLOP/s-equiv")

    a = torch.sigmoid(randn(rB, rS, rW))
    b = randn(rB, rS, rW)
    h0 = torch.zeros((rB, rW), device=dev)
    _, us = timed(lambda: ops.rglru_scan(a, b, h0), dev)
    row(f"rglru_scan_{rB}x{rS}x{rW}", us,
        f"{a.numel() * 4 / (us / 1e6) / 1e9:.3f} GB/s-equiv")

    qm = randn(mB, mH, mS, mD) * mD ** -0.5
    km = randn(mB, mH, mS, mD) * mD ** -0.5
    vm = randn(mB, mH, mS, mD)
    li = randn(mB, mH, mS)
    lf = torch.nn.functional.logsigmoid(randn(mB, mH, mS) + 2)
    _, us = timed(lambda: ops.mlstm_scan(qm, km, vm, li, lf, chunk=mC), dev)
    row(f"mlstm_scan_{mB}x{mH}x{mS}", us, f"chunkwise={mC}")

    x = randn(qN, qD)
    (qq, ss, _), us = timed(lambda: ops.quantize_array(x), dev)
    ratio = (qq.numel() * qq.element_size()
             + ss.numel() * ss.element_size()) / (x.numel() * 4)
    n = x.numel()
    size = f"{n >> 20}M" if n % (1 << 20) == 0 else str(n)
    row(f"quant_blockwise_{size}elem", us, f"payload_ratio={ratio:.3f}")

    # the event sweep at the engine's tile, on deterministic gaps
    f64 = dict(dtype=torch.float64, device=dev)
    gaps = torch.linspace(5.0, 400.0, eB * eN * eF, **f64).reshape(eB, eN, eF)
    col = torch.full((eB,), 60.0, **f64)
    args = (col, col * 0.1, col * 0.05, col * 0.01, torch.zeros_like(col),
            col * 25.0, gaps)
    _, us = timed(lambda: event_sweep(*args, n_steps=eF + 1)["wall_time"],
                  dev)
    row(f"event_sweep_{eB}x{eN}", us,
        f"{gaps.numel() * 8 / (us / 1e6) / 1e9:.3f} GB/s-equiv")

    path = Path(out) if out is not None else RESULTS / "bench_kernels.csv"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("name,us_per_call,derived\n")
        for name, us, derived in rows:
            f.write(f"{name},{us:.1f},{derived}\n")
    return rows


def cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    main(device=a.device, out=a.out, seed=a.seed)


if __name__ == "__main__":
    cli()
