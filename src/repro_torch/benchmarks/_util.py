"""Shared helpers of the port's figure and table scripts."""
from __future__ import annotations

import time
from pathlib import Path

#: where the scripts write their CSVs: ``build/repro_torch_results/`` at
#: the root of the checkout.
RESULTS = Path(__file__).resolve().parents[3] / "build" / "repro_torch_results"


def out_path(name: str) -> Path:
    """``RESULTS / name``, creating ``RESULTS`` first."""
    RESULTS.mkdir(parents=True, exist_ok=True)
    return RESULTS / name


def timed(fn, *args, repeat: int = 3, **kw):
    """``(last result, best host-clock time in us)`` of ``repeat`` calls."""
    best = float("inf")
    out = None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        best = min(best, time.perf_counter() - t0)
    return out, best * 1e6


def emit(name: str, us_per_call: float, derived: str = "") -> str:
    """Print and return one ``name,us_per_call,derived`` row."""
    row = f"{name},{us_per_call:.1f},{derived}"
    print(row)
    return row
