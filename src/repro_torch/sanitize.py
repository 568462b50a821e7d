"""Launch and leak sanitizer: mechanical backstops for the batching
discipline of the sweep, MC and advisor paths.

Counterpart of the reference's ``repro/sanitize.py``.  The reference counts
the programs jax compiles for each canonical workload and runs it under
``jax.checking_leaks``.  The port compiles nothing: its counterpart of a
compiled program is a distinct kernel-wrapper call signature, and what a
per-point regression multiplies is the ops it dispatches.  So one cold run
of each canonical workload (the reference's three: fig2_small,
multilevel_small, advisor_batch; and the port's mc_event_small, whose
event kernel makes the wrapper counts count) is counted under a dispatch
mode
(:class:`LaunchCounter`):

* ``aten_ops``      -- aten ops dispatched, a kernel-wrapper call counted
                       as one op (the ops its plain version or its output
                       allocation dispatch are not: ``kernels/cost.py``);
* ``wrapper_calls`` -- kernel-wrapper calls;
* ``signatures``    -- distinct (wrapper, shapes, dtypes) of those calls;
* ``host_syncs``    -- ``aten._local_scalar_dense`` (``item``, ``bool``,
                       ``int`` of a tensor), ops whose output shape depends
                       on the data (``nonzero``, ``masked_select``, ...),
                       and calls that copy to the host (``Tensor.cpu``,
                       ``numpy``, ``tolist``).

A call that moves or casts a tensor (``Tensor.to``, ``cuda`` and those
three) counts as one aten op whatever it dispatches: on the card a move
to the device copies, on the CPU it is a no-op that dispatches nothing.

The counts do not depend on the device: on the CPU the wrappers run their
plain versions, on the card their kernels, and either is one unit; the
workloads pin the f64 policy.  A ``.to`` a CPU device is not counted as
a copy to the host: on the CPU it cannot be told from a no-op.  On the
card
:func:`card_report` adds the CUDA kernels the profiler saw and the syncs
that ``torch.cuda.set_sync_debug_mode("warn")`` reported (host-to-device
copies from pageable memory among them).

Budgets carry the reference's slack, ``max(4, 25%)`` over the measured
count, and live in ``src/repro_torch/sanitize_budget.json``::

    PYTHONPATH=src python -m repro_torch.sanitize --write --device cpu

writes them; ``python -m repro_torch.sanitize`` measures and checks (exit
1 on a breach: :class:`LaunchBudgetError` names the count that went
over).

The leak check (the counterpart of ``jax.checking_leaks``) runs a workload
with the garbage collector disabled and requires that no tensor it made
outlives it: on the CPU the live tensor objects are counted before and
after, on the card ``torch.cuda.memory_allocated()`` must be back to its
start.  The workload runs once before the checked run, so that what a
process keeps by design (the built kernel libraries, a module's constants)
is in place first.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import sys
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ._device import resolve_device
from .kernels import cost as kcost

BUDGET_PATH = Path(__file__).resolve().parent / "sanitize_budget.json"
COUNTS = ("aten_ops", "wrapper_calls", "signatures", "host_syncs")


class LaunchCounter(TorchDispatchMode):
    """Counts what one workload dispatches (module docstring)."""

    def __init__(self):
        super().__init__()
        self.aten_ops = 0
        self.wrapper_calls = Counter()
        self.sigs = set()
        self.syncs = Counter()
        self.in_copy = 0

    def kernel(self, name: str, work, sig) -> None:
        self.aten_ops += 1
        self.wrapper_calls[name] += 1
        self.sigs.add(sig)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if kcost.suspended() or self.in_copy:
            return out
        self.aten_ops += 1
        if func.overloadpacket is torch.ops.aten._local_scalar_dense:
            self.syncs["scalar"] += 1
        elif torch.Tag.dynamic_output_shape in func.tags:
            self.syncs["data_dependent_shape"] += 1
        return out

    def counts(self) -> Dict[str, int]:
        return {"aten_ops": self.aten_ops,
                "wrapper_calls": sum(self.wrapper_calls.values()),
                "signatures": len(self.sigs),
                "host_syncs": sum(self.syncs.values())}


_TO_HOST = (torch.Tensor.cpu, torch.Tensor.numpy, torch.Tensor.tolist)
#: calls that move or cast a tensor: one aten op each, whether they
#: dispatch (a copy between devices, a cast) or not (a move to the device
#: the tensor is on), so that the count does not depend on the device.
_MOVES = (torch.Tensor.to, torch.Tensor.cuda) + _TO_HOST


class _HostCopies(TorchFunctionMode):
    """Counts a call that moves or casts a tensor as one aten op (and the
    ops it dispatches as none), and a copy to the host as a host sync."""

    def __init__(self, counter: LaunchCounter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kcost.suspended() or self.counter.in_copy or func not in _MOVES:
            return func(*args, **kwargs)
        if func in _TO_HOST:
            self.counter.syncs["host_copy"] += 1
        self.counter.aten_ops += 1
        self.counter.in_copy += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.counter.in_copy -= 1


@contextlib.contextmanager
def count_launches():
    """Count what the block dispatches; yields the :class:`LaunchCounter`."""
    counter = LaunchCounter()
    with kcost.counting(counter), _HostCopies(counter), counter:
        yield counter


# ---------------------------------------------------------------------------
# canonical workloads
# ---------------------------------------------------------------------------

def _run_fig2_small(device) -> None:
    from .sim import F64, sweep_mu_rho_grid
    sweep_mu_rho_grid([120.0, 300.0, 600.0], [1.0, 2.5, 5.0], device=device,
                      precision=F64)


def _run_multilevel_small(device) -> None:
    from .sim import F64, buddy_ratio_grid, evaluate_multilevel_grid
    grid = buddy_ratio_grid([0.1, 0.5], [0.05, 0.2], mu_min=300.0,
                            device=device)
    evaluate_multilevel_grid(grid, m_values=(1, 2, 3, 4), device=device,
                             precision=F64)


def _run_advisor_batch(device) -> None:
    from .launch.serve import generator
    from .serve.loadgen import synthetic_requests
    from .serve.service import AdvisorService
    from .sim import F64
    svc = AdvisorService(cache_name=None, device=device, precision=F64)
    svc.advise_many(synthetic_requests(12, generator(0),
                                       repeat_frac=0.25))


def _run_mc_event_small(device) -> None:
    from .launch.serve import generator
    from .sim import F64, mu_rho_grid, simulate_trajectories
    grid = mu_rho_grid([120.0, 300.0, 600.0], [1.0, 2.5, 5.0],
                       device=device)
    gaps = torch.from_numpy(generator(0).exponential(
        300.0, (grid.size, 32, 16))).to(device)
    simulate_trajectories(60.0, grid, gaps=gaps, engine_kind="event",
                          precision=F64, device=device)


#: name -> canonical workload of one argument, the device.  Each pins the
#: f64 policy: the device default differs (compensated f32 on CUDA), and
#: with it the ops a workload dispatches.  The first three are the
#: reference's; ``mc_event_small`` (fig2_small's grid through the event
#: kernel on a caller's schedule, one wrapper call on either device) is
#: the port's, so that ``wrapper_calls`` and ``signatures`` count a path
#: that has a kernel.
CANONICAL_WORKLOADS: Dict[str, Callable] = {
    "fig2_small": _run_fig2_small,
    "multilevel_small": _run_multilevel_small,
    "advisor_batch": _run_advisor_batch,
    "mc_event_small": _run_mc_event_small,
}


def measure_workload(fn: Callable, device="cuda") -> Dict[str, int]:
    """The counts (``COUNTS``) of one run of ``fn(device)``."""
    dev = resolve_device(device)
    with count_launches() as counter:
        fn(dev)
    return counter.counts()


def measure_all(device="cuda") -> Dict[str, Dict[str, int]]:
    return {name: measure_workload(fn, device)
            for name, fn in CANONICAL_WORKLOADS.items()}


# ---------------------------------------------------------------------------
# leaks
# ---------------------------------------------------------------------------

class LeakError(AssertionError):
    """A workload left tensors alive after it returned."""


def _live_tensors() -> dict:
    import warnings
    with warnings.catch_warnings():   # deprecated module attributes warn
        warnings.simplefilter("ignore")
        return {id(o): o for o in gc.get_objects()
                if isinstance(o, torch.Tensor)}


def run_leak_checked(fn: Callable, device="cuda") -> None:
    """Run ``fn(device)`` once, then again with the garbage collector
    disabled, and raise :class:`LeakError` if a tensor the second run made
    is still alive after it (on the card: if ``memory_allocated`` is not
    back to its start)."""
    dev = resolve_device(device)
    fn(dev)
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
        ids = set(_live_tensors())
        fn(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            after = torch.cuda.memory_allocated(dev)
            if after != before:
                raise LeakError(f"{after - before} bytes of device memory "
                                f"outlived the workload")
        new = [t for i, t in _live_tensors().items() if i not in ids]
        if new:
            raise LeakError(
                f"{len(new)} tensors outlived the workload: " + ", ".join(
                    f"{tuple(t.shape)} {t.dtype} on {t.device}"
                    for t in new[:8]))
    finally:
        if was:
            gc.enable()


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------

class LaunchBudgetError(AssertionError):
    """A workload went over one of its committed budgets."""


def _slack(measured: int) -> int:
    return max(4, math.ceil(0.25 * measured))


def load_budgets(path: Path = BUDGET_PATH) -> Optional[Dict]:
    try:
        return json.loads(Path(path).read_text()).get("workloads")
    except (OSError, json.JSONDecodeError):
        return None


def launch_gate(name: str, measured: Dict[str, int],
                budgets: Optional[Dict] = None,
                path: Path = BUDGET_PATH) -> None:
    """Raise :class:`LaunchBudgetError` naming every count of ``measured``
    above the committed budget of workload ``name`` (no-op when none is
    committed)."""
    if budgets is None:
        budgets = load_budgets(path)
    entry = (budgets or {}).get(name)
    if entry is None:
        return
    over = [f"{k} {measured[k]} > budget {entry[k]['budget']} (measured "
            f"{entry[k]['measured']} when committed)"
            for k in COUNTS if k in entry and measured[k] > entry[k]["budget"]]
    if over:
        raise LaunchBudgetError(
            f"{name}: " + "; ".join(over) + ".  A loop over points or "
            "requests dispatches per item: batch it, or regenerate the "
            "budgets with `python -m repro_torch.sanitize --write` if the "
            "change is deliberate.")


def write_budgets(measured: Dict[str, Dict[str, int]],
                  path: Path = BUDGET_PATH) -> Dict:
    payload = {
        "unit": "counts per cold canonical workload (repro_torch.sanitize)",
        "slack": "budget = measured + max(4, ceil(25% of measured))",
        "workloads": {name: {k: {"measured": n, "budget": n + _slack(n)}
                             for k, n in counts.items()}
                      for name, counts in measured.items()},
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
    return payload["workloads"]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def card_report(fn: Callable, device="cuda") -> dict:
    """On CUDA: one run of ``fn(device)`` under the profiler and under
    ``torch.cuda.set_sync_debug_mode("warn")``; returns the CUDA kernels
    the profiler saw and the syncs the sync debug mode reported."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"card_report runs on a CUDA device, not {dev}")
    torch.cuda.synchronize(dev)
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(dev)
                torch.cuda.synchronize(dev)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    kernels = sum(1 for e in prof.events()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type))
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    return {"cuda_kernels": kernels, "sync_debug_syncs": len(syncs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sanitize",
        description="Count each canonical workload's dispatched ops, kernel "
                    "calls, signatures and host syncs, check them against "
                    "the committed budgets (or --write them), and run the "
                    "leak check.")
    ap.add_argument("--write", action="store_true",
                    help="rewrite the budgets from this run")
    ap.add_argument("--path", type=Path, default=BUDGET_PATH)
    ap.add_argument("--device", default="cuda",
                    help="default cuda; raises without a GPU unless 'cpu' "
                         "is asked for")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    measured = measure_all(dev)
    for name, counts in measured.items():
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if args.write:
        entry = write_budgets(measured, path=args.path)
        print(f"wrote budgets to {args.path}: {json.dumps(entry)}")
        return 0
    budgets = load_budgets(args.path)
    if budgets is None:
        print(f"no budgets committed in {args.path}; run with --write",
              file=sys.stderr)
        return 1
    failed = False
    for name, counts in measured.items():
        try:
            launch_gate(name, counts, budgets)
        except LaunchBudgetError as e:
            print(f"FAIL {e}", file=sys.stderr)
            failed = True
        try:
            run_leak_checked(CANONICAL_WORKLOADS[name], dev)
        except LeakError as e:
            print(f"FAIL {name}: {e}", file=sys.stderr)
            failed = True
    print("launch budgets and leak check:", "BREACHED" if failed else "ok")
    return 1 if failed else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
