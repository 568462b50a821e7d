"""Roofline analysis: the dry run's launch plans AND the port's own hot
programs.

Counterpart of the reference's ``benchmarks/roofline.py``, with one cost
model (``repro_torch.launch.cost``) and one table of peaks
(``repro_torch.kernels.cost.PEAKS``, the H100 variants):

1. **Launch plans** -- reads ``build/repro_torch_results/dryrun/*.json``
   (written by ``repro_torch.launch.dryrun``) and derives, per (arch x
   shape x mesh)::

     compute_term    = walked_flops_per_device / peak_flops           [s]
     memory_term     = walked_hbm_bytes_per_device / hbm_bandwidth    [s]
     collective_term = walked_collective_bytes_per_device / link_bw   [s]

   with ``link_bw`` the slowest link a mesh axis crosses: NVLink within a
   node of 8 cards, the network between nodes.  Both rates are recorded,
   and which link each axis crosses (:func:`axis_links`).  Emits
   ``roofline.csv`` + ``roofline.md``.

2. **Sweep stack** -- costs the port's own hot programs at the
   reference's section-2 shape (64 points x 64 trials, capacity 32):
   ``sim/sweep.py::_evaluate_core``, the step scan
   (``sim/engine.py::_run_one``), and the explicit and sampled event kernel
   (``kernels/event_sweep.py``), each with ``launch.cost.analyze``.  A
   kernel row's bound is its ``kernels/cost.py`` model on the run's own
   lanes (the gaps they read); the other rows' bound is the larger of
   their FLOPs and their (upper-bound) bytes over the peaks.  On the card
   each row is also timed with CUDA events (``ms``).  Emits
   ``roofline_sweep.csv`` + ``roofline_sweep.md``.

Every file written carries the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit``) and the peaks used.  Files go to
``build/repro_torch_results/``.

    python -m repro_torch.benchmarks.roofline            # on the card
    python -m repro_torch.benchmarks.roofline --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

from . import _util
from ._util import emit, timed

#: cards a node holds (DGX H100 / HGX H100 8-GPU).
NODE_CARDS = 8


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One backend's roofline ceilings (per device)."""

    flops: float      # peak FLOP/s in the matmul dtype the plan uses
    hbm_bw: float     # device-memory bandwidth, bytes/s
    link_bw: float    # the slowest link a mesh axis crosses, bytes/s
    source: str       # where the numbers came from (recorded in outputs)
    nvlink_bw: float = 0.0   # within a node
    net_bw: float = 0.0      # between nodes

    def replaced(self, peak_flops=None, hbm_bw=None, link_bw=None):
        """CLI overrides: replace any provided ceiling, amend the source."""
        if peak_flops is None and hbm_bw is None and link_bw is None:
            return self
        return dataclasses.replace(
            self, flops=peak_flops or self.flops, hbm_bw=hbm_bw or self.hbm_bw,
            link_bw=link_bw or self.link_bw,
            source=self.source + " + cli override")


def _h100(key: str) -> Peaks:
    from ..kernels.cost import PEAKS as DEVICE
    p = DEVICE[key]
    return Peaks(p.bf16, p.hbm_bw, min(p.nvlink_bw, p.net_bw),
                 f"H100 {key} data sheet (dense bf16 tensor cores; "
                 f"kernels/cost.py PEAKS[{key!r}])", p.nvlink_bw, p.net_bw)


#: per-backend peaks.  Keys are matched (case-insensitively) against the
#: device name first (longest match wins), then the platform name; the
#: H100 rows read ``kernels/cost.py``'s table.
PEAKS = {
    "h100 pcie": _h100("PCIe"),
    "h100 nvl": _h100("NVL"),
    "h100": _h100("SXM"),
    "cuda": _h100("SXM"),
    "cpu": Peaks(5e10, 2e10, 1e10, "order-of-magnitude host estimate "
                 "(per-core f64 FMA / DDR stream share)", 1e10, 1e10),
}

#: the launch-plan section models the card the plans target, whatever
#: host runs the analysis.
PLAN_BACKEND = "h100"


def resolve_peaks(device_kind: str = "", platform: str = "",
                  peak_flops=None, hbm_bw=None, link_bw=None) -> Peaks:
    """The peak entry for a backend, longest device-name key first, then
    platform, then the cpu floor; any CLI overrides applied."""
    kind = (device_kind or "").lower()
    hits = [k for k in PEAKS if k in kind]
    if hits:
        key = max(hits, key=len)
    elif (platform or "").lower() in PEAKS:
        key = platform.lower()
    else:
        key = "cpu"
    return PEAKS[key].replaced(peak_flops, hbm_bw, link_bw)


def card_line(device="cuda") -> str:
    """``name, power limit`` of card 0 as ``nvidia-smi`` gives them, or what
    runs the analysis when there is no card (``device`` cpu)."""
    import torch
    if torch.device(device).type != "cuda":
        return "cpu (no card)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else torch.cuda.get_device_name(0)


def host_peaks(device="cuda", peak_flops=None, hbm_bw=None, link_bw=None):
    """``(backend info, peaks)`` of the device the sweep section runs on."""
    from ..sim.dispatch import backend_info
    info = backend_info(device)
    return info, resolve_peaks(info.device_kind, info.platform,
                               peak_flops, hbm_bw, link_bw)


# ---------------------------------------------------------------------------
# Section 1 -- launch plans
# ---------------------------------------------------------------------------

def axis_links(names, sizes, node: int = NODE_CARDS) -> dict:
    """Which link each mesh axis crosses, ranks laid out in mesh order (the
    last axis fastest): an axis whose ranks lie within one node of
    ``node`` cards crosses NVLink, any other the network."""
    out = {}
    stride = 1
    for name, size in reversed(list(zip(names, sizes))):
        span = stride * size
        within = span <= node and node % span == 0
        out[name] = "nvlink" if within or size == 1 else "network"
        stride = span
    return dict(reversed(list(out.items())))


_MESHES = {"pod16x16": (("data", "model"), (16, 16)),
           "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def model_flops_global(rec: dict) -> float:
    """MODEL_FLOPS: 6*N*D (train) / 2*N*D (forward only)."""
    n_active = rec["active_param_count"]
    if rec["kind"] == "train":
        return 6.0 * n_active * rec["global_batch"] * rec["seq_len"]
    if rec["kind"] == "prefill":
        return 2.0 * n_active * rec["global_batch"] * rec["seq_len"]
    return 2.0 * n_active * rec["global_batch"]


def bottleneck_note(rec: dict, dom: str) -> str:
    if dom == "compute":
        if rec["arch"].startswith(("dbrx", "llama4")) and \
                rec.get("moe_impl_dense", True):
            return "dense-MoE computes all experts: capacity/a2a EP cuts " \
                   "compute ~E/k"
        return "remat recompute + head padding: selective remat / exact " \
               "head sharding"
    if dom == "memory":
        return "eager ops stream every intermediate: fused kernels / " \
               "larger time blocks on chip"
    return "gradient all-reduce over the network dominates: overlap with " \
           "compute, or reduce-scatter (ZeRO) over the data axis"


def load_records():
    d = _util.RESULTS / "dryrun"
    recs = []
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        if "walked" in r:
            recs.append(r)
    return recs


def analyze(rec: dict, peaks: Peaks) -> dict:
    w = rec["walked"]
    chips = rec["n_chips"]
    compute = w["flops_per_device"] / peaks.flops
    memory = w["hbm_bytes_per_device"] / peaks.hbm_bw
    coll = w["coll_bytes_total"] / peaks.link_bw
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dom = max(terms, key=terms.get)
    mf = model_flops_global(rec) / chips
    useful = mf / w["flops_per_device"] if w["flops_per_device"] else 0.0
    bound = max(terms.values())
    mfu_bound = (mf / peaks.flops) / bound if bound > 0 else 0.0
    names, sizes = _MESHES.get(rec["mesh"], ((), ()))
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "dominant": dom,
        "model_flops_per_dev": mf,
        "useful_flop_ratio": useful,
        "roofline_fraction": mfu_bound,
        "fits_hbm": rec["fits_hbm"],
        "arg_gib": rec["memory"]["argument_bytes"] / 2**30,
        "peak_gib": rec["memory"]["peak_bytes_est"] / 2**30,
        "links": ";".join(f"{a}={l}" for a, l in
                          axis_links(names, sizes).items()),
        "note": bottleneck_note(rec, dom),
    }


def _peaks_line(peaks: Peaks, card: str) -> str:
    return (f"card: {card}; peaks: flops={peaks.flops:.4g} "
            f"hbm_bw={peaks.hbm_bw:.4g} link_bw={peaks.link_bw:.4g} "
            f"(nvlink {peaks.nvlink_bw:.4g}, network {peaks.net_bw:.4g}; "
            f"{peaks.source})")


def _peaks_md(lines: list, peaks: Peaks, backend: str, card: str):
    lines += [f"Card: {card}.", "",
              f"Peaks ({backend}): `{peaks.flops:.4g}` FLOP/s, "
              f"`{peaks.hbm_bw:.4g}` B/s HBM, `{peaks.link_bw:.4g}` B/s "
              f"link (NVLink `{peaks.nvlink_bw:.4g}` within a node of "
              f"{NODE_CARDS}, network `{peaks.net_bw:.4g}` between nodes) "
              f"-- {peaks.source}.", ""]
    lines += ["| backend key | peak FLOP/s | HBM B/s | link B/s | source |",
              "|---|---|---|---|---|"]
    for k, p in PEAKS.items():
        lines.append(f"| {k} | {p.flops:.4g} | {p.hbm_bw:.4g} "
                     f"| {p.link_bw:.4g} | {p.source} |")
    lines.append("")


def _write_csv(path, cols, rows, header: str) -> None:
    with open(path, "w") as f:
        f.write(f"# {header}\n")
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(
                f"{r[c]:.6g}" if isinstance(r[c], float) else str(r[c])
                for c in cols) + "\n")


def run(peaks: Peaks, card: str):
    rows = [analyze(r, peaks) for r in load_records()]
    out = _util.out_path("roofline.csv")
    cols = ["arch", "shape", "mesh", "compute_s", "memory_s",
            "collective_s", "dominant", "model_flops_per_dev",
            "useful_flop_ratio", "roofline_fraction", "fits_hbm", "arg_gib",
            "peak_gib", "links", "note"]
    _write_csv(out, cols, rows, _peaks_line(peaks, card))
    lines = ["# Launch-plan roofline", ""]
    _peaks_md(lines, peaks, PLAN_BACKEND, card)
    lines += ["| arch | shape | mesh | compute s | memory s | coll s | "
              "dominant | useful | roofline frac | args GiB | peak GiB | "
              "fits | links |",
              "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                     f"{r['compute_s']:.3f} | {r['memory_s']:.3f} | "
                     f"{r['collective_s']:.3f} | {r['dominant']} | "
                     f"{r['useful_flop_ratio']:.2f} | "
                     f"{r['roofline_fraction']:.2f} | {r['arg_gib']:.2f} | "
                     f"{r['peak_gib']:.2f} | "
                     f"{'Y' if r['fits_hbm'] else 'N'} | {r['links']} |")
    _util.out_path("roofline.md").write_text("\n".join(lines) + "\n")
    return out, rows


# ---------------------------------------------------------------------------
# Section 2 -- the sweep stack's own programs
# ---------------------------------------------------------------------------

#: section-2 workload shape (the reference's): points, trials, capacity.
_SW_POINTS, _SW_TRIALS, _SW_CAP = 64, 64, 32
#: the sampled kernel's seed (its draws are counter-based: any fixed seed).
_SW_SEED = 0


def _sweep_workload(device):
    """Deterministic sweep and engine inputs at the section's shape, on
    ``device``: the stacked (9, B) parameters of ``_evaluate_core``, the
    engine's per-point arguments and a (B, N, F) schedule of evenly spaced
    gaps (no RNG: the reference's)."""
    import numpy as np
    import torch
    from ..core import EXASCALE_POWER_RHO55, fig12_checkpoint
    from ..sim import ParamGrid
    from ..sim.sweep import _FIELD_ORDER

    B, N, F = _SW_POINTS, _SW_TRIALS, _SW_CAP
    mus = np.linspace(120.0, 600.0, B)
    base = ParamGrid.from_params(fig12_checkpoint(300.0),
                                 EXASCALE_POWER_RHO55, device=device)
    grid = ParamGrid(**{f: (torch.as_tensor(mus, dtype=torch.float64,
                                            device=device) if f == "mu"
                            else v.expand(B).clone())
                        for f, v in base.fields().items()})
    P = torch.stack([getattr(grid, f) for f in _FIELD_ORDER])
    f64 = dict(dtype=torch.float64, device=device)
    gaps = torch.linspace(5.0, 400.0, B * N * F, **f64).reshape(B, N, F)
    engine_args = (torch.full((B,), 60.0, **f64), grid.C, grid.R, grid.D,
                   grid.omega, torch.full((B,), 1500.0, **f64), gaps)
    return grid, P, engine_args


def _events_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event ms of one call of ``fn`` (after a warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sweep_programs(device, draw_ops=None):
    """(name, shape label, call, kernel-bound fn or None) of each
    section-2 program on ``device``.  A kernel-bound fn takes the call's
    result and returns the kernel's ``Work`` for the lanes it ran;
    ``draw_ops`` (INT32, FP64 instructions a gap of the Exponential draw,
    counted in the SASS) adds the sampled kernel's draws to its bound."""
    import torch
    from ..core import Exponential
    from ..kernels import cost as kcost
    from ..kernels import event_sweep as es
    from ..sim import engine as te
    from ..sim import sweep as sw

    grid, P, eargs = _sweep_workload(device)
    B, N, F = _SW_POINTS, _SW_TRIALS, _SW_CAP
    n_steps = F + 1                      # event budget = capacity + 1
    points = torch.arange(B, dtype=torch.int64, device=device)
    spec = Exponential().gap_spec(grid.mu, B, device=device)

    def explicit_work(out):
        reads = torch.clamp_max(out["n_failures"].to(torch.int64) + 1, F)
        return kcost.event_sweep_work(B, B * N, int(reads.sum()))

    def sampled_work(out):
        reads = torch.clamp_max(out["n_failures"].to(torch.int64) + 1, F)
        return kcost.event_sweep_sampled_work(B, B * N, int(reads.sum()),
                                              draw_ops=draw_ops)

    shape = f"{B}x{N} trajectories / cap {F}"
    return [
        ("model_sweep_core", f"{B}-pt grid / AlgoT+AlgoE+Young+Daly+MSK",
         lambda: sw._evaluate_core(P, 1.0), None),
        ("step_scan", shape, lambda: te._run_one(
            *eargs, n_steps=te.default_step_budget(60.0, grid, 1500.0)),
         None),
        ("event_kernel_explicit", shape,
         lambda: es.event_sweep(*eargs, n_steps=n_steps), explicit_work),
        ("event_kernel_sampled", shape + " (drawn in the kernel)",
         lambda: es.event_sweep_sampled(
             *eargs[:6], seed=_SW_SEED, points=points, trial0=0, n_trials=N,
             spec=spec, capacity=F, n_steps=n_steps), sampled_work),
    ]


def analyze_sweep_programs(peaks: Peaks, device, dev_peaks=None,
                           draw_ops=None) -> list:
    """Cost each section-2 program (``launch.cost.analyze``); on CUDA also
    time it.  ``dev_peaks`` (a ``kernels.cost.DevicePeaks``) bounds the
    kernel rows (``draw_ops``: see :func:`sweep_programs`)."""
    import torch
    from ..kernels import cost as kcost
    from ..launch.cost import analyze
    dev_peaks = dev_peaks or kcost.PEAKS["SXM"]
    rows = []
    for name, shape, call, kernel_work in sweep_programs(device, draw_ops):
        cost = analyze(call)
        compute = cost.flops / peaks.flops
        memory = cost.hbm_bytes / peaks.hbm_bw
        terms = {"compute": compute, "memory": memory}
        row = {"program": name, "shape": shape, "dot_flops": cost.flops,
               "hbm_bytes": cost.hbm_bytes,
               "intensity": (cost.flops / cost.hbm_bytes
                             if cost.hbm_bytes else 0.0),
               "compute_s": compute, "memory_s": memory,
               "dominant": max(terms, key=terms.get),
               "kernel_calls": sum(cost.kernels.values()),
               "bound_ms": max(terms.values()) * 1e3, "bound_by": "model",
               "ms": None}
        if kernel_work is not None:
            b = kcost.bound_ms(kernel_work(call()), dev_peaks)
            row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        if torch.device(device).type == "cuda":
            row["ms"] = _events_ms(call)
        rows.append(row)
    return rows


def run_sweep_section(peaks: Peaks, backend: str, card: str, device,
                      dev_peaks=None):
    rows = analyze_sweep_programs(peaks, device, dev_peaks)
    out = _util.out_path("roofline_sweep.csv")
    cols = ["program", "shape", "dot_flops", "hbm_bytes", "intensity",
            "compute_s", "memory_s", "dominant", "kernel_calls", "bound_ms",
            "bound_by", "ms"]
    _write_csv(out, cols, rows, f"backend={backend}; "
               + _peaks_line(peaks, card))
    lines = ["# Sweep-stack roofline", "",
             "`repro_torch.launch.cost` on the port's own hot programs at "
             "the reference's section-2 shape.  A kernel call is one op of "
             "its `kernels/cost.py` model; the other ops are counted at "
             "their operand and result bytes, an upper bound (no fusion, "
             "no cache).  Kernel rows are bounded by their model on the "
             "lanes this run ran; `ms` is a CUDA-event median on the card "
             "(none on the CPU).", ""]
    _peaks_md(lines, peaks, backend, card)
    lines += ["| program | shape | dot FLOPs | HBM bytes | FLOP/byte | "
              "compute s | memory s | dominant | bound ms | ms |",
              "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        ms = "—" if r["ms"] is None else f"{r['ms']:.4g}"
        lines.append(f"| {r['program']} | {r['shape']} "
                     f"| {r['dot_flops']:.4g} | {r['hbm_bytes']:.4g} "
                     f"| {r['intensity']:.3g} | {r['compute_s']:.3g} "
                     f"| {r['memory_s']:.3g} | {r['dominant']} "
                     f"| {r['bound_ms']:.4g} ({r['bound_by']}) | {ms} |")
    _util.out_path("roofline_sweep.md").write_text("\n".join(lines) + "\n")
    return out, rows


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="override peak FLOP/s for BOTH sections")
    ap.add_argument("--hbm-bw", type=float, default=None,
                    help="override HBM bandwidth (bytes/s)")
    ap.add_argument("--link-bw", type=float, default=None,
                    help="override inter-card link bandwidth (bytes/s)")
    ap.add_argument("--device", default="cuda",
                    help="where section 2 runs (default cuda; raises "
                         "without a GPU unless 'cpu' is asked for)")
    args = ap.parse_args(argv)
    from .._device import resolve_device
    from ..kernels import cost as kcost
    dev = resolve_device(args.device)
    over = (args.peak_flops, args.hbm_bw, args.link_bw)
    card = card_line(dev)

    plan_peaks = resolve_peaks(PLAN_BACKEND, peak_flops=over[0],
                               hbm_bw=over[1], link_bw=over[2])
    (out, rows), us = timed(lambda: run(plan_peaks, card), repeat=1)
    info, hpeaks = host_peaks(dev, *over)
    dev_peaks = kcost.PEAKS[kcost.variant(info.device_kind)] \
        if dev.type == "cuda" else kcost.PEAKS["SXM"]
    (sout, srows), sus = timed(
        lambda: run_sweep_section(hpeaks, info.platform, card, dev,
                                  dev_peaks), repeat=1)

    n = len(rows)
    single = [r for r in rows if r["mesh"] == "pod16x16"]
    if single:
        worst = min(single, key=lambda r: r["roofline_fraction"])
        emit("roofline", us,
             f"{n} cells; worst single-pod fraction: {worst['arch']}x"
             f"{worst['shape']}={worst['roofline_fraction']:.3f} "
             f"-> {out.name}")
    else:
        emit("roofline", us, f"{n} cells (dry-run records pending)")
    emit("roofline_sweep", sus,
         f"{len(srows)} programs on {info.platform} ({card}); "
         + ", ".join(f"{r['program']}: bound {r['bound_ms']:.4g} ms"
                     + ("" if r["ms"] is None else f", {r['ms']:.4g} ms")
                     for r in srows) + f" -> {sout.name}")
    return rows, srows


if __name__ == "__main__":
    main()
