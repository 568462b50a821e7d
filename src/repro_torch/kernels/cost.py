"""The work of each kernel, the H100's peaks, and the bound they give.

One function per kernel of ``csrc/`` takes the kernel's shapes, dtypes and
mode and returns a :class:`Work`: the least device-memory bytes the work
needs (each input read once, each output written once) and its
operations by the unit that runs them.  :func:`bound_ms` turns a
:class:`Work` and a row of :data:`PEAKS` into the least time the card
could take for it.  ``chip_smoke.py`` prints its bounds from these
functions, ``launch/mesh.py``'s ``H100`` is built from ``PEAKS["SXM"]``,
and the tools (``launch/cost.py``, ``launch/dryrun.py``,
``benchmarks/roofline.py``, ``sanitize.py``) read the same models, so a
kernel's work is written down once.

Where the work depends on the data (the event kernel's gaps, a decode's
cache length), the caller passes what the run's data needs; a kernel
wrapper reports what its shapes and arguments allow (the event kernels:
every lane reading ``min(capacity, n_steps)`` gaps, the most it may).

The wrappers report their calls to the counters that are active
(:func:`counting`): a wrapper call is one unit, its work the model's, and
the aten ops its plain version or its output allocation dispatch are not
counted beside it (:class:`unit`), so a count on the CPU equals one on
the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch


class DevicePeaks(NamedTuple):
    """One H100 variant's published peaks (NVIDIA data sheets), per card:
    device-memory bytes/s, FP64 and FP32 FLOP/s outside the tensor cores,
    dense bf16 FLOP/s of the tensor cores, INT32 instructions/s, dense TF32
    FLOP/s of the tensor cores (half the bf16 rate), the NVLink bandwidth
    (both directions summed), the network a card has between nodes (one
    400 Gb/s NIC a card, as in a DGX H100), and the device memory.  An SM
    issues 64 INT32 lanes a clock against 128 FP32 lanes (Hopper
    architecture white paper, the SM diagram: 16 INT32 and 32 FP32 units
    per quarter), and the FP32 peak counts a fused multiply-add as two, so
    INT32 = FP32 / 4."""

    hbm_bw: float
    f64: float
    f32: float
    bf16: float
    int32: float
    tf32: float
    nvlink_bw: float
    net_bw: float
    hbm_bytes: int


#: the peaks per H100 variant; the first six columns are the ones every
#: kernel bound reads.  ``hbm_bytes`` of the SXM card is its
#: ``torch.cuda.get_device_properties(0).total_memory`` (79.18 GiB); the
#: others are the data sheets' 80 GB and 94 GB.
PEAKS = {
    "PCIe": DevicePeaks(2.0e12, 25.6e12, 51.2e12, 756e12, 12.8e12, 378e12,
                        600e9, 50e9, 80_000_000_000),
    "NVL": DevicePeaks(3.9e12, 30.0e12, 60.0e12, 835e12, 15.0e12, 417.5e12,
                       600e9, 50e9, 94_000_000_000),
    "SXM": DevicePeaks(3.35e12, 34.0e12, 67.0e12, 989e12, 16.75e12, 494.5e12,
                       900e9, 50e9, 85_017_493_504),
}


def variant(device_name: str) -> str:
    """The :data:`PEAKS` key of a card from its name
    (``torch.cuda.get_device_name``): PCIe or NVL where the name says so,
    else SXM."""
    return next((k for k in ("PCIe", "NVL") if k in device_name), "SXM")


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do.

    ``bytes``: device-memory bytes read and written at the least.
    ``ops``: operations by kind: ``f64`` and ``f32`` FLOPs on the CUDA
    cores, ``f64_instr`` FP64 instructions (a slot each, at half the FLOP
    rate), ``int32`` instructions, ``bf16`` and ``tf32`` FLOPs on the
    tensor cores.  ``flops``: the matmul-class FLOPs of the call as the
    kernel runs it (what ``launch/cost.py`` adds to a step's FLOPs; 0 for
    the kernels without products)."""

    name: str
    bytes: int
    ops: dict
    flops: int = 0


#: kinds of ``Work.ops`` by the pipe that runs them, and each kind's rate
#: as a function of the peaks: the pipes run side by side, the kinds of one
#: pipe one after another.
_PIPES = {
    "fp64": {"f64": lambda p: p.f64, "f64_instr": lambda p: p.f64 / 2},
    "fp32": {"f32": lambda p: p.f32},
    "int32": {"int32": lambda p: p.int32},
    "tensor": {"bf16": lambda p: p.bf16, "tf32": lambda p: p.tf32},
}


def bound_ms(work: Work, peaks: DevicePeaks) -> dict:
    """The least time of ``work`` on a card of ``peaks``: the larger of its
    bytes over the memory rate and each pipe's operations over its rates.
    Returns ``{"bound_ms", "bound_by" ("bytes" or "operations"),
    "bound_unit" (bytes or the pipe), "parts_ms" (each of them)}``."""
    parts = {"bytes": work.bytes / peaks.hbm_bw * 1e3}
    for pipe, kinds in _PIPES.items():
        s = 0.0
        for kind, rate in kinds.items():
            if work.ops.get(kind):
                s += work.ops[kind] / rate(peaks)
        if s:
            parts[pipe] = s * 1e3
    top = max(parts, key=parts.get)
    return {"bound_ms": parts[top],
            "bound_by": "bytes" if top == "bytes" else "operations",
            "bound_unit": top, "parts_ms": parts}


def _item(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else int(dtype)


# ---------------------------------------------------------------------------
# the event kernel (csrc/event_sweep.cu)
# ---------------------------------------------------------------------------

#: per-lane output bytes of the event kernel: 4 f64 + 2 int32 + 2 bool.
EVENT_OUT_BYTES = 4 * 8 + 2 * 4 + 2 * 1

#: floating-point operations of the event loop's update per gap (one
#: iteration), in the compute type, counted from the source with a divide
#: as one: 26 shared by both branches plus up to 14 in the taken branch;
#: the compensated mode forms 5 increments (~16) and folds each in with a
#: 6-operation Neumaier step.  Both sources run the same update; the
#: sampled kernel adds the draw, whose INT32 and FP64 instructions per gap
#: are counted in the SASS by whoever has it (``chip_smoke.py``) and passed
#: in.
EVENT_OPS_PER_GAP = {"f64": 40, "compensated_f32": 72}


def event_sweep_work(points: int, lanes: int, gaps_read: int,
                     gaps_used: Optional[int] = None, *,
                     compensated: bool = False,
                     gap_item: Optional[int] = None) -> Work:
    """The explicit event kernel over ``points`` grid rows and ``lanes``
    (point, trial) lanes: the ``gaps_read`` schedule entries its lanes read
    (each lane its first ``min(n_failures + 1, F)``; a point stride of 0
    shares one row among the launch's rows, read once), its outputs and
    six parameters a row; ``gaps_used`` (default ``gaps_read``) updates of
    ``EVENT_OPS_PER_GAP`` operations in f64, or in f32 when compensated.
    Items are 8 bytes (f64), 4 when compensated; ``gap_item`` (default
    the same) is the schedule's, which the wrapper reads off its tensor."""
    item = 4 if compensated else 8
    gap_item = item if gap_item is None else gap_item
    used = gaps_read if gaps_used is None else gaps_used
    kind = "compensated_f32" if compensated else "f64"
    nbytes = (gaps_read * gap_item + lanes * EVENT_OUT_BYTES
              + 6 * points * item)
    ops = {"f32" if compensated else "f64": used * EVENT_OPS_PER_GAP[kind]}
    return Work("event_sweep", nbytes, ops)


def event_sweep_sampled_work(points: int, lanes: int, gaps: int, *,
                             compensated: bool = False,
                             draw_ops: Optional[tuple] = None) -> Work:
    """The sampled event kernel: outputs and, a row, six parameters, the
    process's two f64 values and the row's int64 index; ``gaps`` updates
    (as :func:`event_sweep_work`) and, when ``draw_ops`` = (INT32, FP64)
    instructions per gap of the draw is given, the draws."""
    item = 4 if compensated else 8
    nbytes = lanes * EVENT_OUT_BYTES + points * (6 * item + 2 * 8 + 8)
    kind = "compensated_f32" if compensated else "f64"
    ops = {"f32" if compensated else "f64": gaps * EVENT_OPS_PER_GAP[kind]}
    if draw_ops is not None:
        ops["int32"] = gaps * draw_ops[0]
        ops["f64_instr"] = gaps * draw_ops[1]
    return Work("event_sweep_sampled", nbytes, ops)


def event_draws_work(points: int, lanes: int, capacity: int, *,
                     draw_ops: Optional[tuple] = None) -> Work:
    """The draw-only entry: ``capacity`` f64 gaps a lane written, the row's
    two process values and index read; the draws' instructions when
    ``draw_ops`` is given."""
    gaps = lanes * capacity
    ops = {} if draw_ops is None else {"int32": gaps * draw_ops[0],
                                       "f64_instr": gaps * draw_ops[1]}
    return Work("event_draws", gaps * 8 + points * (2 * 8 + 8), ops)


# ---------------------------------------------------------------------------
# int8 quantize / dequantize (csrc/quant_blockwise.cu)
# ---------------------------------------------------------------------------

#: floating-point operations per element of quantize (abs, max, divide,
#: round, two clamps, convert) and of dequantize (convert, multiply).
QUANT_OPS = {"quantize": 7, "dequantize": 2}


def quant_work(kind: str, elements: int, groups: int) -> Work:
    """``quantize`` or ``dequantize`` over a leaf table of ``elements`` f32
    elements in ``groups`` groups of 128 lanes: the f32 side once, the
    int8 payload (padded to whole groups) and the f32 scales once."""
    return Work(f"{kind}_blockwise", 4 * elements + 132 * groups,
                {"f32": QUANT_OPS[kind] * elements})


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

#: keys per tile of both flash kernels, and query rows per block of the
#: f32 kernel and of the bf16 (wgmma) kernel.
FLASH_KEYS = 64
FLASH_ROWS = {torch.float32: 64, torch.bfloat16: 128}


def _causal_pairs(n: int, Skv: int) -> int:
    """sum over i < n of min(i + 1, Skv)."""
    m = min(n, Skv)
    return m * (m + 1) // 2 + (n - m) * Skv


def attention_pairs(mode: str, Sq: int, Skv: int, window: int = 0,
                    chunk: int = 0) -> int:
    """The (query, key) pairs the mask allows (``flash_attention.allowed``:
    row i against keys j <= i, within ``window`` for sliding, in i's chunk
    for chunked, all for bidir)."""
    if mode == "bidir":
        return Sq * Skv
    if mode == "causal":
        return _causal_pairs(Sq, Skv)
    if mode == "sliding":
        w = min(window, Skv)
        # min(i + 1, w, Skv): the causal count under a cap of w
        return _causal_pairs(Sq, w)
    if mode == "chunked":
        total = 0
        for c0 in range(0, Sq, chunk):
            c1 = min(c0 + chunk, Sq)
            # rows c0..c1-1 against keys c0..min(i, Skv - 1)
            keys = max(0, Skv - c0)
            total += _causal_pairs(c1 - c0, keys)
        return total
    raise ValueError(f"unknown mask mode {mode!r}")


def visited_pairs(mode: str, Sq: int, Skv: int, window: int, chunk: int,
                  rows: int) -> int:
    """The (query, key) pairs of the tiles the kernel visits: a block of
    ``rows`` query rows walks the keys its rows may attend
    (``flash_attention.key_range``) in tiles of ``FLASH_KEYS``, each tile
    computed whole."""
    total = 0
    for q0 in range(0, Sq, rows):
        q1 = min(q0 + rows, Sq)
        hi = Skv if mode == "bidir" else min(q1, Skv)
        lo = 0
        if mode == "sliding":
            lo = max(0, q0 - window + 1)
        elif mode == "chunked":
            lo = (q0 // chunk) * chunk
        tiles = -(-(hi - lo) // FLASH_KEYS) if hi > lo else 0
        total += (q1 - q0) * tiles * FLASH_KEYS
    return total


def flash_work(BH: int, Sq: int, Skv: int, Dh: int, dtype, mode: str,
               window: int = 0, chunk: int = 0) -> Work:
    """Flash attention over the flat-head layout: q and the output
    ``(BH, Sq, Dh)``, k and v ``(BH, Skv, Dh)`` once each; the two
    products over the pairs the mask allows (the least work; on the tensor
    cores in bf16, the CUDA cores in f32).  ``flops`` counts the tiles the
    kernel visits (:func:`visited_pairs`), which the masks' diagonals and
    band edges round up."""
    item = _item(dtype)
    dt = dtype if isinstance(dtype, torch.dtype) else torch.bfloat16
    pairs = attention_pairs(mode, Sq, Skv, window, chunk)
    visited = visited_pairs(mode, Sq, Skv, window, chunk,
                            FLASH_ROWS.get(dt, 64))
    unit = "bf16" if dt == torch.bfloat16 else "f32"
    return Work("flash_attention", item * (2 * BH * Sq * Dh + 2 * BH * Skv
                                           * Dh),
                {unit: 4 * Dh * BH * pairs}, flops=4 * Dh * BH * visited)


def decode_work(BH: int, length: int, Dh: int, dtype,
                lse: bool = False) -> Work:
    """One query against the first ``length`` cache slots: those slots of k
    and v read once, the query read and the output written (and, with
    ``lse``, one f32 log-sum-exp a row); the two products in f32 on the
    CUDA cores."""
    item = _item(dtype)
    flops = 4 * BH * length * Dh
    return Work("decode_attention", item * (2 * BH * length * Dh
                                            + 2 * BH * Dh)
                + (4 * BH if lse else 0), {"f32": flops}, flops=flops)


# ---------------------------------------------------------------------------
# the RG-LRU scan (csrc/rglru_scan.cu) and the mLSTM (csrc/mlstm_scan.cu)
# ---------------------------------------------------------------------------

def rglru_work(B: int, S: int, W: int, dtype) -> Work:
    """``h_t = a_t h_{t-1} + b_t``: a, b read and h written once in
    ``dtype``, h0 read in f32; a multiply and an add an element."""
    n = B * S * W
    return Work("rglru_scan", 3 * _item(dtype) * n + 4 * B * W,
                {"f32": 2 * n})


def mlstm_flops(BH: int, S: int, Dh: int, L: int) -> int:
    """The products the chunkwise mLSTM needs: q k^T and S v over each
    chunk's causal pairs, q C0 into every chunk but the first (C0 = 0) and
    the state update out of every chunk but the last."""
    nc = S // L
    return (4 * Dh * BH * nc * L * (L + 1) // 2
            + 4 * BH * (nc - 1) * L * Dh * Dh)


#: TF32 products the kernel runs for one f32 product (hi.hi + hi.lo +
#: lo.hi).
MLSTM_TF32_FACTOR = 3


def mlstm_work(BH: int, S: int, Dh: int, L: int, dtype=torch.float32,
               gate_dtype=None, route: str = "3xtf32") -> Work:
    """The chunkwise mLSTM: q, k, v and h ``(BH, S, Dh)`` and the two
    gates ``(BH, S)`` once each; its products (:func:`mlstm_flops`) as
    ``MLSTM_TF32_FACTOR`` TF32 products each on the tensor cores
    (``route="3xtf32"``, the kernel's) or as f32 FLOPs on the CUDA cores
    (``route="fp32"``, for comparison)."""
    item, gitem = _item(dtype), _item(gate_dtype or dtype)
    flops = mlstm_flops(BH, S, Dh, L)
    ops = ({"tf32": MLSTM_TF32_FACTOR * flops} if route == "3xtf32"
           else {"f32": flops})
    return Work("mlstm_scan", 4 * item * BH * S * Dh + 2 * gitem * BH * S,
                ops, flops=flops)


# ---------------------------------------------------------------------------
# counters: what the kernel wrappers report
# ---------------------------------------------------------------------------

_ACTIVE: list = []
_SUSPENDED = [0]


def shape_only(x: torch.Tensor) -> bool:
    """True for a tensor with no data: ``meta``, or a fake tensor under
    ``FakeTensorMode`` (whatever device it reports)."""
    if x.device.type == "meta":
        return True
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def suspended() -> bool:
    """True inside a wrapper call (:class:`unit`): a counter of aten ops
    skips what the call dispatches."""
    return _SUSPENDED[0] > 0


class counting:
    """``with counting(counter):`` makes ``counter`` active: every kernel
    wrapper call inside calls ``counter.kernel(name, work, signature)``,
    ``signature`` being ``(name, shapes, dtypes)`` of its tensors."""

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        _ACTIVE.append(self.counter)
        return self.counter

    def __exit__(self, *exc):
        _ACTIVE.remove(self.counter)
        return False


class unit:
    """One kernel wrapper call: ``with unit(name, work_fn, tensors):``.
    With a counter active it reports ``work_fn()`` and the call's
    signature, and suspends the counting of aten ops for the call's
    body; with none it costs a list check."""

    __slots__ = ("name", "work_fn", "tensors", "on")

    def __init__(self, name: str, work_fn: Callable[[], Work], tensors):
        self.name, self.work_fn, self.tensors = name, work_fn, tensors
        self.on = False

    def __enter__(self):
        if _ACTIVE:
            self.on = True
            _SUSPENDED[0] += 1
            work = self.work_fn()
            sig = (self.name,
                   tuple(tuple(t.shape) for t in self.tensors),
                   tuple(str(t.dtype) for t in self.tensors))
            for c in list(_ACTIVE):
                c.kernel(self.name, work, sig)
        return self

    def __exit__(self, *exc):
        if self.on:
            _SUSPENDED[0] -= 1
        return False

