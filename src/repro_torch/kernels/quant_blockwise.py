"""Blockwise int8 quantize/dequantize: CUDA wrappers and plain versions.

Replaces the reference's Pallas kernels
``repro/kernels/quant_blockwise.py::_quant_kernel`` and ``::_dequant_kernel``
(oracle ``repro/kernels/ref.py::quant_ref``/``dequant_ref``).  For an
``(N, D)`` f32 array, ``D % 128 == 0``, every (row, 128-lane group) gets
the absmax scale ``max(max|x| * float32(1/127), 1e-12)`` and
``q = int8(clip(round_half_even(x / scale), -127, 127))`` with NaN -> 0;
dequantization is ``float(q) * scale``.  That is the reference's result
bit for bit, its special values included: a group holding a NaN gets a
NaN scale and q = 0 everywhere, one holding +-inf an inf scale and q = 0.

* :func:`quantize_leaves` / :func:`dequantize_leaves` take a list of
  leaves and run the kernels of ``repro_torch/csrc/quant_blockwise.cu`` once
  over all of them (the checkpoint store's path): every leaf is read where
  it lies, quantized into one packed payload arena and one scales arena,
  and dequantized straight into a tensor of its own shape.  One row of the
  leaf table (:data:`TABLE_COLUMNS`, the source's ``struct Leaf``) tells
  the kernel where a leaf is and which of the launch's groups it owns.
* :func:`quantize` / :func:`dequantize` take one ``(N, D)`` array; they
  launch the same kernels with a one-row table, which (as any one-row
  table) travels in the launch's parameters rather than device memory.
* For CUDA tensors these wrappers launch the kernels on the current
  stream, or raise; they never fall back.  For CPU tensors they run the
  plain versions.  Each counts its launches in ``.launches`` (one a call,
  whatever the number of leaves); the checkpoint store calls them from its
  flush thread, so the counts are bumped under a lock.
* :func:`quantize_plain` / :func:`dequantize_plain` are the same
  arithmetic in PyTorch, and :func:`quantize_leaves_plain` /
  :func:`dequantize_leaves_plain` run them leaf by leaf through the same
  table and arenas; the kernels are held bitwise against them on the card.
  ``quantize_plain.calls`` and ``dequantize_plain.calls`` count the calls.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import threading

import torch

from . import _build

LANE_GROUP = 128

_SOURCE = "quant_blockwise.cu"
_COUNT_LOCK = threading.Lock()
#: float32(1/127): the constant XLA multiplies by in place of ``/ 127``.
_INV127 = 1.0 / 127.0
_FLOOR = 1e-12


def _bump(fn, attr: str) -> None:
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


#: the int64 columns of a leaf-table row (``struct Leaf`` in the source):
#: the leaf's f32 address (quantize's input, dequantize's output), its
#: payload and scales addresses, its element count, its row width D and its
#: first group in the launch (an exclusive prefix sum of group counts).
TABLE_COLUMNS = ("f32", "q", "s", "n", "d", "first")
_ROW = ctypes.c_int64 * len(TABLE_COLUMNS)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    for name in ("repro_quantize_leaves", "repro_dequantize_leaves"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pad_of(size: int) -> tuple:
    """(zero elements appended, row width D) for a leaf of ``size``
    elements: the reference's layout, D = 512 lanes for leaves of at least
    512 elements, else 128, zero-padded to a whole number of rows."""
    D = 512 if size >= 512 else 128
    return (-size) % D, D


def table_args(rows: list, device) -> tuple:
    """The C entries' (table, row) arguments for the leaf table ``rows``:
    one row goes by value, as a host array; more go up to ``device`` as an
    int64 tensor (pinned, so the copy does not wait for the stream), which
    is returned too, since it must live until the launch is queued."""
    if len(rows) == 1:
        return None, _ROW(*rows[0]), None
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        device, non_blocking=True)
    return table.data_ptr(), None, table


def _launch(entry: str, rows: list, n_groups: int, device,
            name: str) -> None:
    """Launch ``entry`` over the leaf table ``rows``."""
    table, row, _keep = table_args(rows, device)
    _build.launch(getattr(load_library(), entry), table, row, len(rows),
                  n_groups, device=device, name=name)


def _check(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if x.ndim != 2 or x.shape[1] % LANE_GROUP:
        raise ValueError(f"{name} must be (N, D) with D % {LANE_GROUP} == 0, "
                         f"got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} on {x.device}: cuda or cpu tensors only")


def _check_kernel_input(x: torch.Tensor, name: str, align: int) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the kernel")
    if x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned for the "
                         f"kernel's vector loads")


def quantize(x: torch.Tensor):
    """``x`` f32 ``(N, D)`` -> (int8 ``(N, D)``, f32 scales ``(N, D/128)``)
    on the device of ``x``."""
    _check(x, torch.float32, "x")
    if x.device.type == "cpu":
        return quantize_plain(x)
    _check_kernel_input(x, "x", 16)
    N, D = x.shape
    q = torch.empty((N, D), dtype=torch.int8, device=x.device)
    s = torch.empty((N, D // LANE_GROUP), dtype=torch.float32,
                    device=x.device)
    if s.numel():
        _launch("repro_quantize_leaves",
                [[x.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel(), D, 0]],
                s.numel(), x.device, "quantize")
        _bump(quantize, "launches")
    return q, s


quantize.launches = 0


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 ``q`` ``(N, D)`` and f32 scales ``(N, D/128)`` -> f32 ``(N, D)``."""
    _check_payload(q, s)
    if q.device.type == "cpu":
        return dequantize_plain(q, s)
    _check_kernel_input(q, "q", 16)
    _check_kernel_input(s, "scales", 4)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if s.numel():
        _launch("repro_dequantize_leaves",
                [[out.data_ptr(), q.data_ptr(), s.data_ptr(), q.numel(),
                  q.shape[1], 0]], s.numel(), q.device, "dequantize")
        _bump(dequantize, "launches")
    return out


dequantize.launches = 0


def _check_payload(q: torch.Tensor, s: torch.Tensor) -> None:
    _check(q, torch.int8, "q")
    if s.dtype != torch.float32 or tuple(s.shape) != (
            q.shape[0], q.shape[1] // LANE_GROUP):
        raise ValueError(f"scales must be float32 of shape "
                         f"{(q.shape[0], q.shape[1] // LANE_GROUP)}, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if s.device != q.device:
        raise ValueError(f"scales on {s.device}, q on {q.device}")


def _one_device(ts: list, name: str) -> torch.device:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name} must lie on one device, got {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} on {dev}: cuda or cpu tensors only")
    return dev


def _quantize_table(xs: list, device):
    """The packed arenas of ``xs`` (flat f32 leaves), the leaf table's rows
    and each leaf's (payload, scales, pad) views into the arenas.  A leaf's
    payload starts at 128 bytes times its first group, so 16-byte
    aligned."""
    layout = [pad_of(x.numel()) for x in xs]
    groups = [(x.numel() + pad) // LANE_GROUP for x, (pad, _) in zip(xs,
                                                                     layout)]
    firsts = [0, *itertools.accumulate(groups)]
    q = torch.empty(firsts[-1] * LANE_GROUP, dtype=torch.int8, device=device)
    s = torch.empty(firsts[-1], dtype=torch.float32, device=device)
    rows = [[x.data_ptr(), q.data_ptr() + LANE_GROUP * f,
             s.data_ptr() + 4 * f, x.numel(), D, f]
            for x, (_, D), f in zip(xs, layout, firsts)]
    views = [(lq.view(-1, D), ls.view(-1, D // LANE_GROUP), pad)
             for lq, ls, (pad, D) in zip(
                 q.split([LANE_GROUP * g for g in groups]), s.split(groups),
                 layout)]
    return q, s, rows, views


def _flat_leaves(xs) -> tuple:
    xs = [x.reshape(-1) for x in xs]
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"leaves must be float32, got {x.dtype}")
    return xs, (_one_device(xs, "leaves") if xs else torch.device("cpu"))


def quantize_leaves(xs: list):
    """Quantize f32 tensors of any shapes, on one device, in one launch.

    Returns ``(q, s, leaves)``: the packed int8 payload arena, the packed
    f32 scales arena and, per leaf, ``(payload, scales, pad)`` views into
    them, shaped as the reference's ``quantize_array`` gives them:
    ``((n + pad) / D, D)`` and ``((n + pad) / D, D / 128)``."""
    xs, dev = _flat_leaves(xs)
    if dev.type == "cpu":
        return quantize_leaves_plain(xs)
    xs = [_build.aligned(x) for x in xs]   # the kernel bulk-copies 16 B
    q, s, rows, views = _quantize_table(xs, dev)
    if s.numel():
        _launch("repro_quantize_leaves", rows, s.numel(), dev,
                "quantize_leaves")
        _bump(quantize_leaves, "launches")
    return q, s, views


quantize_leaves.launches = 0


def quantize_leaves_plain(xs: list):
    """:func:`quantize_leaves` through :func:`quantize_plain`, leaf by leaf,
    into the arena slices that the leaf table names (any device)."""
    xs, dev = _flat_leaves(xs)
    q, s, rows, views = _quantize_table(xs, dev)
    for x, (_, qa, sa, n, D, _) in zip(xs, rows):
        x2 = torch.cat([x, x.new_zeros((-n) % D)]).view(-1, D)
        lq, ls = quantize_plain(x2)
        qo, so = qa - q.data_ptr(), (sa - s.data_ptr()) // 4
        q[qo:qo + lq.numel()] = lq.view(-1)
        s[so:so + ls.numel()] = ls.view(-1)
    return q, s, views


def _dequantize_table(qs: list, ss: list, shapes, pads):
    """Checked payloads, the f32 outputs in the leaves' shapes and the leaf
    table's rows."""
    if not len(qs) == len(ss) == len(shapes) == len(pads):
        raise ValueError("qs, ss, shapes and pads must have one entry a "
                         "leaf")
    for q, s in zip(qs, ss):
        _check_payload(q, s)
    dev = _one_device(qs, "payloads") if qs else torch.device("cpu")
    if dev.type == "cuda":
        qs = [_build.aligned(q) for q in qs]   # bulk-copied, 16 B
        ss = [s.contiguous() for s in ss]
    outs, rows, first = [], [], 0
    for q, s, shape, pad in zip(qs, ss, shapes, pads):
        out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
        if not 0 <= pad < q.shape[1] or out.numel() + pad != q.numel():
            raise ValueError(f"a payload of {tuple(q.shape)} does not hold "
                             f"{tuple(shape)} with pad {pad}")
        rows.append([out.data_ptr(), q.data_ptr(), s.data_ptr(), out.numel(),
                     q.shape[1], first])
        outs.append(out)
        first += s.numel()
    return qs, ss, outs, rows, first


def dequantize_leaves(qs: list, ss: list, shapes, pads) -> list:
    """Dequantize many payloads (int8 ``(rows, D)`` and f32 scales
    ``(rows, D/128)`` each, as :func:`quantize_leaves` gives them) in one
    launch; returns one f32 tensor a leaf, of its ``shape``, its ``pad``
    trailing elements cut."""
    qs, ss, outs, rows, n_groups = _dequantize_table(qs, ss, shapes, pads)
    if rows and qs[0].device.type == "cpu":
        return _dequantize_rows_plain(qs, ss, outs, rows)
    if n_groups:
        _launch("repro_dequantize_leaves", rows, n_groups, qs[0].device,
                "dequantize_leaves")
        _bump(dequantize_leaves, "launches")
    return outs


dequantize_leaves.launches = 0


def dequantize_leaves_plain(qs: list, ss: list, shapes, pads) -> list:
    """:func:`dequantize_leaves` through :func:`dequantize_plain`, leaf by
    leaf, cut as the leaf table says (any device)."""
    return _dequantize_rows_plain(*_dequantize_table(qs, ss, shapes,
                                                     pads)[:4])


def _dequantize_rows_plain(qs, ss, outs, rows) -> list:
    for q, s, out, (_, _, _, n, D, _) in zip(qs, ss, outs, rows):
        out.view(-1).copy_(dequantize_plain(q.view(-1, D), s).view(-1)[:n])
    return outs


def quantize_plain(x: torch.Tensor):
    """The quantize kernel's arithmetic in PyTorch (any device)."""
    _bump(quantize_plain, "calls")
    _check(x, torch.float32, "x")
    N, D = x.shape
    xb = x.reshape(N, D // LANE_GROUP, LANE_GROUP)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    scale = torch.maximum(xb.abs().amax(-1) * f32(_INV127), f32(_FLOOR))
    r = torch.round(xb / scale[..., None])
    r = torch.where(torch.isnan(r), f32(0.0), r).clamp(-127.0, 127.0)
    return r.to(torch.int8).reshape(N, D), scale


quantize_plain.calls = 0


def dequantize_plain(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The dequantize kernel's arithmetic in PyTorch (any device)."""
    _bump(dequantize_plain, "calls")
    N, D = q.shape
    qb = q.reshape(N, D // LANE_GROUP, LANE_GROUP).to(torch.float32)
    return (qb * s[..., None]).reshape(N, D)


dequantize_plain.calls = 0
