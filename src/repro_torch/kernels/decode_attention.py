"""Flash-decoding: one query token against a KV cache.  CUDA wrapper and
plain PyTorch version.

Replaces the reference's Pallas kernel
``repro/kernels/decode_attention.py::_decode_kernel`` (oracle
``repro/kernels/ref.py::decode_ref``).  ``q1``: ``(BH, 1, Dh)``; cache
``k``, ``v``: ``(BH, S, Dh)``; ``length``: the number of valid cache
slots (slots at or past it are masked; ring buffers are resolved by the
caller).  f32 math, q scaled by ``float32(Dh ** -0.5)``, the sum of
weights floored at 1e-30, so ``length = 0`` gives zeros.  Output
``(BH, 1, Dh)`` in ``q1``'s dtype; with ``return_lse`` also each row's
log-sum-exp of the scaled scores, ``(BH,)`` f32 (``NEG_INF`` for a row
with no slot), by which :func:`merge_partials` joins the outputs of
disjoint slot ranges (a cache split across ranks) into the whole softmax.

* :func:`decode_attention` is the wrapper.  For CUDA tensors it launches
  the kernel of ``repro_torch/csrc/decode_attention.cu`` on the current
  stream, or raises; for CPU tensors it runs
  :func:`decode_attention_plain`.  ``decode_attention.launches`` counts
  kernel launches.
* :func:`decode_attention_plain` computes the same function with the
  scores materialized.  The kernel is held to it within 1e-4 in f32 (the
  reference's tolerance) and 4e-3 + 1e-2 relative in bf16 (one rounding
  of the output apart): its sums run in another order.  ``.calls``
  counts its calls.
* :func:`merge_partials` is plain PyTorch: a few elementwise ops a row;
  :func:`merge_across` is the same merge over ranks, by collectives.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, cost

NEG_INF = -1.0e30
DTYPES = (torch.float32, torch.bfloat16)
#: head widths the kernel is compiled for.
HEAD_DIMS = (64, 128, 256)

_SOURCE = "decode_attention.cu"


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    fn = lib.repro_decode_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int64] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q1, k, v) -> None:
    if k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"k and v must both be (BH, S, Dh), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    BH, _, Dh = k.shape
    if q1.shape != (BH, 1, Dh):
        raise ValueError(f"q1 must be {(BH, 1, Dh)}, got {tuple(q1.shape)}")
    if q1.dtype not in DTYPES or not (q1.dtype == k.dtype == v.dtype):
        raise TypeError(f"q1, k, v must share a dtype among {DTYPES}")
    if not (q1.device == k.device == v.device):
        raise ValueError("q1, k and v must lie on one device")
    if q1.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode_attention runs on cuda or cpu tensors (or "
                         f"meta ones, for shapes), not {q1.device}")


def decode_attention(q1: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, return_lse: bool = False):
    """Attention of ``q1`` over the first ``length`` slots of the cache
    (``length``: an int or a 0-d integer tensor); with ``return_lse``,
    ``(out, lse)``."""
    _check(q1, k, v)
    length = int(length)
    BH, S, Dh = k.shape
    work = lambda: cost.decode_work(BH, min(max(length, 0), S), Dh, k.dtype,
                                    lse=return_lse)
    with cost.unit("decode_attention", work, (q1, k, v)):
        if cost.shape_only(q1):
            out = torch.empty_like(q1)
            lse = torch.empty((BH,), dtype=torch.float32, device=q1.device)
            return (out, lse) if return_lse else out
        if q1.device.type == "cpu":
            return decode_attention_plain(q1, k, v, length, return_lse)
        return _kernel(q1, k, v, length, return_lse)


def _kernel(q1, k, v, length: int, return_lse: bool = False):
    """Allocate the output (and the log-sum-exp) and launch the kernel on
    the inputs' device."""
    BH, S, Dh = k.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes Dh in {HEAD_DIMS}, got {Dh}")
    q1, k, v = (_build.aligned(x) for x in (q1, k, v))
    out = torch.empty_like(q1)
    lse = (torch.empty((BH,), dtype=torch.float32, device=q1.device)
           if return_lse else None)
    _build.launch(load_library().repro_decode_attention,
                  int(q1.dtype == torch.bfloat16), q1.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), BH, S, Dh,
                  min(max(length, 0), S), Dh ** -0.5, device=q1.device,
                  name="decode_attention")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0


def decode_attention_plain(q1: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length, return_lse: bool = False):
    """The kernel's function in PyTorch (any device), scores materialized;
    with ``return_lse``, ``(out, lse)``."""
    decode_attention_plain.calls += 1
    _check(q1, k, v)
    f32 = torch.float32
    Dh = k.shape[2]
    scale = torch.tensor(Dh ** -0.5, dtype=f32).to(q1.device)
    s = torch.matmul(q1.to(f32) * scale, k.to(f32).transpose(1, 2))
    allow = torch.arange(k.shape[1], device=k.device) < int(length)
    s = torch.where(allow, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(allow, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = (torch.matmul(p, v.to(f32)) / torch.clamp_min(l, 1e-30)).to(
        q1.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), NEG_INF)
    return out, lse.reshape(-1)


decode_attention_plain.calls = 0


def _merge(out, lse, reduce):
    """The formula of :func:`merge_partials`; ``reduce(x, op)`` reduces
    ``x`` over the pieces (``op`` ``"max"`` or ``"sum"``).  ``lse`` holds
    one value an output row (``out``'s shape but its last dim)."""
    lse = lse.reshape(out.shape[:-1])
    top = reduce(lse, "max")
    w = torch.exp(lse - top)
    both = reduce(torch.cat([w[..., None] * out.to(torch.float32),
                             w[..., None]], -1), "sum")
    some = top > NEG_INF
    merged = torch.where(some[..., None], both[..., :-1] / both[..., -1:],
                         0.0)
    return (merged.to(out.dtype),
            torch.where(some, top + torch.log(both[..., -1]), NEG_INF))


def merge_partials(outs, lses):
    """The whole softmax from the normalised outputs ``outs`` (each
    ``(..., Dh)``) and log-sum-exps ``lses`` (each ``(...)`` f32) of
    disjoint slot ranges: ``L = logsumexp_r lse_r`` and ``out = sum_r
    exp(lse_r - L) out_r``, in f32 and rounded once to the outputs' dtype.
    A range at ``NEG_INF`` (no slot) weighs 0; with every range there the
    output is zeros, as the kernel's at length 0.  Returns ``(out, L)``,
    ``L`` shaped as each of ``lses``."""
    out, L = _merge(torch.stack(list(outs)), torch.stack(list(lses)),
                    lambda x, op: x.amax(0) if op == "max" else x.sum(0))
    return out, L.reshape(lses[0].shape)


def merge_across(out, lse, groups):
    """:func:`merge_partials` of the pieces that the ranks of ``groups``
    (``(DeviceMesh, mesh dim)`` pairs, or process groups) hold, one
    ``(out, lse)`` a rank: an all-reduce (max) of the log-sum-exps, then
    one all-reduce (sum) of the weighted outputs and their weights.  No
    value is read on the host.  Returns the merged output."""
    import torch.distributed._functional_collectives as funcol

    def reduce(x, op):
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, g))
        return x
    return _merge(out, lse, reduce)[0]
