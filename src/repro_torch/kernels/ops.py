"""Public wrappers around the kernels: model layouts and padding.

Counterpart of the reference's ``repro/kernels/ops.py``.  Each runs on the
device of its input: the kernel on CUDA, its plain version on the CPU.

* :func:`flash_attention` takes the model layout ``(B, S, H, Dh)`` to the
  kernel's flat-head ``(B*H, S, Dh)`` and back, and
  :func:`decode_attention` a query ``(B, 1, H, Dh)`` against a cache
  ``(B, Sc, H, Dh)``; :func:`mlstm_scan` folds
  ``(B, H, S, Dh)`` and ``(B, H, S)`` gates to ``B*H`` rows;
  :func:`rglru_scan` takes the kernel's own layout ``(B, S, W)``, which
  is the model's.  Attention and the RG-LRU scan go through their
  ``autograd.Function`` (``flash_attention.FlashAttention``,
  ``rglru_scan.RGLRUScan``), so they have a gradient on either device;
  :func:`mlstm_scan_trainable` is the mLSTM with a gradient
  (``mlstm_scan.MLSTMScan``), the models' path.  :func:`flash_attention`,
  :func:`rglru_scan` and the mLSTM also take DTensors (a sharded train
  step): they run the same code on each rank's local shard
  (``parallel/sharding.py::on_local_shards``), batch and heads (or the
  LRU width) split, and raise for a split sequence or head vector;
  :func:`decode_attention` runs on each rank's slots of a cache split
  along them and merges the pieces across ranks.
  The TPU tiling arguments of the
  reference (``qb``, ``kb``, ``bb``, ``sb``, ``wb``) have no counterpart.
* :func:`quantize_array` and :func:`dequantize_array` take arrays of any
  shape to the quantize kernel's ``(rows, D)`` layout and back, with the
  reference's padding (``D`` = 512 lanes for arrays of at least 512
  elements, else 128, zero-padded to a whole number of rows), so the
  payloads they produce are the reference's, shape for shape.
  :func:`quantize_arrays` and :func:`dequantize_arrays` do the same for a
  list of arrays in one kernel launch, leaf for leaf equal to them.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import (constrain, is_dtensor, on_local_shards,
                                 on_local_slots)
from . import decode_attention as _da
from . import flash_attention as _fa
from . import mlstm_scan as _ml
from . import rglru_scan as _rg
from .quant_blockwise import (dequantize, dequantize_leaves, quantize,
                              quantize_leaves)
from .quant_blockwise import pad_of as _pad_of


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal", window: int = 0,
                    chunk: int = 0) -> torch.Tensor:
    """Attention in the model layout: q (B, S, H, Dh), k/v (B, Skv, H, Dh);
    returns (B, S, H, Dh), with a gradient (``FlashAttention``).  On
    DTensors the kernel runs on each rank's (B / data, S, H / model, Dh)
    shard."""
    def local(q, k, v):
        B, S, H, Dh = q.shape
        fold = lambda t: t.transpose(1, 2).reshape(B * H, t.shape[1], Dh)
        out = _fa.FlashAttention.apply(fold(q), fold(k), fold(v), mode,
                                       window, chunk)
        return out.reshape(B, H, S, Dh).transpose(1, 2)
    axes = ("batch", "seq", "heads", "head_dim")
    return on_local_shards(local, (q, k, v), (axes,) * 3, "flash_attention")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """The RG-LRU scan ``h_t = a_t h_{t-1} + b_t`` in the model layout
    ``(B, S, W)`` from ``h0`` ``(B, W)``, with a gradient (``RGLRUScan``).
    On DTensors the kernel runs on each rank's (B / data, S, W / model)
    shard."""
    axes = ("batch", "seq", "lru")
    return on_local_shards(_rg.RGLRUScan.apply, (a, b, h0),
                           (axes, axes, ("batch", "lru")), "rglru_scan")


def decode_attention(q1: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """One query token against a KV cache in the model layout: q1
    (B, 1, H, Dh), k/v (B, Sc, H, Dh) (already expanded to the q heads);
    ``length`` (a host int) leading cache slots are attended.  Returns
    (B, 1, H, Dh).  A cache laid out head-major in memory (what
    ``models/attention.py::expand_kv`` makes) folds without a copy.  On a
    DTensor cache the kernel runs on each rank's local slots (and batch and
    heads, as they are split), returning its log-sum-exp, and the pieces
    merge across the ranks that split the slots
    (``parallel/sharding.py::on_local_slots``, ``merge_across``); the
    output leaves under the reference's ``("batch", "seq", "heads",
    "head_dim")``."""
    def local(q1, k, v, length, return_lse=True):
        B, _, H, Dh = q1.shape
        fold = lambda t: t.transpose(1, 2).reshape(B * H, t.shape[1], Dh)
        got = _da.decode_attention(fold(q1), fold(k), fold(v), length,
                                   return_lse=return_lse)
        unfold = lambda o: o.reshape(B, H, 1, Dh).transpose(1, 2)
        if not return_lse:
            return unfold(got)
        return unfold(got[0]), got[1].reshape(B, 1, H)

    if not any(is_dtensor(t) for t in (q1, k, v)):
        return local(q1, k, v, length, return_lse=False)
    out = on_local_slots(local, q1, k, v, length, _da.merge_across,
                         "decode_attention")
    return constrain(out, ("batch", "seq", "heads", "head_dim"))


#: the mLSTM's layouts: q, k, v, then the two gates.
_MLSTM_AXES = ((("batch", "heads", "seq", "head_dim"),) * 3
               + (("batch", "heads", "seq"),) * 2)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               li: torch.Tensor, lf: torch.Tensor, *,
               chunk: int = 256) -> torch.Tensor:
    """The mLSTM in the model layout: q/k/v (B, H, S, Dh), li/lf
    (B, H, S); returns (B, H, S, Dh).  On DTensors the kernel runs on each
    rank's (B / data, H / model) shard."""
    def local(q, k, v, li, lf):
        B, H, S, Dh = q.shape
        fold = lambda t: t.reshape(B * H, S, Dh)
        fold2 = lambda t: t.reshape(B * H, S)
        out = _ml.mlstm_scan(fold(q), fold(k), fold(v), fold2(li),
                             fold2(lf), chunk=chunk)
        return out.reshape(B, H, S, Dh)
    return on_local_shards(local, (q, k, v, li, lf), _MLSTM_AXES,
                           "mlstm_scan")


def mlstm_scan_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         li: torch.Tensor, lf: torch.Tensor, *,
                         chunk: int = 256):
    """The mLSTM from zero state with a gradient, in the model layout: q/k/v
    (B, H, S, Dh), li/lf (B, H, S), f32.  Returns ``(h, (C, n, m))``: h
    (B, H, S, Dh) and the last chunk's starting state (no gradient flows
    through it), from which one ``_mlstm_chunk`` gives the final state.
    On DTensors the kernel runs on each rank's (B / data, H / model)
    shard, and all four come back split so."""
    h, C, n, m = on_local_shards(
        lambda *a: _ml.MLSTMScan.apply(*a, chunk), (q, k, v, li, lf),
        _MLSTM_AXES, "mlstm_scan", n_out=4)
    return h, (C, n, m)


def quantize_array(x: torch.Tensor):
    """Quantize an f32 tensor of any shape; returns (int8 2-D payload,
    f32 scales, pad)."""
    pad, D = _pad_of(x.numel())
    flat = x.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    elif flat.data_ptr() % 16:          # the kernel loads float4s
        flat = flat.clone()
    q, s = quantize(flat.reshape(-1, D))
    return q, s, pad


def dequantize_array(q: torch.Tensor, s: torch.Tensor, *, shape, dtype,
                     pad: int) -> torch.Tensor:
    """Inverse layout of :func:`quantize_array`: an array of ``shape`` and
    ``dtype`` (a torch dtype or its name, e.g. ``"float32"``)."""
    flat = dequantize(q, s).reshape(-1)
    if pad:
        flat = flat[:-pad]
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return flat.reshape(tuple(shape)).to(dtype)


def quantize_arrays(xs: list):
    """Quantize f32 tensors of any shapes in one launch; returns (int8
    payload arena, f32 scales arena, [(payload, scales, pad)] a leaf), the
    per-leaf triples equal to :func:`quantize_array`'s and views into the
    two arenas, so that a caller can move all payloads in two copies."""
    return quantize_leaves(xs)


def dequantize_arrays(qs: list, ss: list, *, shapes, dtypes,
                      pads) -> list:
    """Inverse of :func:`quantize_arrays` in one launch: one array a leaf,
    equal to :func:`dequantize_array` on that leaf's arguments."""
    outs = dequantize_leaves(qs, ss, shapes, pads)
    return [x.to(getattr(torch, d) if isinstance(d, str) else d)
            for x, d in zip(outs, dtypes)]
