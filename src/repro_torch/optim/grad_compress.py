"""Int8 blockwise gradient compression with error feedback.

Counterpart of the reference's ``repro/optim/grad_compress.py``.  Each leaf
of at least 1024 elements goes through the int8 wire format of the
``quant_blockwise`` kernels (absmax per 128-lane group); the quantization
error is kept in a per-leaf error-feedback buffer and added to the next
step's gradient, so compression noise is delayed, not lost.  Smaller
leaves ride uncompressed.  Where the reference quantizes leaf by leaf,
the port makes one quantize and one dequantize launch over all the large
leaves (``ops.quantize_arrays`` / ``ops.dequantize_arrays``, the leaf
table), each leaf bitwise what the one-leaf wrappers give.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..ckpt.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..kernels import ops as kops

#: leaves with fewer elements are sent as f32 (no wire bytes counted, as in
#: the reference).
MIN_COMPRESSED = 1024


class CompressState(NamedTuple):
    error: object          # tree like grads (f32 residuals)


def init_state(grads_like, device="cuda") -> CompressState:
    dev = resolve_device(device)
    return CompressState(error=tree_map(
        lambda g: torch.zeros(tuple(g.shape), dtype=torch.float32,
                              device=dev), grads_like))


@torch.no_grad()
def compress_grads(grads, state: CompressState):
    """Returns (the grads as the receiver sees them, the new state, stats
    ``{"wire_bytes", "raw_bytes", "ratio"}``)."""
    leaves, treedef = tree_flatten(grads)
    targets = [g.to(torch.float32) + e                # error feedback
               for g, e in zip(leaves, tree_leaves(state.error))]
    big = [i for i, t in enumerate(targets) if t.numel() >= MIN_COMPRESSED]
    backs = list(targets)                  # small leaves: the f32 target
    wire_bytes = 0
    if big:
        _, _, payloads = kops.quantize_arrays([targets[i] for i in big])
        outs = kops.dequantize_arrays(
            [q for q, _, _ in payloads], [s for _, s, _ in payloads],
            shapes=[targets[i].shape for i in big],
            dtypes=["float32"] * len(big), pads=[p for _, _, p in payloads])
        for i, out, (q, s, _) in zip(big, outs, payloads):
            backs[i] = out
            wire_bytes += q.numel() * q.element_size() \
                + s.numel() * s.element_size()
    raw_bytes = sum(t.numel() * 4 for t in targets)
    out = [b.to(g.dtype) for b, g in zip(backs, leaves)]
    new_err = [t - b for t, b in zip(targets, backs)]  # residual for next
    stats = {"wire_bytes": wire_bytes, "raw_bytes": raw_bytes,
             "ratio": wire_bytes / max(raw_bytes, 1)}
    return (tree_unflatten(treedef, out),
            CompressState(error=tree_unflatten(treedef, new_err)), stats)
