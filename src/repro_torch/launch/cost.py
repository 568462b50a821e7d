"""Cost of a step, counted from the ops it dispatches.

Counterpart of the reference's ``repro/launch/hlo_cost.py``.  The
reference walks the optimized HLO text of a compiled program; the port
compiles nothing, so that parser has no counterpart here.  Instead
:func:`analyze` runs the function once (on real tensors, on ``meta``
tensors for shapes alone, or on fake ones) under a dispatch mode that
sees every aten op, and each kernel wrapper reports itself as one unit of
work (``kernels/cost.py``):

  * ``flops``     -- matmul-class FLOPs: each aten op that
                     ``torch.utils.flop_counter`` has a formula for (mm,
                     bmm, addmm, baddbmm, convolutions, SDPA), plus each
                     kernel call's ``Work.flops`` (flash attention counts
                     the tiles it visits, the mLSTM its products, decode
                     its two products); elementwise ops count none, as in
                     the reference;
  * ``hbm_bytes`` -- operand and result bytes of every aten op that is not
                     a view, with each kernel call counted as one op of its
                     model's bytes.  This is the reference's "fusions as
                     single ops" heuristic (``hlo_cost.py:9-11``) with no
                     fusion at all: every eager op reads its inputs and
                     writes its outputs, and nothing is reused from cache,
                     so it is an UPPER bound of the traffic;
  * ``coll_bytes`` / ``coll_counts`` -- by collective kind: the functional
                     collectives that ops on DTensors dispatch (bytes from
                     their results; counts also read by
                     ``torch.distributed.tensor.debug.CommDebugMode``), and
                     what :func:`grad_reduction` models for a train step.

``CostVec`` adds and scales as the reference's does; it also keeps
``ops`` (the kernels' typed operations, ``kernels/cost.py``), ``kernels``
(calls by wrapper) and ``modelled`` (which collectives were modelled
rather than seen).  The port's models do not run on DTensors yet, so a
step's tensor-parallel activation collectives are not seen: they wait for
sharded execution (ROADMAP A12).
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import cost as kcost

#: aten ops that move no data: allocations without a write, metadata.
_FREE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_local_scalar_dense", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_has_compatible_shallow_copy_type", "set_", "record_stream",
})
#: elementwise aten ops counted as transcendental, an output element each.
_TRANSCENDENTAL = frozenset({
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2",
    "tanh", "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
    "logsumexp", "softplus", "gelu", "silu", "_softmax", "_log_softmax",
})


@dataclasses.dataclass
class CostVec:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Optional[Counter] = None
    coll_counts: Optional[Counter] = None
    ops: Optional[Counter] = None
    kernels: Optional[Counter] = None
    modelled: Optional[dict] = None

    def __post_init__(self):
        self.coll_bytes = self.coll_bytes or Counter()
        self.coll_counts = self.coll_counts or Counter()
        self.ops = self.ops or Counter()
        self.kernels = self.kernels or Counter()
        self.modelled = self.modelled or {}

    def __iadd__(self, other: "CostVec"):
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        self.coll_bytes.update(other.coll_bytes)
        self.coll_counts.update(other.coll_counts)
        self.ops.update(other.ops)
        self.kernels.update(other.kernels)
        self.modelled.update(other.modelled)
        return self

    def scaled(self, k: float) -> "CostVec":
        sc = lambda c: Counter({a: b * k for a, b in c.items()})
        return CostVec(self.flops * k, self.hbm_bytes * k,
                       sc(self.coll_bytes), sc(self.coll_counts),
                       sc(self.ops), sc(self.kernels), dict(self.modelled))


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Adds every dispatched aten op's FLOPs and bytes to ``self.cost``;
    the kernel wrappers report to :meth:`kernel` (``kernels/cost.py``),
    and the ops they dispatch themselves are skipped."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.cost = CostVec()

    def kernel(self, name: str, work: kcost.Work, sig) -> None:
        self.cost.flops += work.flops
        self.cost.hbm_bytes += work.bytes
        self.cost.ops.update(work.ops)
        self.cost.kernels[name] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if kcost.suspended():
            return out
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns in ("_c10d_functional", "c10d_functional", "c10d"):
            kind = name.rstrip("_").replace("_into_tensor_coalesced", "") \
                .replace("_coalesced", "").replace("_", "-")
            if not kind.startswith("wait"):
                self.cost.coll_bytes[kind] += _bytes(out)
                self.cost.coll_counts[kind] += 1
            return out
        if func.is_view or name in _FREE:
            return out
        packet = func.overloadpacket
        if name in _TRANSCENDENTAL:
            self.cost.ops["transcendental"] += sum(
                t.numel() for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor))
        if packet in self.registry:
            self.cost.flops += self.registry[packet](*args, **kwargs,
                                                     out_val=out)
        self.cost.hbm_bytes += _bytes(args) + _bytes(kwargs) + _bytes(out)
        return out


def analyze(fn, *args, **kwargs) -> CostVec:
    """Run ``fn(*args, **kwargs)`` once and return its :class:`CostVec`
    (the result is dropped).  When an argument is a DTensor, its
    collectives are also counted by ``CommDebugMode``; where its counts
    exceed what the dispatch mode saw, they are kept.  (The mode is not
    entered otherwise: it costs a module-tracking step an op.)"""
    mode = CostMode()
    comm = _comm_mode((args, kwargs))
    with kcost.counting(mode), comm, mode:
        fn(*args, **kwargs)
    if hasattr(comm, "get_comm_counts"):
        for op, n in comm.get_comm_counts().items():
            kind = getattr(op, "__name__", str(op)).rstrip("_") \
                .replace("_", "-")
            mode.cost.coll_counts[kind] = max(mode.cost.coll_counts[kind], n)
    return mode.cost


def _comm_mode(args):
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    if not any(isinstance(x, DTensor) for x in tree_flatten(args)[0]):
        return contextlib.nullcontext()
    from torch.distributed.tensor.debug import CommDebugMode
    return CommDebugMode()


def grad_reduction(abstract_params, grad_dtype=None) -> CostVec:
    """The gradient reduction of a data-parallel train step, modelled from
    each parameter leaf's sharding: a leaf (a DTensor stand-in,
    ``models.spec.abstract_tree`` on a mesh) that is replicated over mesh
    axes of more than one rank all-reduces its local gradient (its local
    shard's elements in ``grad_dtype``, default the leaf's) over them.
    Leaves that are plain tensors (no mesh) reduce nothing."""
    from torch.distributed.tensor import DTensor, Replicate
    out = CostVec(modelled={"all-reduce": "gradient reduction modelled "
                            "from each leaf's sharding (local gradient "
                            "bytes over the axes it is replicated on)"})
    for x in tree_flatten(abstract_params)[0]:
        if not isinstance(x, DTensor):
            continue
        mesh = x.device_mesh
        over = [d for d, p in enumerate(x.placements)
                if isinstance(p, Replicate) and mesh.size(d) > 1]
        if not over:
            continue
        item = torch.empty((), dtype=grad_dtype or x.dtype).element_size()
        out.coll_bytes["all-reduce"] += x.to_local().numel() * item
        out.coll_counts["all-reduce"] += 1
    return out
