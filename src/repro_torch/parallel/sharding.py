"""Logical-axis sharding: MaxText-style rules mapping logical tensor axes to
mesh axes, with divisibility-aware resolution, on ``torch.distributed``
device meshes.

Counterpart of the reference's ``repro/parallel/sharding.py``.

Mesh axes (``launch/mesh.py``):
  single-pod : ("data", "model")           = (16, 16)   -> 256 ranks
  multi-pod  : ("pod", "data", "model")    = (2, 16, 16) -> 512 ranks

Parallelism mapping:
  DP   : batch over ("pod", "data")
  FSDP : weight "embed" axis over "data" (fully-sharded params and
         optimizer state)
  TP   : heads / mlp / vocab over "model"
  EP   : experts over "model"
  SP   : long-context sequence over "data" when batch == 1; attention
         batch-split over ("data", "model") when heads don't divide "model"

A resolved spec is a :class:`PartitionSpec`: one entry per tensor dim
(``None``, a mesh axis name, or a tuple of names), trailing ``None``\\ s
dropped.  Resolution drops any mesh axis that does not divide the
dimension, as the reference does (JAX rejects uneven shardings; DTensor
would pad them).  :func:`placements` turns a spec into DTensor
placements, one per mesh dim.  A tensor dim over several mesh axes
(``batch`` -> ``("pod", "data")``) becomes ``Shard(i)`` on each of them;
DTensor shards over mesh dims left to right, which is JAX's major-to-minor
layout when the spec's axes come in the mesh's order, as every tuple of
:data:`DEFAULT_RULES` does (a spec out of that order raises).

Model code never receives a mesh argument: a launcher installs the active
mesh with :func:`set_active_mesh` (or :class:`use_mesh`), thread-locally,
and :func:`constrain` reads it.  The models call :func:`constrain` at the
reference's points, so that a train step whose parameters and batch are
DTensors (:func:`place_tree`, the reference's ``jax.device_put``) runs
sharded: DTensor's own rules propagate the placements between those
points, and a fresh tensor that meets a DTensor enters as a replicated
one (:func:`replicated`, :func:`sharded_full`).  The kernels run on each
rank's local shard (:func:`on_local_shards`; decode on each rank's slots
of the KV cache, merged across ranks: :func:`on_local_slots`), the
embedding lookup on each rank's rows of the table (:func:`embedding`),
and decode writes its cache in place on the rank that holds the slot
(:func:`set_index`).  Without an active mesh every one of these is the
identity.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with mesh
dim names, or any mapping ``{axis name: size}`` in mesh order (what a
resolution needs, with no process group behind it).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections.abc import Mapping
from typing import Optional, Sequence

import torch

from ..ckpt.tree import tree_flatten, tree_map, tree_unflatten

# Each logical axis maps to a mesh axis (or tuple of axes, or None).
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "batch_split": ("pod", "data", "model"),  # attention batch-split fallback
    "seq": None,
    "seq_sp": ("data",),        # sequence-parallel (long-context, batch==1)
    "kv_seq": None,             # decode KV cache sequence (un-sharded default)
    "kv_seq_mp": ("model",),    # decode KV cache sharded over model (flash-decode)
    "embed": ("data",),         # FSDP axis on parameters
    "act_embed": None,          # activations' d_model stays unsharded
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": None,
    "layers": None,
    "lru": ("model",),
    "lru_blocks": ("model",),
    "conv": None,
    "stack": None,
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim split over those axes, major first);
    trailing ``None``\\ s are dropped by :func:`resolve_pspec`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh`` in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if mesh.mesh_dim_names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to take "
                         "logical shardings")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class _MeshState(threading.local):
    mesh = None
    rules: Optional[dict] = None


_STATE = _MeshState()


def set_active_mesh(mesh, rules: Optional[dict] = None):
    """Install the mesh :func:`constrain` reads (launchers, this thread)."""
    _STATE.mesh = mesh
    _STATE.rules = rules


def active_mesh():
    return getattr(_STATE, "mesh", None)


def active_rules() -> dict:
    return getattr(_STATE, "rules", None) or DEFAULT_RULES


class use_mesh:
    """Context manager: :func:`set_active_mesh` plus ``with mesh:`` (a
    DeviceMesh's own current-mesh context); the mesh active before comes
    back on exit."""

    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        self.before = (active_mesh(), getattr(_STATE, "rules", None))
        set_active_mesh(self.mesh, self.rules)
        self.mesh.__enter__()
        return self.mesh

    def __exit__(self, *exc):
        set_active_mesh(*self.before)
        return self.mesh.__exit__(*exc)


def resolve_pspec(logical: Sequence[Optional[str]], mesh,
                  rules: Optional[dict] = None,
                  shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Map logical axis names to a :class:`PartitionSpec` on ``mesh``.

    Rules whose mesh axes are absent from the mesh are dropped (the same
    logical spec works on the 2D and 3D meshes).  A mesh axis is used at
    most once; later logical axes that would reuse it are left unsharded.
    If ``shape`` is given, any mesh axis that does not evenly divide the
    dimension is dropped.
    """
    rules = rules or active_rules()
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for i, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        target = rules.get(name)
        if target is None:
            out.append(None)
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        if shape is not None:
            keep = []
            dim = shape[i]
            for a in axes:
                if dim % sizes[a] == 0 and dim >= sizes[a]:
                    keep.append(a)
                    dim //= sizes[a]
            axes = tuple(keep)
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` when tensor dim ``i`` is split over it, else
    ``Replicate()``; a mesh dim of size 1 holds the whole tensor either
    way and takes ``Replicate()`` (DTensor's views refuse to merge a dim
    sharded over it).  Raises when a dim's axes are not in the mesh's
    order (DTensor would lay its shards out minor-first there)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    order = list(sizes)
    dim_of = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [order.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"dim {i} is split over {axes}, out of the "
                             f"mesh's order {tuple(order)}")
        for a in axes:
            dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1
                 else Replicate() for a in order)


def shard_shape(spec: Sequence, mesh, shape: Sequence[int]) -> tuple:
    """The shape of one shard of a ``shape`` tensor under ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = math.prod(sizes[a] for a in axes)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axes} ({n})")
        out[i] //= n
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh, a spec on it and the spec's DTensor placements."""

    mesh: object
    spec: PartitionSpec
    placements: tuple

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        return shard_shape(self.spec, self.mesh, shape)


def named_sharding(logical: Sequence[Optional[str]], mesh,
                   rules: Optional[dict] = None,
                   shape: Optional[Sequence[int]] = None) -> NamedSharding:
    spec = resolve_pspec(logical, mesh, rules, shape)
    return NamedSharding(mesh, spec, placements(spec, mesh))


def constrain(x, logical: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None):
    """Redistribute a DTensor to the sharding its logical axes resolve to
    on the active mesh; the identity without an active mesh.  ``shape``
    (default ``x``'s) is what the axes' divisibility is resolved against:
    a flattened (heads x head_dim) dim is split over the axes that divide
    its heads.

    The reference hints XLA with ``with_sharding_constraint``; eager
    PyTorch has no compiler to take such a hint, so a plain tensor is
    returned as it is, and only a DTensor moves.
    """
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sh = named_sharding(logical, mesh, active_rules(),
                        tuple(x.shape if shape is None else shape))
    return _Constrain.apply(x, mesh, tuple(sh.placements))


def _redistribute(x, mesh, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


class _Constrain(torch.autograd.Function):
    """``with_sharding_constraint`` on a DTensor: the value redistributed
    to ``placements``, and its cotangent too (then back to the input's
    placements, a partial sum there taken as replicated), so that a
    gradient meets the views and reshapes before it in a layout they
    take."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        from torch.distributed.tensor import Replicate
        ctx.mesh, ctx.placements = mesh, placements
        ctx.in_placements = tuple(Replicate() if p.is_partial() else p
                                  for p in x.placements)
        return _redistribute(x, mesh, placements)

    @staticmethod
    def backward(ctx, g):
        g = _redistribute(g, ctx.mesh, ctx.placements)
        return _redistribute(g, ctx.mesh, ctx.in_placements), None, None


def hold_layout(x):
    """``x`` itself, with its cotangent redistributed to ``x``'s own
    placements on its way back (the identity on anything but a DTensor):
    a gradient that would reach ``x``'s producer split where ``x`` is
    whole takes ``x``'s layout first."""
    if not is_dtensor(x):
        return x
    return _Constrain.apply(x, x.device_mesh, tuple(x.placements))


def can_shard(dim: int, logical_name: str) -> bool:
    """True if ``dim`` would actually be sharded under the active mesh."""
    mesh = active_mesh()
    if mesh is None:
        return False
    spec = resolve_pspec((logical_name,), mesh, active_rules(), (dim,))
    return len(spec) > 0 and spec[0] is not None


def tree_pspecs(spec_tree, mesh, rules: Optional[dict] = None):
    """Map a tree of ParamSpec-like leaves (with .logical/.shape) to
    PartitionSpecs."""
    return tree_map(lambda s: resolve_pspec(s.logical, mesh, rules, s.shape),
                    spec_tree)


def tree_shardings(spec_tree, mesh, rules: Optional[dict] = None):
    return tree_map(lambda s: named_sharding(s.logical, mesh, rules, s.shape),
                    spec_tree)


def place_tree(tree, spec_tree, mesh, rules: Optional[dict] = None):
    """``distribute_tensor`` every leaf of ``tree`` under its ParamSpec's
    sharding on ``mesh`` (``spec_tree`` has the same structure): the tree
    of DTensors, the reference's ``jax.tree.map(jax.device_put, params,
    shardings_tree(spec, mesh))``.  Every rank passes the same values."""
    from torch.distributed.tensor import distribute_tensor
    specs, _ = tree_flatten(spec_tree)
    leaves, treedef = tree_flatten(tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    out = []
    for s, x in zip(specs, leaves):
        if tuple(x.shape) != tuple(s.shape):
            raise ValueError(f"leaf of shape {tuple(x.shape)} against its "
                             f"spec's {tuple(s.shape)}")
        sh = named_sharding(s.logical, mesh, rules, s.shape)
        out.append(distribute_tensor(x, mesh, sh.placements))
    return tree_unflatten(treedef, out)


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor())


def replicated(t, like):
    """``t``, a plain tensor with the same values on every rank (an
    ``arange``, a table of constants), as a DTensor replicated on the mesh
    of ``like`` when ``like`` is a DTensor; else ``t`` itself."""
    DTensor = _dtensor()
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    from torch.distributed.tensor import Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def sharded_full(shape: Sequence[int], value, logical: Sequence[Optional[str]],
                 like, dtype=None):
    """``shape`` filled with ``value`` (``dtype``, default ``like``'s): a
    DTensor on ``like``'s mesh under the sharding ``logical`` resolves to
    there when ``like`` is a DTensor (each rank makes its own shard on the
    device of ``like``'s local tensor: a ``meta`` one in a dry run's
    trace), else a plain tensor on ``like``'s device."""
    dtype = dtype or like.dtype
    DTensor = _dtensor()
    if not isinstance(like, DTensor):
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=like.device)
    mesh = like.device_mesh
    sh = named_sharding(logical, mesh, active_rules(), tuple(shape))
    part = torch.full(sh.shard_shape(shape), value, dtype=dtype,
                      device=like.to_local().device)
    whole = torch.empty(tuple(shape), device="meta")
    return DTensor.from_local(part, mesh, sh.placements, run_check=False,
                              shape=whole.shape, stride=whole.stride())


def like_placements(x, ref):
    """``x`` redistributed to ``ref``'s placements where both are DTensors
    and theirs differ (a gradient's ``Partial`` sums reduced onto its
    parameter's sharding); else ``x``."""
    DTensor = _dtensor()
    if isinstance(x, DTensor) and isinstance(ref, DTensor):
        return _redistribute(x, ref.device_mesh, ref.placements)
    return x


def replicate(x):
    """A DTensor redistributed to be replicated on every mesh dim (a loss,
    a norm); anything else as it is."""
    DTensor = _dtensor()
    if not isinstance(x, DTensor):
        return x
    from torch.distributed.tensor import Replicate
    return _redistribute(x, x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def local(x):
    """The local tensor of a DTensor (for a replicated scalar, its value);
    anything else as it is."""
    return x.to_local() if isinstance(x, _dtensor()) else x


def from_local(t, ref):
    """``t``, a local shard laid out as ``ref``'s (a DTensor), as a DTensor
    of ``ref``'s mesh, placements and global shape; ``t`` itself when
    ``ref`` is no DTensor."""
    DTensor = _dtensor()
    if not isinstance(ref, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


#: logical axes along which a kernel's input may not be split: a kernel
#: reads a whole sequence and a whole head vector.
UNSPLIT = ("seq", "head_dim")


def _local_placements(x, logical, mesh, what: str) -> tuple:
    """The placements ``x`` takes on its way into a kernel: the sharding
    of ``logical`` on ``mesh``.  Raises where ``x`` is split, or would be,
    along an axis of :data:`UNSPLIT` (gathering it would be a quiet
    all-gather of a whole sequence)."""
    from torch.distributed.tensor import Shard
    sh = named_sharding(logical, mesh, active_rules(), tuple(x.shape))
    for p in tuple(x.placements) + tuple(sh.placements):
        if isinstance(p, Shard) and logical[p.dim] in UNSPLIT:
            raise ValueError(f"{what}: an input is split along its "
                             f"{logical[p.dim]!r} axis (placements "
                             f"{tuple(x.placements)} -> "
                             f"{tuple(sh.placements)}); the kernel takes a "
                             f"whole one")
    return sh.placements


def on_local_shards(fn, args: Sequence, in_logical: Sequence,
                    what: str = "fn", n_out: int = 1):
    """``fn(*args)`` on each rank's local shards.

    Where an argument is a DTensor, each argument is placed under the
    sharding its logical axes (``in_logical``, one tuple an argument)
    resolve to on its mesh under the active rules (a plain tensor enters as
    a replicated DTensor first), ``fn`` runs on the local tensors, and its
    output (``n_out`` of them, a tuple, when ``n_out > 1``) comes back as
    DTensors with the first argument's placements: each output shares the
    first argument's leading dims up to the last one split there
    (``torch.distributed.tensor.experimental.local_map``, whose autograd
    carries the local gradients through; an argument replicated on a mesh
    dim that splits another takes a partial gradient there, summed by the
    redistribution that follows).  Without a DTensor argument this is
    ``fn(*args)``."""
    DTensor = _dtensor()
    like = next((a for a in args if isinstance(a, DTensor)), None)
    if like is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh = like.device_mesh
    placed, in_pl = [], []
    for a, lg in zip(args, in_logical):
        a = replicated(a, like)
        pl = _local_placements(a, lg, mesh, what)
        placed.append(_redistribute(a, mesh, pl))
        in_pl.append(pl)
    # an argument whole on a mesh dim that splits another one (the sLSTM's
    # recurrent weights against its rows) gets a partial sum there from
    # each rank's slice of the work: its gradient is Partial on that dim
    from torch.distributed.tensor import Partial, Shard
    split = {d for pl in in_pl for d, p in enumerate(pl)
             if isinstance(p, Shard)}
    grad_pl = tuple(tuple(Partial() if d in split and p.is_replicate()
                          else p for d, p in enumerate(pl)) for pl in in_pl)
    out_pl = (in_pl[0],) if n_out == 1 else (in_pl[0],) * n_out
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=mesh)(*placed)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no rule for
    (``logsigmoid``'s backward): of a DTensor, ``fn`` on its local tensor,
    the result laid out as ``x`` (a partial sum reduced first), through
    ``local_map``, whose autograd carries the gradient."""
    DTensor = _dtensor()
    if not isinstance(x, DTensor):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    x = _redistribute(x, x.device_mesh, pl)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def embedding(table, tokens):
    """``F.embedding(tokens, table)``.  Of a DTensor ``table`` split by
    rows (``vocab``), each rank looks its tokens up in the rows it holds
    and zeros the rest, and the lookups are summed over the mesh dims that
    split the rows (``Partial``); the gradient of a rank's rows stays on
    it, summed over the dims that split the tokens.  (DTensor's own rule
    for the lookup keeps the whole table's gradient on every rank.)"""
    import torch.nn.functional as F
    DTensor = _dtensor()
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = replicated(tokens, table)
    tpl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                else Replicate() for p in table.placements)
    table = _redistribute(table, mesh, tpl)
    kpl = tuple(Replicate() if isinstance(q, Shard) or p.is_partial() else p
                for p, q in zip(tokens.placements, tpl))
    tokens = _redistribute(tokens, mesh, kpl)
    _, start, size = split_range(table, 0, "embedding")

    def look(t, ids):
        ids = ids - start
        hit = ((ids >= 0) & (ids < size))[..., None]
        out = F.embedding(torch.where(hit[..., 0], ids, 0), t)
        return torch.where(hit, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    out_pl = tuple(Partial() if isinstance(q, Shard) else p
                   for p, q in zip(kpl, tpl))
    grad_pl = tuple(Partial() if isinstance(p, Shard) else q
                    for p, q in zip(kpl, tpl))
    return local_map(look, out_placements=(out_pl,), in_placements=(tpl, kpl),
                     in_grad_placements=(grad_pl, kpl),
                     device_mesh=mesh)(table, tokens)


def split_range(x, dim: int, what: str = "fn") -> tuple:
    """``(mesh dims, start, size)`` of this rank's piece of ``x``'s dim
    ``dim``: the mesh dims that split it (DTensor splits over them left to
    right, major first), the global index of the piece's first element and
    its length.  Raises where the split is uneven."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    dims = [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]
    n = math.prod(mesh.size(i) for i in dims)
    if x.shape[dim] % n:
        raise ValueError(f"{what}: dim {dim} of {tuple(x.shape)} is split "
                         f"over {n} ranks, which do not divide it")
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    size = x.shape[dim] // n
    return dims, idx * size, size


def set_index(x, dim: int, index: int, value) -> None:
    """``x.select(dim, index).copy_(value)``, in place.  Of a DTensor, the
    rank (or ranks) whose local shard holds ``index`` along ``dim`` write
    it there, ``value`` laid out as ``x``'s other dims (a plain ``value``
    enters as a replicated DTensor); no shard of ``x`` moves."""
    DTensor = _dtensor()
    if not isinstance(x, DTensor):
        x.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    pl = tuple(Replicate() if not isinstance(p, Shard) or p.dim == dim
               else Shard(p.dim - (p.dim > dim)) for p in x.placements)
    value = _redistribute(replicated(value, x), mesh, pl)
    _, start, size = split_range(x, dim, "set_index")
    if start <= index < start + size:
        x.to_local().select(dim, index - start).copy_(value.to_local())


def on_local_slots(fn, q1, k, v, length: int, merge, what: str = "fn"):
    """One query against a KV cache on each rank's local slots.

    ``q1`` (B, 1, H, Dh); ``k``, ``v`` (B, Sc, H, Dh), the cache; the first
    ``length`` (a host int) slots are attended.  Where the cache is a
    DTensor, each rank keeps its shard as it is laid out: batch and heads
    split as they are, and along the slots (the reference's ``kv_seq_mp``)
    the rank at piece r of M holds slots [r Sc / M, (r + 1) Sc / M), a
    prefix of which, ``clamp(length - r Sc / M, 0, Sc / M)`` slots, is
    valid.  ``q1`` enters laid out as the cache with its slot splits
    replicated (an all-gather of a few KB), ``fn(q1, k, v, local_length)``
    gives ``(out, lse)`` on the local tensors, and ``merge(out, lse,
    groups)`` joins the pieces across the mesh dims that split the slots
    (``groups``: ``(mesh, dim)`` pairs).  The output is a DTensor laid out
    as ``q1`` entered.  Without a DTensor this is ``fn(q1, k, v,
    length)[0]``.  A cache split along ``head_dim``, or along its slots
    unevenly, raises."""
    DTensor = _dtensor()
    like = next((a for a in (k, v, q1) if isinstance(a, DTensor)), None)
    if like is None:
        return fn(q1, k, v, length)[0]
    from torch.distributed.tensor import Replicate, Shard
    mesh = like.device_mesh
    k = replicated(k, like)
    v = _redistribute(replicated(v, like), mesh, k.placements)
    for p in k.placements:
        if p.is_partial() or (isinstance(p, Shard) and p.dim == 3):
            raise ValueError(f"{what}: the cache is laid out as "
                             f"{tuple(k.placements)}; the kernel takes whole "
                             f"head vectors of summed values")
    dims, start, size = split_range(k, 1, what)
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in k.placements)
    q1 = _redistribute(replicated(q1, like), mesh, pl)
    out, lse = fn(q1.to_local(), k.to_local(), v.to_local(),
                  min(max(length - start, 0), size))
    if dims:
        out = merge(out, lse, [(mesh, i) for i in dims])
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=q1.shape, stride=q1.stride())
