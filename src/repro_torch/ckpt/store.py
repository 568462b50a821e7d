"""Sharded checkpoint store with manifest, checksums and atomic commit.

Layout (one directory per generation), the reference's byte for byte:

    <root>/step_000123/
        shard_00000.npz         one file per host shard (flat leaf arrays)
        manifest.json           written LAST -> commit point (atomic rename)

A checkpoint is valid iff its manifest exists and every shard checksum
matches.  Two generations are retained; ``latest()`` falls back one
generation when validation fails (torn writes, injected corruption).
Leaves are numbered in the reference's order
(:mod:`repro_torch.ckpt.tree`), so a generation written by either package
restores in the other.

Interruptible writes: ``save`` streams the shard payload in chunks and
checks an optional ``abort`` event between chunks, so an in-flight deep
flush can be cancelled mid-write by the failure path (it raises
:class:`FlushAborted`; the torn generation it leaves behind has no
manifest, is invisible to ``latest()``, and is reclaimed by ``_gc`` /
``invalidate``).

Fault injection: a :class:`FaultPlan` attached as ``store.fault_plan``
scripts one IO failure mode at one named fault point — a stall, a torn
write after N bytes, silent checksum corruption, a burst of retryable
:class:`TransientIOError`, or a hard ``IOError``.  The checkpoint
manager's flush controller consults the same plan at its own points
(``buddy_push``, ``retry_backoff``, ``snapshot``).

Optional int8 blockwise compression (``compress=True``) quantizes every
f32 leaf of at least 4096 elements on the store's ``device`` through the
``quant_blockwise`` kernel (``device="cuda"``, the default) or its plain
version (``device="cpu"``): ~4x smaller payloads, which shrink the paper's
C parameter (lossy: bounded by absmax/127 per block).  A save quantizes
them in one launch into two packed arenas and copies each arena to the
host once; a restore dequantizes them in one launch on the same device
and returns tensors there, or on the device of the corresponding leaf of
``like_tree`` when it is a tensor.  A launch holds its leaves' f32, int8
and scales on the device at once (about 5 bytes an element), so the
leaves are cut into consecutive batches, one launch each, that fit half
of the device's free memory (:func:`_batches`): one batch for a state of
a few GB on an 80 GB card, several for a state larger than that.  The
restored tree itself is on the device whenever ``like_tree`` is, or the
store's device when it gives none.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ops as kops
from .tree import tree_flatten, tree_unflatten


class FlushAborted(RuntimeError):
    """An in-flight write was cancelled via its ``abort`` event (the
    failure-interrupt path of an asynchronous deep flush)."""


class TransientIOError(IOError):
    """Injected retryable IO failure (``FaultPlan(kind="transient")``);
    the flush controller's bounded retry loop absorbs these."""


#: the named points a :class:`FaultPlan` can arm.  The first four live in
#: ``ShardedStore.save``; the manager consults the rest.
FAULT_POINTS = ("snapshot", "shard_write", "shard_rename",
                "manifest_commit", "buddy_push", "retry_backoff")

#: shard payload streaming quantum — abort/fault checks happen between
#: chunks, bounding how stale an interrupt can get mid-write.
_CHUNK = 1 << 16


@dataclasses.dataclass
class FaultPlan:
    """One scripted IO fault: ``kind`` at ``fail_at``, ``max_triggers``
    times (transient bursts are bounded by ``transient_errors`` instead).

    Kinds: ``"error"`` raises a hard ``IOError``; ``"transient"`` raises
    :class:`TransientIOError` for the next ``transient_errors`` visits;
    ``"stall"`` sleeps ``stall_s`` (abort-interruptible); ``"torn"``
    truncates the shard write after ``torn_after_bytes``; ``"corrupt"``
    flips a byte of the committed shard after its checksum is recorded.
    """

    fail_at: str = "shard_write"
    kind: str = "error"
    stall_s: float = 0.05
    torn_after_bytes: int = 256
    transient_errors: int = 1
    max_triggers: int = 1
    fired: int = 0

    _KINDS = ("error", "transient", "stall", "torn", "corrupt")

    def __post_init__(self):
        if self.fail_at not in FAULT_POINTS:
            raise ValueError(f"fail_at must be one of {FAULT_POINTS}, "
                             f"got {self.fail_at!r}")
        if self.kind not in self._KINDS:
            raise ValueError(f"kind must be one of {self._KINDS}, "
                             f"got {self.kind!r}")

    def take(self, point: str,
             abort: Optional[threading.Event] = None) -> Optional["FaultPlan"]:
        """Consult the plan at a fault point.

        Returns ``None`` when the plan does not fire here (wrong point or
        budget exhausted); raises for the error kinds; returns ``self``
        for the caller-cooperative kinds (``torn``/``corrupt``) and after
        a completed ``stall``.
        """
        if point != self.fail_at:
            return None
        if self.kind == "transient":
            if self.transient_errors <= 0:
                return None
            self.transient_errors -= 1
            self.fired += 1
            raise TransientIOError(
                f"injected transient IO failure at {point}")
        if self.fired >= self.max_triggers:
            return None
        self.fired += 1
        if self.kind == "error":
            raise IOError(f"injected IO failure at {point}")
        if self.kind == "stall":
            if abort is not None:
                if abort.wait(self.stall_s):
                    raise FlushAborted(
                        f"aborted during injected stall at {point}")
            else:
                time.sleep(self.stall_s)
        return self


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))


def _numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array (tensors are copied off the device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _onto(arr: torch.Tensor, like) -> torch.Tensor:
    """A restored leaf on the device of ``like`` when it is a tensor."""
    if isinstance(like, torch.Tensor) and arr.device != like.device:
        return arr.to(like.device)
    return arr


def _compressible(leaf) -> bool:
    """The reference's rule: f32 leaves of at least 4096 elements."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype == torch.float32 and leaf.numel() >= 4096
    arr = np.asarray(leaf)
    return arr.dtype == np.float32 and arr.size >= 4096


#: device bytes a compressed element holds during its launch: its f32, its
#: int8 payload and its share of the f32 scale of its 128-group.
_DEVICE_BYTES_PER_ELEMENT = 4 + 1 + 4 / 128


def _device_budget(device: torch.device) -> float:
    """Bytes one quantize or dequantize launch of the store may hold on
    ``device``: half of its free memory (a flush runs beside training),
    or no limit off a card."""
    if device.type != "cuda":
        return math.inf
    return torch.cuda.mem_get_info(device)[0] / 2


def _batches(sizes: list, budget: float) -> list:
    """Consecutive runs of the indices of ``sizes`` (element counts), each
    within ``budget`` device bytes at ``_DEVICE_BYTES_PER_ELEMENT``; a leaf
    over the budget alone makes a run."""
    runs, held = [], 0.0
    for i, n in enumerate(sizes):
        need = n * _DEVICE_BYTES_PER_ELEMENT
        if not runs or held + need > budget:
            runs.append([])
            held = 0.0
        runs[-1].append(i)
        held += need
    return runs


@dataclasses.dataclass
class StoreConfig:
    root: str
    retain: int = 2
    compress: bool = False
    # leaf indices are compared against this predicate via their tree path
    no_compress_paths: tuple = ("step",)
    #: where compressed leaves are (de)quantized and restored leaves land.
    device: Any = "cuda"


class ShardedStore:
    """Host-sharded on-disk checkpoint store (single-host simulation keeps
    one shard; the format is per-host shard files + a manifest)."""

    def __init__(self, config: StoreConfig, n_shards: int = 1):
        self.cfg = config
        self.device = resolve_device(config.device)
        self.root = Path(config.root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.n_shards = n_shards
        #: mutable injection hook; set a :class:`FaultPlan` to script the
        #: next IO failure, clear to heal the store.
        self.fault_plan: Optional[FaultPlan] = None
        #: host-clock splits (seconds) of the last :meth:`save` and
        #: :meth:`restore`.
        self.last_save: dict = {}
        self.last_restore: dict = {}

    def fault(self, point: str,
              abort: Optional[threading.Event] = None
              ) -> Optional[FaultPlan]:
        """Consult the injection plan at a named fault point (no-op
        without one) — also called by the manager for its points."""
        if self.fault_plan is None:
            return None
        return self.fault_plan.take(point, abort=abort)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ save
    def _quantize(self, leaves: list, tm: dict) -> dict:
        """{leaf index: (payload, scales, pad, shape)} of the compressible
        leaves, payload and scales as host numpy arrays.  Each batch of
        them (:func:`_batches`; all of them when the device has room) is
        quantized on the device in one launch, then each packed arena comes
        to the host in one copy and a leaf's arrays are views into it."""
        comp = [i for i, leaf in enumerate(leaves)
                if self.cfg.compress and _compressible(leaf)]
        if not comp:
            return {}
        packed = {}
        sizes = [torch.as_tensor(leaves[i]).numel() for i in comp]
        for batch in _batches(sizes, _device_budget(self.device)):
            idx = [comp[j] for j in batch]
            ta = time.perf_counter()
            xs = [torch.as_tensor(leaves[i]).to(self.device) for i in idx]
            tb = time.perf_counter()
            q_arena, s_arena, views = kops.quantize_arrays(xs)
            q_host, s_host = q_arena.cpu().numpy(), s_arena.cpu().numpy()
            for i, x, (q, s, pad) in zip(idx, xs, views):
                qo, so = q.storage_offset(), s.storage_offset()
                packed[i] = (q_host[qo:qo + q.numel()].reshape(q.shape),
                             s_host[so:so + s.numel()].reshape(s.shape),
                             pad, list(x.shape))
            del xs, q_arena, s_arena, views
            tm["h2d"] += tb - ta
            tm["quant"] += time.perf_counter() - tb
        return packed

    def save(self, step: int, tree: Any, *, shard_id: int = 0,
             extra_meta: Optional[dict] = None,
             abort: Optional[threading.Event] = None) -> dict:
        """Write one generation (blocking).  Returns timing/size metadata;
        :attr:`last_save` splits the host-clock seconds into ``h2d``
        (compressed leaves to the device), ``quant`` (kernel and payload
        back to the host), ``npz``, ``write`` (chunks and rename), ``crc``
        (read back and checksum) and ``commit`` (manifest).

        ``abort``: optional event checked between payload chunks; when it
        fires mid-write the save raises :class:`FlushAborted`, leaving at
        most an uncommitted (manifest-less) generation behind.
        """
        t0 = time.perf_counter()
        tm = dict.fromkeys(("h2d", "quant", "npz", "write", "crc",
                            "commit"), 0.0)
        leaves, treedef = tree_flatten(tree)
        gen = self.root / f"step_{step:09d}"
        gen.mkdir(parents=True, exist_ok=True)

        packed = self._quantize(leaves, tm)
        arrays = {}
        meta_leaves = []
        for i, leaf in enumerate(leaves):
            if i in packed:
                q, s, pad, shape = packed.pop(i)
                arrays[f"leaf_{i}_q"] = q
                arrays[f"leaf_{i}_s"] = s
                entry = {"index": i, "dtype": "float32", "shape": shape,
                         "compressed": True, "pad": int(pad)}
            else:
                arr = _numpy(leaf)
                arrays[f"leaf_{i}"] = arr
                entry = {"index": i, "dtype": str(arr.dtype),
                         "shape": list(arr.shape), "compressed": False}
            meta_leaves.append(entry)

        ta = time.perf_counter()
        shard_path = gen / f"shard_{shard_id:05d}.npz"
        tmp = shard_path.with_suffix(".npz.tmp")
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        del buf, arrays
        tm["npz"] = time.perf_counter() - ta

        ta = time.perf_counter()
        fired = self.fault("shard_write", abort)
        torn_at = (fired.torn_after_bytes
                   if fired is not None and fired.kind == "torn" else None)
        with open(tmp, "wb") as f:
            written = 0
            for off in range(0, len(payload), _CHUNK):
                if abort is not None and abort.is_set():
                    raise FlushAborted(
                        f"flush of step {step} aborted mid-write "
                        f"({written}/{len(payload)} bytes)")
                chunk = payload[off:off + _CHUNK]
                if torn_at is not None and written + len(chunk) > torn_at:
                    f.write(chunk[:max(0, torn_at - written)])
                    f.flush()
                    raise IOError(f"injected torn write after "
                                  f"{torn_at} bytes")
                f.write(chunk)
                written += len(chunk)
        self.fault("shard_rename", abort)
        tmp.rename(shard_path)
        tm["write"] = time.perf_counter() - ta

        ta = time.perf_counter()
        checksum = _crc(np.frombuffer(shard_path.read_bytes(),
                                      dtype=np.uint8))
        tm["crc"] = time.perf_counter() - ta
        ta = time.perf_counter()
        manifest = {
            "step": step,
            "created": time.time(),
            "treedef": str(treedef),
            "leaves": meta_leaves,
            "shards": {str(shard_id): {"file": shard_path.name,
                                       "crc32": checksum}},
            "extra": extra_meta or {},
        }
        if abort is not None and abort.is_set():
            raise FlushAborted(f"flush of step {step} aborted before commit")
        fired = self.fault("manifest_commit", abort)
        mtmp = gen / "manifest.json.tmp"
        mtmp.write_text(json.dumps(manifest))
        mtmp.rename(gen / "manifest.json")       # commit point
        if fired is not None and fired.kind == "corrupt":
            # flip one byte AFTER the checksum was recorded: the
            # generation commits but fails CRC validation (the silent-
            # corruption model ``latest()`` must fall back across).
            with open(shard_path, "r+b") as f:
                b = f.read(1)
                f.seek(0)
                f.write(bytes([b[0] ^ 0xFF]))

        self._gc()
        tm["commit"] = time.perf_counter() - ta
        dt = time.perf_counter() - t0
        bytes_written = shard_path.stat().st_size
        self.last_save = tm
        return {"duration_s": dt, "bytes": bytes_written, "step": step,
                "path": str(gen)}

    # ---------------------------------------------------------------- restore
    def generations(self) -> list:
        gens = sorted(p for p in self.root.glob("step_*") if p.is_dir())
        return gens

    def validate(self, gen: Path) -> bool:
        man = gen / "manifest.json"
        if not man.exists():
            return False
        try:
            manifest = json.loads(man.read_text())
            for sid, info in manifest["shards"].items():
                p = gen / info["file"]
                if not p.exists():
                    return False
                crc = _crc(np.frombuffer(p.read_bytes(), dtype=np.uint8))
                if crc != info["crc32"]:
                    return False
            return True
        except (json.JSONDecodeError, KeyError):
            return False

    def latest(self) -> Optional[Path]:
        """Newest VALID generation (falls back across torn/corrupt ones)."""
        for gen in reversed(self.generations()):
            if self.validate(gen):
                return gen
        return None

    def restore(self, like_tree: Any, gen: Optional[Path] = None,
                *, shard_id: int = 0):
        """Load into the structure (and devices) of ``like_tree``.

        Returns (tree, step) or (None, None) when no valid checkpoint
        exists.  The restored leaves are ready when it returns; the
        host-clock split (``latest`` = read and CRC of the candidates,
        ``read``, ``h2d``, ``dequant``) is left in :attr:`last_restore`.
        """
        t0 = time.perf_counter()
        gen = gen or self.latest()
        tm = {"latest": time.perf_counter() - t0}
        if gen is None:
            self.last_restore = tm
            return None, None
        manifest = json.loads((gen / "manifest.json").read_text())
        ta = time.perf_counter()
        with np.load(gen / manifest["shards"][str(shard_id)]["file"]) as data:
            arrays = {k: data[k] for k in data.files}
        tm["read"] = time.perf_counter() - ta

        ta = time.perf_counter()
        dev = self.device
        entries = manifest["leaves"]
        moved = {f"leaf_{e['index']}": torch.from_numpy(
                     arrays.pop(f"leaf_{e['index']}")).to(dev)
                 for e in entries if not e["compressed"]}
        tm["h2d"] = time.perf_counter() - ta
        tm["dequant"] = 0.0

        leaves_like, treedef = tree_flatten(like_tree)
        like_of = {e["index"]: like for e, like in zip(entries, leaves_like)}
        comp = [e for e in entries if e["compressed"]]
        dequantized = {}
        for batch in _batches([math.prod(e["shape"]) for e in comp],
                              _device_budget(dev) if comp else 0.0):
            es = [comp[j] for j in batch]
            ta = time.perf_counter()
            qs = [torch.from_numpy(arrays.pop(f"leaf_{e['index']}_q")).to(dev)
                  for e in es]
            ss = [torch.from_numpy(arrays.pop(f"leaf_{e['index']}_s")).to(dev)
                  for e in es]
            tb = time.perf_counter()
            arrs = kops.dequantize_arrays(
                qs, ss, shapes=[tuple(e["shape"]) for e in es],
                dtypes=[e["dtype"] for e in es], pads=[e["pad"] for e in es])
            for e, arr in zip(es, arrs):
                dequantized[e["index"]] = _onto(arr, like_of[e["index"]])
            del qs, ss, arrs
            tm["h2d"] += tb - ta
            tm["dequant"] += time.perf_counter() - tb

        ta = time.perf_counter()
        out = []
        for entry, like in zip(entries, leaves_like):
            i = entry["index"]
            out.append(dequantized.pop(i) if entry["compressed"] else
                       _onto(moved.pop(f"leaf_{i}"), like))
        self._sync()
        tm["dequant"] += time.perf_counter() - ta
        self.last_restore = tm
        return tree_unflatten(treedef, out), manifest["step"]

    # --------------------------------------------------------------------- gc
    def invalidate(self, step: int) -> bool:
        """Delete the (possibly torn) generation of ``step`` — the
        discard half of a failure-interrupted flush.  Returns whether a
        generation directory existed."""
        gen = self.root / f"step_{step:09d}"
        if not gen.exists():
            return False
        self._rmgen(gen)
        return True

    @staticmethod
    def _rmgen(gen: Path):
        for p in sorted(gen.glob("**/*"), reverse=True):
            p.unlink()
        gen.rmdir()

    def _gc(self):
        gens = self.generations()
        # keep the newest `retain` COMMITTED generations ...
        committed = [g for g in gens if (g / "manifest.json").exists()]
        drop = set(committed[:-self.cfg.retain])
        if committed:
            # ... and reclaim UNCOMMITTED generations strictly older than
            # the newest committed one: those are torn leftovers of
            # aborted/failed flushes that will never commit.  Newer
            # uncommitted directories may be a flush in flight — kept.
            # (step_%09d zero-padding makes name order step order.)
            newest = committed[-1].name
            seen = set(committed)
            drop.update(g for g in gens
                        if g not in seen and g.name < newest)
        for g in sorted(drop):
            self._rmgen(g)
