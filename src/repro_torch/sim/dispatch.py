"""Memory-bounded, device-split dispatch knobs for the grid workloads.

The model sweeps (``sim.sweep``) and the Monte-Carlo engine
(``sim.engine``) cut their grid axis, and the engine its trials axis, into
chunks sized from a device-memory budget, so a 10^6-point grid or a
multi-gigabyte failure schedule streams through a bounded working set.
Every per-point computation is independent, so the chunk size never
changes a model sweep's results; the engine's auto-sampled gaps are
counter-based per (point, trial, gap index), so chunk size and budget
never change its results either.

On a machine with several CUDA devices the same paths split their work
across the first :func:`effective_devices` of them (:func:`sweep_mesh`,
the reference's 1-D ``"sweep"`` mesh): the grid axis (the two-level scan:
its trials axis) is cut into one contiguous piece a device, each piece is
chunked under the budget on its device, and the results are gathered on
the caller's device.  The plan (capacity buckets, step budgets) is made
once for the whole grid and every draw is keyed by the global point
index, so a split changes no bit: sharded == single-device.

Bounded caches are :class:`LRUCache`; a cache built with a ``name`` lands
in a registry that :func:`cache_stats` reports (the advisor's fingerprint
cache is one).  :func:`backend_info` says what a device is.

Configuration resolves from :class:`DispatchConfig` (explicit argument) or
the environment, as in the reference::

    REPRO_SWEEP_DEVICES    max CUDA devices to split over (1 disables it)
    REPRO_SWEEP_MEMORY_MB  device-memory budget per call (default 2048)
    REPRO_SWEEP_CHUNK      explicit grid-axis chunk size (overrides budget)
    REPRO_PRECISION        precision policy name (f64 / compensated_f32;
                           default = the device's policy)

The reference's ``backend`` knob and ``$REPRO_SWEEP_BACKEND`` pick the
platform its mesh spans; in the port every entry point takes an explicit
``device=`` (``"cuda"`` by default), which covers them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import warnings
from typing import List, Optional, Sequence, Tuple

import torch

from .._device import resolve_device
from . import precision as _precision
from .precision import PrecisionPolicy

#: default device-memory budget per call (bytes).
DEFAULT_MEMORY_BUDGET = 2 << 30


class CacheStats:
    """Hit/miss/insert/eviction counters of one :class:`LRUCache`."""

    __slots__ = ("hits", "misses", "inserts", "evictions")

    def __init__(self):
        self.reset()

    def reset(self):
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "lookups": self.lookups, "inserts": self.inserts,
                "evictions": self.evictions, "hit_rate": self.hit_rate}


#: name -> LRUCache for every cache constructed with a ``name``.
# reprolint: disable=RPL002 (this IS the cache_stats() registry: it holds the bounded LRUCaches themselves, one per name, not cached values)
_CACHE_REGISTRY: dict = {}


def cache_stats(reset: bool = False) -> dict:
    """``{cache name: stats snapshot (+ size/maxsize)}`` for every named
    cache in the process; ``reset=True`` zeroes the counters after reading
    (contents untouched: the stats are observability only)."""
    out = {}
    for name, cache in sorted(_CACHE_REGISTRY.items()):
        snap = cache.stats.snapshot()
        snap["size"] = len(cache)
        snap["maxsize"] = cache.maxsize
        out[name] = snap
        if reset:
            cache.stats.reset()
    return out


def reset_cache_stats():
    """Zero every named cache's counters (contents untouched)."""
    for cache in _CACHE_REGISTRY.values():
        cache.stats.reset()


class LRUCache:
    """A small LRU map with counters.

    Eviction drops only the cached value; a later lookup of the same key
    misses and the caller computes it again.  ``name`` registers the cache
    (and its :class:`CacheStats`) with :func:`cache_stats`, the last cache
    of a name owning the slot; anonymous caches count privately.
    """

    def __init__(self, maxsize: int, name: Optional[str] = None):
        self.maxsize = int(maxsize)
        self.name = name
        self.stats = CacheStats()
        self._d: collections.OrderedDict = collections.OrderedDict()
        if name is not None:
            _CACHE_REGISTRY[name] = self

    def get(self, key):
        try:
            val = self._d.pop(key)
        except KeyError:
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        self._d[key] = val            # re-insert as most recently used
        return val

    def put(self, key, val):
        self._d.pop(key, None)
        self._d[key] = val
        self.stats.inserts += 1
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self.stats.evictions += 1

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def clear(self):
        self._d.clear()


@dataclasses.dataclass(frozen=True)
class BackendInfo:
    """What a device is (:func:`backend_info`).

    ``platform`` is ``"cuda"`` or ``"cpu"``, ``device_kind`` the device's
    name (``torch.cuda.get_device_name``, e.g. "NVIDIA H100 80GB HBM3";
    ``"cpu"`` on the host), ``n_devices`` the CUDA device count (1 on the
    host) and ``virtual`` is False: the port has no host-virtual devices.
    """

    platform: str
    device_kind: str
    n_devices: int
    virtual: bool


def backend_info(device="cuda") -> BackendInfo:
    """The :class:`BackendInfo` of ``device``; raises for an unavailable
    GPU, as every entry point does."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return BackendInfo(platform="cpu", device_kind="cpu", n_devices=1,
                           virtual=False)
    return BackendInfo(platform=dev.type,
                       device_kind=torch.cuda.get_device_name(dev),
                       n_devices=torch.cuda.device_count(), virtual=False)


def _env_int(name: str) -> Optional[int]:
    """Parse an optional integer env knob; a malformed value warns and
    falls back to the default."""
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not an integer; ignoring it",
                      RuntimeWarning, stacklevel=3)
        return None


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Execution knobs.  ``memory_mb`` bounds each call's working set on a
    device (None = ``$REPRO_SWEEP_MEMORY_MB`` or 2 GiB); ``chunk`` forces a
    grid-axis chunk size (None = ``$REPRO_SWEEP_CHUNK`` or the budget);
    ``precision`` pins the :class:`PrecisionPolicy` (a policy, a name, or
    None = ``$REPRO_PRECISION`` or the device default); ``devices`` caps
    the CUDA devices a call splits over (None = all of them) and
    ``shard=False`` keeps it on the caller's device."""

    memory_mb: Optional[int] = None
    chunk: Optional[int] = None
    precision: Optional[object] = None
    devices: Optional[int] = None
    shard: bool = True

    def budget(self) -> int:
        """The device-memory budget in bytes."""
        mb = self.memory_mb if self.memory_mb is not None \
            else _env_int("REPRO_SWEEP_MEMORY_MB")
        return int(mb) << 20 if mb else DEFAULT_MEMORY_BUDGET

    def chunk_size(self) -> Optional[int]:
        """The forced grid-axis chunk size, if any."""
        return self.chunk if self.chunk is not None \
            else _env_int("REPRO_SWEEP_CHUNK")


def default_config() -> DispatchConfig:
    """The environment-driven config (see the module docstring)."""
    return DispatchConfig(memory_mb=_env_int("REPRO_SWEEP_MEMORY_MB"),
                          chunk=_env_int("REPRO_SWEEP_CHUNK"),
                          devices=_env_int("REPRO_SWEEP_DEVICES"))


def resolve(config: Optional[DispatchConfig]) -> DispatchConfig:
    return config if config is not None else default_config()


def effective_devices(config: Optional[DispatchConfig] = None,
                      device="cuda") -> int:
    """Devices a call on ``device`` splits over under ``config`` (>= 1):
    1 on the CPU or with ``shard=False``, else the CUDA device count
    capped by ``config.devices``."""
    cfg = resolve(config)
    if not cfg.shard or resolve_device(device).type != "cuda":
        return 1
    n = torch.cuda.device_count()
    if cfg.devices is not None:
        n = min(n, max(1, int(cfg.devices)))
    return max(1, n)


def sweep_mesh(n_devices: int) -> Tuple[torch.device, ...]:
    """The 1-D ``"sweep"`` axis: the first ``n_devices`` CUDA devices."""
    return tuple(torch.device("cuda", i) for i in range(int(n_devices)))


def split_devices(config: Optional[DispatchConfig],
                  device: torch.device) -> Tuple[torch.device, ...]:
    """The devices a call on ``device`` hands its pieces to: ``device``
    alone, or the sweep mesh of :func:`effective_devices`."""
    n = effective_devices(config, device)
    return (device,) if n == 1 else tuple(sweep_mesh(n))


def pieces(size: int, devices: Sequence[torch.device]
           ) -> List[Tuple[torch.device, int, int]]:
    """``(device, start, stop)`` contiguous pieces of an axis of ``size``,
    one a device, their lengths within one of each other; empty pieces
    (an axis shorter than the device list) are left out."""
    n = len(devices)
    q, r = divmod(int(size), n)
    out, start = [], 0
    for i, d in enumerate(devices):
        stop = start + q + (1 if i < r else 0)
        if stop > start:
            out.append((d, start, stop))
        start = stop
    return out


def on_device(device: torch.device):
    """A context that makes ``device`` current (a CUDA device), so a
    kernel launched on the current stream lands on it; a no-op for the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a broadcast view (stride 0 on a dim) moves its
    one stored slice and is expanded there again."""
    if t.device == device:
        return t
    base = t
    for i, (n, st) in enumerate(zip(t.shape, t.stride())):
        if st == 0 and n > 1:
            base = base.narrow(i, 0, 1)
    return base.to(device).expand(t.shape)


def resolve_precision(config: Optional[DispatchConfig] = None,
                      precision=None, device="cuda") -> PrecisionPolicy:
    """The :class:`PrecisionPolicy` a call runs under: explicit
    ``precision`` > ``config.precision`` > ``$REPRO_PRECISION`` > the
    default of ``device`` (f64 on the CPU, compensated f32 on CUDA).  A
    malformed env value warns and falls through to the device default."""
    if precision is not None:
        return _precision.resolve(precision)
    cfg = resolve(config)
    if cfg.precision is not None:
        return _precision.resolve(cfg.precision)
    env = os.environ.get("REPRO_PRECISION", "").strip()
    if env:
        try:
            return _precision.resolve(env)
        except ValueError:
            warnings.warn(
                f"REPRO_PRECISION={env!r} is not a known policy "
                f"({sorted(_precision.POLICIES)}); using the device "
                f"default", RuntimeWarning, stacklevel=2)
    return _precision.default_policy(device)


def chunk_plan(size: int, per_point_bytes: int,
               config: Optional[DispatchConfig] = None
               ) -> List[Tuple[int, int]]:
    """Cut a grid axis of ``size`` into ``(start, stop)`` chunks whose
    device working set (``per_point_bytes`` each) stays within the budget;
    an explicit chunk size wins over the budget."""
    cfg = resolve(config)
    size = int(size)
    if size <= 0:
        return []
    forced = cfg.chunk_size()
    if forced is not None:
        step = max(1, int(forced))
    else:
        step = max(1, cfg.budget() // max(1, int(per_point_bytes)))
    return [(s, min(s + step, size)) for s in range(0, size, step)]


def trial_chunk(n_trials: int, per_trial_bytes: int,
                config: Optional[DispatchConfig] = None) -> int:
    """Trials per block: all of them, unless one grid point at the full
    trial count would exceed the budget."""
    budget = resolve(config).budget()
    if n_trials * per_trial_bytes <= budget:
        return int(n_trials)
    return max(1, min(int(n_trials), budget // max(1, int(per_trial_bytes))))
