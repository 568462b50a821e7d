"""Failure processes: renewal processes of i.i.d. inter-failure gaps.

Counterpart of the reference's failure-process module.  Four processes:

  * :class:`Exponential` — the paper's Poisson process (the default).
  * :class:`Weibull` — shape ``k`` (k < 1: clustered failures).
  * :class:`LogNormal` — multiplicative-error gap model.
  * :class:`TraceReplay` — cyclic replay of an empirical gap log from a
    random per-trajectory phase.

Renewal convention (shared with both simulators): gap ``i`` runs from the
end of recovery ``i-1`` (or t = 0) to failure ``i``.

Every process targets a mean gap ``mu``; with ``mu=None`` the caller
supplies the mean at sampling time, which is how one process instance
serves a whole grid of MTBFs.  Shape parameters may be arrays, one per
grid point (use :meth:`FailureProcess.ravel` next to ``ParamGrid.ravel``).

Two samplers share the distributions:

  * :meth:`FailureProcess.sample` — host numpy, from the caller's
    ``np.random.Generator`` (the replayable schedules of the parity tests).
  * :meth:`FailureProcess.sample_gaps` — on the device, by inverse-CDF
    transforms of counter-based uniforms (:class:`~repro_torch.core.philox
    .CounterKey`): gap ``j`` of grid point ``i`` and trial ``t`` is a
    function of the seed, ``i``, ``t``, ``j`` and the process alone.  Same
    distribution, not the same stream as numpy (or as JAX's threefry).

The device transform of each process is held in one place: its
:class:`GapSpec` (:meth:`FailureProcess.gap_spec`), the per-point values
the transform needs.  :func:`draw_gaps` applies a spec to a block's
uniforms; ``sample_gaps`` is that call, and the event kernel that draws
its gaps itself (``kernels/event_sweep.py::event_sweep_sampled``) reads
the same spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from .._device import F64, resolve_device
from .philox import CounterKey

ArrayLike = Union[float, np.ndarray]


def _lead(x: ArrayLike, size: tuple) -> np.ndarray:
    """Align an array-valued parameter with the leading axes of ``size``
    (``(B,)`` sampled at ``(B, n, F)`` becomes ``(B, 1, 1)``)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 0 or size is None:
        return x
    extra = len(size) - x.ndim
    if extra < 0:
        raise ValueError(f"parameter of shape {x.shape} cannot broadcast "
                         f"against sample size {size}")
    return x.reshape(x.shape + (1,) * extra)


def _take(x, idx):
    """Per-point parameter ``x`` restricted to flat points ``idx`` (scalars
    and single values pass through)."""
    arr = np.asarray(x, dtype=np.float64)
    return arr if arr.size == 1 else arr.ravel()[idx]


class FailureProcess:
    """A renewal process of i.i.d. inter-failure gaps (see module docstring)."""

    name: str = "process"
    #: declared mean gap, or None when the caller supplies it per sample.
    mu: Optional[ArrayLike] = None

    def resolve_mean(self, mean: Optional[ArrayLike] = None) -> np.ndarray:
        """The mean gap to sample at: the caller's ``mean`` unless the
        process pins its own ``mu``."""
        m = self.mu if self.mu is not None else mean
        if m is None:
            raise ValueError(f"{self.name}: no mean gap — construct with "
                             f"mu=... or pass mean= when sampling")
        return np.asarray(m, dtype=np.float64)

    def gap_cv(self) -> ArrayLike:
        """Coefficient of variation (std/mean) of one gap; 1 for exponential."""
        return 1.0

    def sample(self, rng: np.random.Generator, size=None,
               mean: Optional[ArrayLike] = None):
        """Draw gaps on the host from the caller's numpy generator."""
        raise NotImplementedError

    def sample_gaps(self, key: CounterKey, size: tuple, mean=None,
                    device="cuda", dtype: torch.dtype = F64) -> torch.Tensor:
        """Draw ``size = (points, trials, F)`` gaps on ``device`` from the
        counter-based stream ``key`` (f64 draws, returned in ``dtype``).
        ``mean`` is one mean per grid point (or one for all)."""
        dev = resolve_device(device)
        size = tuple(size)
        if tuple(size[:-1]) != key.shape:
            raise ValueError(f"sample size {size} does not match the key's "
                             f"(points, trials) {key.shape}")
        spec = self.gap_spec(mean, int(size[0]), dev)
        return draw_gaps(spec, key, int(size[-1])).to(dtype)

    def gap_spec(self, mean, n_points: int, device="cuda") -> "GapSpec":
        """The per-point values of this process's device transform for
        ``n_points`` grid points with means ``mean`` (see :class:`GapSpec`)."""
        raise NotImplementedError(f"{self.name}: no device sampler")

    def hazard(self, t, mean=None, device="cuda") -> torch.Tensor:
        """Instantaneous failure rate h(t) at gap-age ``t``."""
        raise NotImplementedError(f"{self.name}: no analytic hazard")

    def ravel(self) -> "FailureProcess":
        """Flatten array-valued shape parameters (``ParamGrid.ravel``)."""
        return self

    def subset(self, idx) -> "FailureProcess":
        """The process restricted to raveled grid points ``idx`` (array
        parameters are indexed; scalar parameters pass through)."""
        return self

    def iter_gaps(self, rng: np.random.Generator,
                  mean: Optional[ArrayLike] = None):
        """Infinite iterator of gaps for ONE trajectory (the scalar
        simulator's lazy draw path): i.i.d. draws by default."""
        while True:
            yield float(self.sample(rng, mean=mean))

    @property
    def is_exponential(self) -> bool:
        return False

    def _device_mean(self, mean, n_points: int, device) -> torch.Tensor:
        m = self.mu if self.mu is not None else mean
        if m is None:
            raise ValueError(f"{self.name}: no mean gap — construct with "
                             f"mu=... or pass mean= when sampling")
        return _per_point(m, n_points, device)


def _per_point(x, n_points: int, device) -> torch.Tensor:
    """A per-point parameter (one value, or one per point) as an f64 ``(n,)``
    tensor on ``device``."""
    x = torch.as_tensor(x, dtype=F64, device=device)
    if x.numel() == 1:
        return x.reshape(()).expand(n_points)
    if x.numel() != n_points:
        raise ValueError(f"parameter of shape {tuple(x.shape)} does not give "
                         f"one value per point ({n_points})")
    return x.reshape(n_points)


@dataclasses.dataclass(frozen=True)
class GapSpec:
    """A process's inverse-CDF transform, as per-point f64 values.

    Gap ``j`` of a lane whose uniform ``j`` is ``u`` (its uniform 0 is
    ``u0``), at a point with values ``a`` and ``b``:

    * ``exponential``: ``a * (-log(u))``, ``a`` the mean;
    * ``weibull``: ``a * exp(log(-log(u)) / b)``, ``a`` the scale
      ``mean / Gamma(1 + 1/k)`` and ``b`` the shape ``k``;
    * ``lognormal``: ``exp(a + b * ndtri(u))``, ``a = log(mean) - s*s/2``
      and ``b`` the sigma ``s``;
    * ``trace``: ``trace[(start + j) % n] * a`` with ``start = min(floor(u0
      * n), n - 1)``, ``a`` the rescale ``mean / trace_mean`` (1 for none).

    ``a`` and ``b`` come from the torch expressions of :meth:`gap_spec`, so
    the kernel that reads a spec starts from the bits the samplers use.
    """

    kind: str
    a: torch.Tensor
    b: torch.Tensor
    trace: Optional[torch.Tensor] = None

    #: the kernel's numbering of the kinds.
    KINDS = ("exponential", "weibull", "lognormal", "trace")

    @property
    def kind_id(self) -> int:
        return self.KINDS.index(self.kind)

    @property
    def n_points(self) -> int:
        return int(self.a.numel())

    def take(self, idx: torch.Tensor) -> "GapSpec":
        """The spec of points ``idx`` (an index tensor on the spec's device)."""
        return dataclasses.replace(self, a=self.a[idx], b=self.b[idx])

    def to(self, device) -> "GapSpec":
        """The spec with its tensors on ``device``."""
        return dataclasses.replace(
            self, a=self.a.to(device), b=self.b.to(device),
            trace=None if self.trace is None else self.trace.to(device))


def draw_gaps(spec: GapSpec, key: CounterKey, n: int) -> torch.Tensor:
    """``(points, trials, n)`` f64 gaps of ``key``'s lanes under ``spec``,
    in PyTorch on the key's device.  ``draw_gaps.calls`` counts its calls."""
    draw_gaps.calls += 1
    if spec.n_points != key.shape[0]:
        raise ValueError(f"spec of {spec.n_points} points, key of "
                         f"{key.shape[0]}")
    col = lambda x: x.reshape(-1, 1, 1)
    if spec.kind == "trace":
        trace = spec.trace
        m = int(trace.numel())
        u = key.uniforms(1)
        start = torch.clamp(torch.floor(u * m).to(torch.int64), max=m - 1)
        idx = (start + torch.arange(n, device=key.device)) % m
        return trace[idx] * col(spec.a)
    u = key.uniforms(n)
    if spec.kind == "exponential":
        return col(spec.a) * (-torch.log(u))
    if spec.kind == "weibull":
        # the power as exp(log(E)/k): PyTorch's CPU pow rounds a few
        # elements differently depending on where they fall in the tensor,
        # which would let the blocking change the draws.
        return col(spec.a) * torch.exp(torch.log(-torch.log(u)) / col(spec.b))
    if spec.kind == "lognormal":
        return torch.exp(col(spec.a) + col(spec.b) * torch.special.ndtri(u))
    raise ValueError(f"unknown gap spec kind {spec.kind!r}")


draw_gaps.calls = 0


@dataclasses.dataclass(frozen=True)
class Exponential(FailureProcess):
    """The paper's Poisson process: constant hazard 1/mu.  ``sample`` is
    ``rng.exponential(scale=mean)``, the reference's exact host call."""

    mu: Optional[ArrayLike] = None
    name: str = "exponential"

    def sample(self, rng, size=None, mean=None):
        return rng.exponential(scale=_lead(self.resolve_mean(mean), size),
                               size=size)

    def gap_spec(self, mean, n_points, device="cuda"):
        m = self._device_mean(mean, n_points, device)
        return GapSpec("exponential", m, torch.zeros_like(m))

    def ravel(self) -> "Exponential":
        return dataclasses.replace(
            self, mu=None if self.mu is None else np.ravel(self.mu))

    def subset(self, idx) -> "Exponential":
        return dataclasses.replace(
            self, mu=None if self.mu is None else _take(self.mu, idx))

    def hazard(self, t, mean=None, device="cuda"):
        dev = resolve_device(device)
        t = torch.as_tensor(t, dtype=F64, device=dev)
        rate = torch.as_tensor(1.0 / self.resolve_mean(mean), dtype=F64,
                               device=dev)
        return torch.broadcast_to(rate, t.shape).clone()

    @property
    def is_exponential(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Weibull(FailureProcess):
    """Weibull(shape k, scale lam) gaps with mean ``lam * Gamma(1 + 1/k)``;
    the scale is derived from the target mean."""

    shape: ArrayLike = 0.7
    mu: Optional[ArrayLike] = None
    name: str = "weibull"

    def __post_init__(self):
        if np.any(np.asarray(self.shape) <= 0):
            raise ValueError(f"Weibull shape must be > 0, got {self.shape}")

    def _scale(self, mean, size=None):
        k = _lead(self.shape, size)
        return _lead(self.resolve_mean(mean), size) / _gamma1p(1.0 / k), k

    def sample(self, rng, size=None, mean=None):
        lam, k = self._scale(mean, size)
        return lam * rng.weibull(k, size=size)

    def gap_spec(self, mean, n_points, device="cuda"):
        # inverse CDF through the standard exponential: X = lam * E^(1/k)
        k = _per_point(self.shape, n_points, device)
        g1 = _per_point(_gamma1p(1.0 / np.asarray(self.shape,
                                                  dtype=np.float64)),
                        n_points, device)
        lam = self._device_mean(mean, n_points, device) / g1
        return GapSpec("weibull", lam, k)

    def gap_cv(self):
        k = np.asarray(self.shape, dtype=np.float64)
        g1 = _gamma1p(1.0 / k)
        g2 = _gamma1p(2.0 / k)
        return np.sqrt(np.maximum(g2 / g1**2 - 1.0, 0.0))

    def hazard(self, t, mean=None, device="cuda"):
        dev = resolve_device(device)
        lam, k = self._scale(mean)
        lam = torch.as_tensor(lam, dtype=F64, device=dev)
        k = torch.as_tensor(k, dtype=F64, device=dev)
        t = torch.as_tensor(t, dtype=F64, device=dev)
        return (k / lam) * (t / lam) ** (k - 1.0)

    def ravel(self) -> "Weibull":
        return dataclasses.replace(
            self, shape=np.ravel(self.shape),
            mu=None if self.mu is None else np.ravel(self.mu))

    def subset(self, idx) -> "Weibull":
        return dataclasses.replace(
            self, shape=_take(self.shape, idx),
            mu=None if self.mu is None else _take(self.mu, idx))


@dataclasses.dataclass(frozen=True)
class LogNormal(FailureProcess):
    """Log-normal gaps exp(N(m, sigma^2)), m chosen so the mean is mu."""

    sigma: ArrayLike = 1.0
    mu: Optional[ArrayLike] = None
    name: str = "lognormal"

    def __post_init__(self):
        if np.any(np.asarray(self.sigma) <= 0):
            raise ValueError(f"LogNormal sigma must be > 0, got {self.sigma}")

    def sample(self, rng, size=None, mean=None):
        s = _lead(self.sigma, size)
        m = np.log(_lead(self.resolve_mean(mean), size)) - 0.5 * s * s
        return rng.lognormal(mean=m, sigma=s, size=size)

    def gap_spec(self, mean, n_points, device="cuda"):
        s = _per_point(self.sigma, n_points, device)
        m = torch.log(self._device_mean(mean, n_points, device)) - 0.5 * s * s
        return GapSpec("lognormal", m, s)

    def gap_cv(self):
        s = np.asarray(self.sigma, dtype=np.float64)
        return np.sqrt(np.expm1(s * s))

    def hazard(self, t, mean=None, device="cuda"):
        dev = resolve_device(device)
        s = torch.as_tensor(self.sigma, dtype=F64, device=dev)
        m = torch.log(torch.as_tensor(self.resolve_mean(mean), dtype=F64,
                                      device=dev)) - 0.5 * s * s
        t = torch.as_tensor(t, dtype=F64, device=dev)
        z = (torch.log(t) - m) / s
        pdf = torch.exp(-0.5 * z * z) / (t * s * math.sqrt(2.0 * math.pi))
        sf = 0.5 * torch.special.erfc(z / math.sqrt(2.0))
        return pdf / sf

    def ravel(self) -> "LogNormal":
        return dataclasses.replace(
            self, sigma=np.ravel(self.sigma),
            mu=None if self.mu is None else np.ravel(self.mu))

    def subset(self, idx) -> "LogNormal":
        return dataclasses.replace(
            self, sigma=_take(self.sigma, idx),
            mu=None if self.mu is None else _take(self.mu, idx))


@dataclasses.dataclass(frozen=True)
class TraceReplay(FailureProcess):
    """Replay an empirical gap log cyclically from a uniformly random
    starting offset per trajectory, keeping the trace's ordering.  With a
    caller-supplied mean the gaps are rescaled by ``mean / trace_mean``
    (``rescale=False`` always replays the raw trace)."""

    gaps: tuple = ()
    rescale: bool = True
    name: str = "trace"

    def __post_init__(self):
        g = np.asarray(self.gaps, dtype=np.float64).ravel()
        if g.size == 0:
            raise ValueError("TraceReplay needs at least one gap")
        if np.any(g <= 0) or not np.all(np.isfinite(g)):
            raise ValueError("trace gaps must be finite and > 0")
        object.__setattr__(self, "gaps", tuple(float(x) for x in g))

    @property
    def mu(self):  # type: ignore[override]
        return float(np.mean(self.gaps))

    def resolve_mean(self, mean=None):
        if mean is None or not self.rescale:
            return np.asarray(self.mu, dtype=np.float64)
        return np.asarray(mean, dtype=np.float64)

    def gap_cv(self):
        g = np.asarray(self.gaps)
        return float(g.std() / g.mean()) if g.size > 1 else 1.0

    def sample(self, rng, size=None, mean=None):
        trace = np.asarray(self.gaps, dtype=np.float64)
        n = trace.size
        if size is None:
            return float(trace[int(rng.integers(n))]) \
                * float(self.resolve_mean(mean) / self.mu)
        size = tuple(size)
        start = rng.integers(n, size=size[:-1] + (1,))
        idx = (start + np.arange(size[-1])) % n
        out = trace[idx] * (_lead(self.resolve_mean(mean), size) / self.mu)
        return np.broadcast_to(out, size).copy()

    def gap_spec(self, mean, n_points, device="cuda"):
        """One uniform starting offset per trajectory (the lane's uniform
        0, as ``floor(u n)``), then a cyclic gather, rescaled by
        ``mean / trace_mean`` when a mean is given (and ``rescale``)."""
        trace = torch.as_tensor(self.gaps, dtype=F64, device=device)
        if mean is not None and self.rescale:
            scale = _per_point(mean, n_points, device) / self.mu
        else:
            scale = torch.ones(n_points, dtype=F64, device=device)
        return GapSpec("trace", scale, torch.zeros_like(scale), trace)

    def iter_gaps(self, rng, mean=None):
        """Cyclic replay from one uniformly random starting offset."""
        trace = np.asarray(self.gaps, dtype=np.float64)
        scale = float(self.resolve_mean(mean) / self.mu)
        i = int(rng.integers(trace.size))
        while True:
            yield float(trace[i]) * scale
            i = (i + 1) % trace.size


PROCESSES = {
    "exponential": Exponential,
    "weibull": Weibull,
    "lognormal": LogNormal,
    "trace": TraceReplay,
}


def get_process(name: str, **kwargs) -> FailureProcess:
    """Build a process by name (``weibull``, ``lognormal``, ...)."""
    try:
        cls = PROCESSES[name]
    except KeyError:
        raise KeyError(f"unknown failure process {name!r}; "
                       f"one of {sorted(PROCESSES)}") from None
    return cls(**kwargs)


def as_process(p) -> FailureProcess:
    """Coerce None (-> Exponential), a name, or a process instance."""
    if p is None:
        return Exponential()
    if isinstance(p, str):
        return get_process(p)
    if isinstance(p, FailureProcess):
        return p
    raise TypeError(f"not a failure process: {p!r}")


_vgamma = np.vectorize(math.gamma, otypes=[np.float64])


def _gamma1p(x):
    """Gamma(1 + x), elementwise (host, scipy-free)."""
    out = _vgamma(1.0 + np.asarray(x, dtype=np.float64))
    return out if out.ndim else float(out)
