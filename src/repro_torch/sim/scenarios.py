"""Scenario catalog + parameter grids for the batched layers.

A :class:`Scenario` is one named (checkpoint, power) operating point: the
paper's figure setups and the §4 exascale scenarios live in one registry.
A :class:`ParamGrid` is the struct-of-arrays form the batched sweep and
engine consume: the nine resilience/power parameters as broadcast f64
tensors of one shape, on one device.  :class:`MultilevelParamGrid` is its
two-level (buddy + PFS) counterpart, with the :class:`MultilevelScenario`
family it stacks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import F64, resolve_device
from ..core.failures import (FailureProcess, Weibull, as_process,
                             get_process)
from ..core.params import (CheckpointParams, MultilevelCheckpointParams,
                           MultilevelPowerParams, PowerParams,
                           EXASCALE_ML_POWER, EXASCALE_POWER_RHO55,
                           EXASCALE_POWER_RHO7, MU_IND_JAGUAR_MIN)


# ---------------------------------------------------------------------------
# Scenario: one named operating point
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    ckpt: CheckpointParams
    power: PowerParams
    T_base: float = 1.0
    description: str = ""
    #: inter-failure distribution; None = the paper's exponential process.
    process: Optional[FailureProcess] = None


_REGISTRY: Dict[str, Callable[..., Scenario]] = {}


def register_scenario(name: str):
    """Decorator: register a named Scenario constructor."""
    def deco(fn: Callable[..., Scenario]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_scenario(name: str, **kwargs) -> Scenario:
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"one of {sorted(_REGISTRY)}") from None
    return ctor(**kwargs)


def list_scenarios() -> dict:
    """name -> first docstring line of each registered constructor."""
    return {n: (fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__ else ""
            for n, fn in sorted(_REGISTRY.items())}


@register_scenario("fig12")
def fig12(mu_min: float = 300.0, rho: float = 5.5,
          alpha: float = 1.0) -> Scenario:
    """Figures 1-2: C=R=10 min, D=1 min, omega=1/2; power from target rho."""
    ck = CheckpointParams(C=10.0, R=10.0, D=1.0, mu=mu_min, omega=0.5)
    pw = PowerParams.from_rho(rho=rho, alpha=alpha)
    return Scenario(name=f"fig12(mu={mu_min:g},rho={rho:g})", ckpt=ck,
                    power=pw, description="paper Figures 1-2 setup")


@register_scenario("fig3")
def fig3(n_nodes: float = 1.0e6, rho: float = 5.5) -> Scenario:
    """Figure 3: C=R=1 min, D=0.1 min, omega=1/2, mu=120 min @ 1e6 nodes."""
    mu = 120.0 * (1.0e6 / float(n_nodes))
    ck = CheckpointParams(C=1.0, R=1.0, D=0.1, mu=mu, omega=0.5)
    pw = EXASCALE_POWER_RHO55 if abs(rho - 5.5) < 1e-9 else (
        EXASCALE_POWER_RHO7 if abs(rho - 7.0) < 1e-9
        else PowerParams.from_rho(rho=rho, alpha=1.0))
    return Scenario(name=f"fig3(N={n_nodes:g},rho={rho:g})", ckpt=ck,
                    power=pw, description="paper Figure 3 scalability setup")


@register_scenario("exascale_rho55")
def exascale_rho55(mu_min: float = 300.0) -> Scenario:
    """Exascale scenario #1: 20 mW/node, half static (rho = 5.5)."""
    ck = CheckpointParams(C=10.0, R=10.0, D=1.0, mu=mu_min, omega=0.5)
    return Scenario(name=f"exascale_rho55(mu={mu_min:g})", ckpt=ck,
                    power=EXASCALE_POWER_RHO55,
                    description="paper §4 Exascale power scenario, rho=5.5")


@register_scenario("exascale_rho7")
def exascale_rho7(mu_min: float = 300.0) -> Scenario:
    """Exascale scenario #2: P_static = 5 mW, same overheads (rho = 7)."""
    ck = CheckpointParams(C=10.0, R=10.0, D=1.0, mu=mu_min, omega=0.5)
    return Scenario(name=f"exascale_rho7(mu={mu_min:g})", ckpt=ck,
                    power=EXASCALE_POWER_RHO7,
                    description="paper §4 Exascale power scenario, rho=7")


@register_scenario("jaguar")
def jaguar(n_nodes: int = 45208, C: float = 10.0, R: float = 10.0,
           D: float = 1.0, omega: float = 0.5) -> Scenario:
    """Jaguar-derived platform: mu_ind ~ 125 years, mu = mu_ind / N."""
    ck = CheckpointParams(C=C, R=R, D=D,
                          mu=MU_IND_JAGUAR_MIN / float(n_nodes), omega=omega)
    return Scenario(name=f"jaguar(N={n_nodes})", ckpt=ck,
                    power=EXASCALE_POWER_RHO55,
                    description="Jaguar per-proc MTBF scaled to N units")


@register_scenario("robustness")
def robustness(base: str = "exascale_rho55", process: str = "weibull",
               shape: float = 0.7, sigma: float = 1.0,
               trace=None, **base_kwargs) -> Scenario:
    """Any registered scenario under a non-exponential failure process."""
    sc = get_scenario(base, **base_kwargs)
    if process == "weibull":
        proc: FailureProcess = get_process("weibull", shape=shape)
        tag = f"weibull(k={shape:g})"
    elif process == "lognormal":
        proc = get_process("lognormal", sigma=sigma)
        tag = f"lognormal(sigma={sigma:g})"
    elif process == "trace":
        if trace is None:
            raise ValueError("process='trace' needs trace=[gaps...]")
        proc = get_process("trace", gaps=tuple(trace))
        tag = f"trace(n={len(proc.gaps)})"
    else:
        proc = as_process(process)
        tag = proc.name
    return Scenario(name=f"robustness[{sc.name}, {tag}]", ckpt=sc.ckpt,
                    power=sc.power, T_base=sc.T_base, process=proc,
                    description=f"{sc.description or sc.name} under "
                                f"{tag} failures")


# -- per-architecture instantiation (production mesh) ------------------------

#: optimizer state = bf16 params + bf16 momentum + f32 master copy.
STATE_BYTES_PER_PARAM = 2 + 2 + 4


def _arch_checkpoint_seconds(arch: str, hosts: int, bw: float) -> float:
    from ..configs import get_config
    from ..models import build
    n = build(get_config(arch)).param_count()
    return n * STATE_BYTES_PER_PARAM / (hosts * bw)


@register_scenario("arch")
def arch(arch: str = "dbrx-132b", hosts: int = 64, bw: float = 8e9,
         n_nodes: int = 256, D_s: float = 60.0, omega: float = 0.5,
         profile: str = "paper") -> Scenario:
    """One production architecture: C from checkpoint bytes / host I/O bw."""
    from ..energy import PAPER_EXASCALE_PROFILE, TPU_V5E_HOST_PROFILE
    mu_ind_s = 125.0 * 365 * 24 * 3600          # Jaguar-derived per-unit MTBF
    C = _arch_checkpoint_seconds(arch, hosts, bw)
    ck = CheckpointParams(C=C, R=C, D=D_s, mu=mu_ind_s / n_nodes, omega=omega)
    pw = (PAPER_EXASCALE_PROFILE if profile == "paper"
          else TPU_V5E_HOST_PROFILE).power_params()
    return Scenario(name=f"arch({arch})", ckpt=ck, power=pw,
                    description=f"{arch} on the production mesh "
                                f"({hosts} hosts @ {bw:g} B/s)")


# ---------------------------------------------------------------------------
# ParamGrid: struct-of-tensors parameter batches
# ---------------------------------------------------------------------------

_FIELDS = ("C", "R", "D", "mu", "omega",
           "P_static", "P_cal", "P_io", "P_down")


@dataclasses.dataclass(frozen=True)
class ParamGrid:
    """Broadcast f64 tensors of checkpoint + power parameters, one device.

    All nine fields share one shape after construction.  Fields given as
    numbers or arrays go to the device of the fields given as tensors; with
    no tensor field at all the grid lands on the default ``"cuda"`` device
    (use the ``device=`` of the constructors below to choose).
    """

    C: torch.Tensor
    R: torch.Tensor
    D: torch.Tensor
    mu: torch.Tensor
    omega: torch.Tensor
    P_static: torch.Tensor
    P_cal: torch.Tensor
    P_io: torch.Tensor
    P_down: torch.Tensor

    def __post_init__(self):
        vals = [getattr(self, f) for f in _FIELDS]
        dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
                   None)
        dev = resolve_device("cuda" if dev is None else dev)
        arrs = torch.broadcast_tensors(
            *(torch.as_tensor(v, dtype=F64, device=dev) for v in vals))
        for f, a in zip(_FIELDS, arrs):
            object.__setattr__(self, f, a.contiguous())

    # -- shape plumbing ------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self.C.shape)

    @property
    def size(self) -> int:
        return self.C.numel()

    @property
    def device(self) -> torch.device:
        return self.C.device

    def ravel(self) -> "ParamGrid":
        return ParamGrid(**{f: getattr(self, f).reshape(-1) for f in _FIELDS})

    def reshape(self, shape) -> "ParamGrid":
        return ParamGrid(**{f: getattr(self, f).reshape(shape)
                            for f in _FIELDS})

    def to(self, device) -> "ParamGrid":
        dev = resolve_device(device)
        return ParamGrid(**{f: getattr(self, f).to(dev) for f in _FIELDS})

    def take(self, idx) -> "ParamGrid":
        """The flat grid restricted to raveled points ``idx``."""
        flat = self.ravel()
        return ParamGrid(**{f: getattr(flat, f)[idx] for f in _FIELDS})

    def fields(self) -> dict:
        """Dict-of-tensors view."""
        return {f: getattr(self, f) for f in _FIELDS}

    # -- derived (paper §3) --------------------------------------------------
    @property
    def a(self) -> torch.Tensor:
        return (1.0 - self.omega) * self.C

    @property
    def b(self) -> torch.Tensor:
        return 1.0 - (self.D + self.R + self.omega * self.C) / self.mu

    def period_bounds(self) -> tuple:
        """(lo, hi) of the raw valid-period interval per grid point."""
        return torch.maximum(self.a, self.C), 2.0 * self.mu * self.b

    def valid(self) -> torch.Tensor:
        """Non-degenerate mask."""
        lo, hi = self.period_bounds()
        return hi > lo * (1.0 + 1e-9)

    @property
    def rho(self) -> torch.Tensor:
        return (self.P_static + self.P_io) / (self.P_static + self.P_cal)

    # -- object views --------------------------------------------------------
    def ckpt_at(self, idx) -> CheckpointParams:
        return CheckpointParams(C=float(self.C[idx]), R=float(self.R[idx]),
                                D=float(self.D[idx]), mu=float(self.mu[idx]),
                                omega=float(self.omega[idx]))

    def power_at(self, idx) -> PowerParams:
        return PowerParams(P_static=float(self.P_static[idx]),
                           P_cal=float(self.P_cal[idx]),
                           P_io=float(self.P_io[idx]),
                           P_down=float(self.P_down[idx]))

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_params(cls, ckpt: CheckpointParams, power: PowerParams,
                    device="cuda") -> "ParamGrid":
        t = lambda x: torch.tensor(x, dtype=F64, device=resolve_device(device))
        return cls(C=t(ckpt.C), R=t(ckpt.R), D=t(ckpt.D), mu=t(ckpt.mu),
                   omega=t(ckpt.omega), P_static=t(power.P_static),
                   P_cal=t(power.P_cal), P_io=t(power.P_io),
                   P_down=t(power.P_down))


def _col(xs, device) -> torch.Tensor:
    return torch.tensor(np.asarray(xs, dtype=np.float64), dtype=F64,
                        device=resolve_device(device))


def grid_from_scenarios(scens: Iterable[Scenario],
                        device="cuda") -> ParamGrid:
    """Stack scenarios along one leading axis (shape ``(len(scens),)``)."""
    scens = list(scens)
    c = lambda xs: _col(xs, device)
    return ParamGrid(
        C=c([s.ckpt.C for s in scens]), R=c([s.ckpt.R for s in scens]),
        D=c([s.ckpt.D for s in scens]), mu=c([s.ckpt.mu for s in scens]),
        omega=c([s.ckpt.omega for s in scens]),
        P_static=c([s.power.P_static for s in scens]),
        P_cal=c([s.power.P_cal for s in scens]),
        P_io=c([s.power.P_io for s in scens]),
        P_down=c([s.power.P_down for s in scens]))


def product_grid(ckpts: Sequence[CheckpointParams],
                 powers: Sequence[PowerParams], device="cuda") -> ParamGrid:
    """Outer product grid of shape ``(len(ckpts), len(powers))``."""
    col = lambda xs: _col(xs, device)[:, None]
    row = lambda xs: _col(xs, device)[None, :]
    return ParamGrid(
        C=col([c.C for c in ckpts]), R=col([c.R for c in ckpts]),
        D=col([c.D for c in ckpts]), mu=col([c.mu for c in ckpts]),
        omega=col([c.omega for c in ckpts]),
        P_static=row([p.P_static for p in powers]),
        P_cal=row([p.P_cal for p in powers]),
        P_io=row([p.P_io for p in powers]),
        P_down=row([p.P_down for p in powers]))


def mu_rho_grid(mus: Sequence[float], rhos: Sequence[float],
                alpha: float = 1.0, device="cuda") -> ParamGrid:
    """Figures 1-2 grid: fig12 resilience x powers at target rho values."""
    ckpts = [get_scenario("fig12", mu_min=float(m)).ckpt for m in mus]
    powers = [PowerParams.from_rho(rho=float(r), alpha=alpha) for r in rhos]
    return product_grid(ckpts, powers, device)


def nodes_grid(n_nodes: Sequence[float], power: PowerParams,
               device="cuda") -> ParamGrid:
    """Figure 3 grid: scalability in N at one power scenario (1-D)."""
    ckpts = [get_scenario("fig3", n_nodes=float(n)).ckpt for n in n_nodes]
    return product_grid(ckpts, [power], device).reshape((len(ckpts),))


def arch_grid(archs: Optional[Sequence[str]] = None, device="cuda",
              **kwargs) -> ParamGrid:
    """All (or the named) production architectures as one 1-D grid."""
    if archs is None:
        from ..configs import ALL_ARCHS
        archs = [c.name for c in ALL_ARCHS]
    return grid_from_scenarios((get_scenario("arch", arch=a, **kwargs)
                                for a in archs), device)


def robustness_grid(shapes: Sequence[float], mu_mins: Sequence[float],
                    base: str = "exascale_rho55", device="cuda",
                    ) -> Tuple[ParamGrid, Weibull]:
    """Weibull-shape x platform-MTBF grid over an exascale scenario family,
    plus the Weibull process whose ``shape`` array has one k per row."""
    scens = [get_scenario(base, mu_min=float(m)) for m in mu_mins]
    row = grid_from_scenarios(scens, device)
    shp = (len(shapes), len(mu_mins))
    grid = ParamGrid(**{f: torch.broadcast_to(getattr(row, f), shp)
                        for f in _FIELDS})
    shape_arr = np.broadcast_to(
        np.asarray(shapes, dtype=np.float64)[:, None], shp)
    return grid, Weibull(shape=shape_arr)


# ---------------------------------------------------------------------------
# Multilevel (buddy + PFS) scenarios and grids
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultilevelScenario:
    """One named two-level operating point (buddy + PFS)."""

    name: str
    ckpt: MultilevelCheckpointParams
    power: MultilevelPowerParams
    T_base: float = 1.0
    description: str = ""


@register_scenario("multilevel_exascale")
def multilevel_exascale(mu_min: float = 300.0, buddy_ratio: float = 0.1,
                        q: float = 0.1, C_pfs: float = 10.0,
                        P_io1: float = 20.0) -> MultilevelScenario:
    """Exascale two-level: buddy RAM checkpoints at ``buddy_ratio * C_PFS``."""
    C1 = buddy_ratio * C_pfs
    ck = MultilevelCheckpointParams(C1=C1, R1=C1, C2=C_pfs, R2=C_pfs,
                                    D1=0.5, D2=1.0, mu=mu_min, q=q,
                                    omega=0.5)
    pw = MultilevelPowerParams(P_static=10.0, P_cal=10.0, P_io1=P_io1,
                               P_io2=100.0)
    return MultilevelScenario(
        name=f"multilevel_exascale(mu={mu_min:g},ratio={buddy_ratio:g},"
             f"q={q:g})",
        ckpt=ck, power=pw,
        description="Exascale buddy+PFS hierarchy (VELOC-style)")


@register_scenario("multilevel_fig12")
def multilevel_fig12(mu_min: float = 300.0, buddy_ratio: float = 0.1,
                     q: float = 0.1) -> MultilevelScenario:
    """Figures 1-2 resilience setup lifted to two levels (C2=R2=10, D2=1)."""
    ck = MultilevelCheckpointParams(
        C1=10.0 * buddy_ratio, R1=10.0 * buddy_ratio, C2=10.0, R2=10.0,
        D1=1.0, D2=1.0, mu=mu_min, q=q, omega=0.5)
    return MultilevelScenario(
        name=f"multilevel_fig12(mu={mu_min:g})", ckpt=ck,
        power=EXASCALE_ML_POWER,
        description="paper Fig. 1-2 setup with a buddy fast level")


@register_scenario("multilevel_arch")
def multilevel_arch(arch: str = "dbrx-132b", hosts: int = 64,
                    pfs_bw: float = 8e9, buddy_bw: float = 80e9,
                    n_nodes: int = 256, D_s: float = 60.0,
                    omega: float = 0.5, q: float = 0.05,
                    ) -> MultilevelScenario:
    """One production architecture, two-level: C1 from NIC RAM-to-RAM buddy
    bandwidth, C2 from PFS bandwidth; hard failures need a node swap-in."""
    mu_ind_s = 125.0 * 365 * 24 * 3600
    C2 = _arch_checkpoint_seconds(arch, hosts, pfs_bw)
    C1 = _arch_checkpoint_seconds(arch, hosts, buddy_bw)
    ck = MultilevelCheckpointParams(C1=C1, R1=C1, C2=C2, R2=C2,
                                    D1=D_s / 10.0, D2=D_s,
                                    mu=mu_ind_s / n_nodes, q=q, omega=omega)
    from ..energy import PAPER_EXASCALE_PROFILE
    base = PAPER_EXASCALE_PROFILE.power_params()
    pw = MultilevelPowerParams(P_static=base.P_static, P_cal=base.P_cal,
                               P_io1=0.2 * base.P_io, P_io2=base.P_io,
                               P_down=base.P_down)
    return MultilevelScenario(
        name=f"multilevel_arch({arch})", ckpt=ck, power=pw,
        description=f"{arch} with buddy NIC level ({buddy_bw:g} B/s) over "
                    f"PFS ({pfs_bw:g} B/s)")


_ML_FIELDS = ("C1", "R1", "D1", "C2", "R2", "D2", "mu", "omega", "q",
              "P_static", "P_cal", "P_io1", "P_io2", "P_down",
              "omega1", "omega2")


@dataclasses.dataclass(frozen=True)
class MultilevelParamGrid:
    """Broadcast f64 tensors of two-level checkpoint + power parameters,
    one device.

    The plumbing of :class:`ParamGrid` with per-level (C_k, R_k, D_k,
    P_io_k) fields and the buddy-loss probability ``q``; the cadence ``m``
    is a decision variable of the solvers and the engine, not a field.
    ``omega1``/``omega2`` (buddy write / deep flush overlap) default to
    ``omega``; wherever they are equal the derived quantities take the
    exact shared-omega expressions.
    """

    C1: torch.Tensor
    R1: torch.Tensor
    D1: torch.Tensor
    C2: torch.Tensor
    R2: torch.Tensor
    D2: torch.Tensor
    mu: torch.Tensor
    omega: torch.Tensor
    q: torch.Tensor
    P_static: torch.Tensor
    P_cal: torch.Tensor
    P_io1: torch.Tensor
    P_io2: torch.Tensor
    P_down: torch.Tensor
    omega1: Optional[torch.Tensor] = None
    omega2: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.omega1 is None:
            object.__setattr__(self, "omega1", self.omega)
        if self.omega2 is None:
            object.__setattr__(self, "omega2", self.omega)
        vals = [getattr(self, f) for f in _ML_FIELDS]
        dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
                   None)
        dev = resolve_device("cuda" if dev is None else dev)
        arrs = torch.broadcast_tensors(
            *(torch.as_tensor(v, dtype=F64, device=dev) for v in vals))
        for f, a in zip(_ML_FIELDS, arrs):
            object.__setattr__(self, f, a.contiguous())

    # -- shape plumbing ------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self.C1.shape)

    @property
    def size(self) -> int:
        return self.C1.numel()

    @property
    def device(self) -> torch.device:
        return self.C1.device

    def ravel(self) -> "MultilevelParamGrid":
        return MultilevelParamGrid(**{f: getattr(self, f).reshape(-1)
                                      for f in _ML_FIELDS})

    def reshape(self, shape) -> "MultilevelParamGrid":
        return MultilevelParamGrid(**{f: getattr(self, f).reshape(shape)
                                      for f in _ML_FIELDS})

    def to(self, device) -> "MultilevelParamGrid":
        dev = resolve_device(device)
        return MultilevelParamGrid(**{f: getattr(self, f).to(dev)
                                      for f in _ML_FIELDS})

    def take(self, idx) -> "MultilevelParamGrid":
        """The flat grid restricted to raveled points ``idx``."""
        flat = self.ravel()
        return MultilevelParamGrid(**{f: getattr(flat, f)[idx]
                                      for f in _ML_FIELDS})

    def fields(self) -> dict:
        """Dict-of-tensors view."""
        return {f: getattr(self, f) for f in _ML_FIELDS}

    # -- per-m derived (the multilevel §3.1 analogue) ------------------------
    def C_mean(self, m) -> torch.Tensor:
        return ((m - 1) * self.C1 + self.C2) / m

    def _shared_omega(self) -> torch.Tensor:
        return self.omega1 == self.omega2

    def C_omega_mean(self, m) -> torch.Tensor:
        per = ((m - 1) * self.omega1 * self.C1
               + self.omega2 * self.C2) / m
        return torch.where(self._shared_omega(),
                           self.omega1 * self.C_mean(m), per)

    def a(self, m) -> torch.Tensor:
        per = ((m - 1) * (1.0 - self.omega1) * self.C1
               + (1.0 - self.omega2) * self.C2) / m
        return torch.where(self._shared_omega(),
                           (1.0 - self.omega1) * self.C_mean(m), per)

    def b(self, m) -> torch.Tensor:
        soft = self.D1 + self.R1 + self.C_omega_mean(m)
        hard = self.D2 + self.R2 + self.omega2 * self.C2
        return 1.0 - (soft + self.q * (hard - soft)) / self.mu

    def mu_eff(self, m) -> torch.Tensor:
        return self.mu / (1.0 + self.q * (m - 1))

    def period_bounds(self, m) -> tuple:
        """(lo, hi) of the raw valid-period interval at cadence ``m``."""
        lo = torch.maximum(torch.maximum(self.a(m), self.C1), self.C2)
        return lo, 2.0 * self.mu_eff(m) * self.b(m)

    def valid(self, m) -> torch.Tensor:
        lo, hi = self.period_bounds(m)
        return hi > lo * (1.0 + 1e-9)

    # -- object views --------------------------------------------------------
    def ckpt_at(self, idx) -> MultilevelCheckpointParams:
        g = lambda f: float(getattr(self, f)[idx])
        return MultilevelCheckpointParams(
            C1=g("C1"), R1=g("R1"), C2=g("C2"), R2=g("R2"), D1=g("D1"),
            D2=g("D2"), mu=g("mu"), q=g("q"), omega=g("omega"),
            omega1=g("omega1"), omega2=g("omega2"))

    def power_at(self, idx) -> MultilevelPowerParams:
        g = lambda f: float(getattr(self, f)[idx])
        return MultilevelPowerParams(P_static=g("P_static"),
                                     P_cal=g("P_cal"), P_io1=g("P_io1"),
                                     P_io2=g("P_io2"), P_down=g("P_down"))

    # -- constructors / conversions -----------------------------------------
    @classmethod
    def from_params(cls, ckpt: MultilevelCheckpointParams,
                    power: MultilevelPowerParams,
                    device="cuda") -> "MultilevelParamGrid":
        t = lambda x: torch.tensor(x, dtype=F64, device=resolve_device(device))
        return cls(C1=t(ckpt.C1), R1=t(ckpt.R1), D1=t(ckpt.D1),
                   C2=t(ckpt.C2), R2=t(ckpt.R2), D2=t(ckpt.D2),
                   mu=t(ckpt.mu), omega=t(ckpt.omega), q=t(ckpt.q),
                   P_static=t(power.P_static), P_cal=t(power.P_cal),
                   P_io1=t(power.P_io1), P_io2=t(power.P_io2),
                   P_down=t(power.P_down), omega1=t(ckpt.w1),
                   omega2=t(ckpt.w2))

    @classmethod
    def from_single_level(cls, grid: ParamGrid,
                          q=0.0) -> "MultilevelParamGrid":
        """Degenerate lift of a single-level grid (C1 = C2 and so on), the
        exact m = 1 reduction; on the single-level grid's device."""
        return cls(C1=grid.C, R1=grid.R, D1=grid.D, C2=grid.C, R2=grid.R,
                   D2=grid.D, mu=grid.mu, omega=grid.omega, q=q,
                   P_static=grid.P_static, P_cal=grid.P_cal,
                   P_io1=grid.P_io, P_io2=grid.P_io, P_down=grid.P_down)

    def single_level(self) -> ParamGrid:
        """The PFS-only comparator grid (C=C2, R=R2, D=D2, P_io=P_io2, at
        the deep level's overlap factor)."""
        return ParamGrid(C=self.C2, R=self.R2, D=self.D2, mu=self.mu,
                         omega=self.omega2, P_static=self.P_static,
                         P_cal=self.P_cal, P_io=self.P_io2,
                         P_down=self.P_down)


def multilevel_grid_from_scenarios(scens: Iterable[MultilevelScenario],
                                   device="cuda") -> MultilevelParamGrid:
    """Stack two-level scenarios along one leading axis."""
    scens = list(scens)
    c = lambda xs: _col(xs, device)
    return MultilevelParamGrid(
        **{f: c([getattr(s.ckpt, f) for s in scens])
           for f in ("C1", "R1", "D1", "C2", "R2", "D2", "mu", "omega", "q")},
        omega1=c([s.ckpt.w1 for s in scens]),
        omega2=c([s.ckpt.w2 for s in scens]),
        **{f: c([getattr(s.power, f) for s in scens])
           for f in ("P_static", "P_cal", "P_io1", "P_io2", "P_down")})


def buddy_ratio_grid(ratios: Sequence[float], qs: Sequence[float],
                     mu_min: float = 300.0, device="cuda",
                     **kwargs) -> MultilevelParamGrid:
    """Figure 4 grid: Exascale buddy-cost ratio x buddy-loss probability,
    shape ``(len(ratios), len(qs))``."""
    scens = [get_scenario("multilevel_exascale", mu_min=mu_min,
                          buddy_ratio=float(r), q=float(q), **kwargs)
             for r in ratios for q in qs]
    return multilevel_grid_from_scenarios(scens, device).reshape(
        (len(ratios), len(qs)))


def multilevel_arch_grid(archs: Optional[Sequence[str]] = None,
                         device="cuda", **kwargs) -> MultilevelParamGrid:
    """All (or the named) production architectures, two-level, 1-D."""
    if archs is None:
        from ..configs import ALL_ARCHS
        archs = [c.name for c in ALL_ARCHS]
    return multilevel_grid_from_scenarios(
        (get_scenario("multilevel_arch", arch=a, **kwargs) for a in archs),
        device)
