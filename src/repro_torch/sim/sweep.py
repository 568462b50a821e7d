"""Batched closed-form model + period solvers over a :class:`ParamGrid`.

Elementwise tensor counterparts of ``core.model`` and ``core.optimal``:
the §3.1/§3.2 expectations, a branchless golden-section minimizer, the
AlgoT closed form, the AlgoE quadratic root (the corrected coefficients of
``optimal.derived_coefficients``) and the Young/Daly/MSK baselines, for a
whole grid at once, chunked to the device-memory budget.

Root selection matches the scalar solver: E' = Q/K with K > 0 on the
valid interval, so the energy minimum is the root of Q where Q' > 0; any
point where that root is missing, complex, out of the bracket, or beaten
by the golden-section argmin falls back to the numeric result.

:func:`evaluate_multilevel_grid` solves the two-level (buddy + PFS)
model for the jointly optimal (T, m) of every grid point, the PFS-only
single-level optimum beside it.

The robustness grids (:func:`evaluate_robustness_grid`,
:func:`evaluate_periods_grid`, :func:`sweep_weibull_shapes`) score the
exponential-assumption periods under a non-exponential process by Monte
Carlo, every candidate on one schedule per grid point
(``engine.simulate_candidates``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .._device import F64, resolve_device
from ..core.failures import as_process
from ..core.params import PowerParams
from . import dispatch as _dispatch
from . import engine as _engine
from . import precision as _precision
from . import scenarios
from .scenarios import MultilevelParamGrid, ParamGrid

_GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0

#: device-memory estimate per grid point of the model sweep (the stacked
#: golden-section state plus its elementwise temporaries, with headroom);
#: sizes the chunks of :func:`evaluate_grid`.
_MODEL_BYTES_PER_POINT = 4096

# p: dict of broadcastable tensors with the ParamGrid field names.


def _ab(p):
    a = (1.0 - p["omega"]) * p["C"]
    b = 1.0 - (p["D"] + p["R"] + p["omega"] * p["C"]) / p["mu"]
    return a, b


def time_final_batched(T, p, T_base=1.0):
    """§3.1: T_final = T_base * T / ((T-a)(b - T/2mu)), elementwise."""
    a, b = _ab(p)
    return T_base * T / ((T - a) * (b - T / (2.0 * p["mu"])))


def _re_exec(T, p):
    C, omega = p["C"], p["omega"]
    return (omega * C + (T**2 - C**2) / (2.0 * T)
            + omega * C**2 / (2.0 * T))


def _io_per_failure(T, p):
    return p["R"] + p["C"]**2 / (2.0 * T)


def energy_final_batched(T, p, T_base=1.0):
    """§3.2: E_final = T_cal P_cal + T_io P_io + T_down P_down + Tf P_static."""
    C, omega = p["C"], p["omega"]
    Tf = time_final_batched(T, p, T_base)
    nf = Tf / p["mu"]
    T_cal = T_base + nf * _re_exec(T, p)
    T_io = T_base * C / (T - (1.0 - omega) * C) + nf * _io_per_failure(T, p)
    T_down = nf * p["D"]
    # Plain left-associated chain under the f64 oracle, Neumaier-compensated
    # under a reduced-precision policy (sim/precision.py).
    return _precision.psum((T_cal * p["P_cal"], T_io * p["P_io"],
                            T_down * p["P_down"], Tf * p["P_static"]))


def _bracket(p):
    """Shrunk (lo, hi, valid) per grid point; degenerate points get a
    harmless placeholder bracket and are masked by ``valid``."""
    a, b = _ab(p)
    lo0 = torch.maximum(a, p["C"])
    hi0 = 2.0 * p["mu"] * b
    valid = hi0 > lo0 * (1.0 + 1e-9)
    hi0 = torch.where(valid, hi0, 2.0 * lo0 + 1.0)
    span = hi0 - lo0
    return lo0 + 1e-9 * span + 1e-12, hi0 - 1e-9 * span, valid


def golden_section_batched(f: Callable, lo, hi, iters: int = 40):
    """Elementwise golden-section argmin of ``f`` on [lo, hi]: the
    branchless form of ``optimal.golden_section``, one batched evaluation
    of ``f`` per iteration."""
    a, b = lo, hi
    c = b - _GOLDEN * (b - a)
    d = a + _GOLDEN * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        left = fc < fd
        a2 = torch.where(left, a, c)
        b2 = torch.where(left, d, b)
        new = torch.where(left, b2 - _GOLDEN * (b2 - a2),
                          a2 + _GOLDEN * (b2 - a2))
        fnew = f(new)
        c, d, fc, fd = (torch.where(left, new, d),
                        torch.where(left, c, new),
                        torch.where(left, fnew, fd),
                        torch.where(left, fc, fnew))
        a, b = a2, b2
    return 0.5 * (a + b)


# ---------------------------------------------------------------------------
# Period solvers
# ---------------------------------------------------------------------------

def _t_opt_time_from(p, t_num):
    """AlgoT closed form, falling back to the supplied numeric argmin."""
    a, b = _ab(p)
    lo, hi, _ = _bracket(p)
    val = 2.0 * a * b * p["mu"]
    t_closed = torch.clamp(torch.sqrt(torch.clamp_min(val, 0.0)), lo, hi)
    return torch.where(val > 0.0, t_closed, t_num)


def t_opt_time_batched(p, T_base=1.0):
    """AlgoT, Eq. (1) closed form; numeric fallback where it degenerates;
    NaN at degenerate grid points."""
    lo, hi, valid = _bracket(p)
    t_num = golden_section_batched(
        lambda t: time_final_batched(t, p, T_base), lo, hi)
    return torch.where(valid, _t_opt_time_from(p, t_num), math.nan)


def _energy_quadratic(p):
    """Vectorized corrected coefficients (``optimal.derived_coefficients``)."""
    a, b = _ab(p)
    C, mu, omega = p["C"], p["mu"], p["omega"]
    al = p["P_cal"] / p["P_static"]
    be = p["P_io"] / p["P_static"]
    ga = p["P_down"] / p["P_static"]
    P = al * omega * C + be * p["R"] + ga * p["D"]
    Q = (be - al * (1.0 - omega)) * C**2
    c2 = (1.0 / (2.0 * mu) + P / (2.0 * mu**2) + al * b / (2.0 * mu)
          + (al * a - be * C) / (4.0 * mu**2))
    c1 = (be * C - al * a) * b / mu + Q / (2.0 * mu**2)
    c0 = (-a * b * (P + mu) / mu - be * C * b**2
          - Q * (b / (2.0 * mu) + a / (4.0 * mu**2)))
    return c2, c1, c0


def _t_opt_energy_from(p, T_base, t_num):
    """AlgoE quadratic root, guarded by the supplied numeric argmin."""
    lo, hi, _ = _bracket(p)
    c2, c1, c0 = _energy_quadratic(p)

    disc = c1**2 - 4.0 * c2 * c0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    safe_c2 = torch.where(torch.abs(c2) > 1e-300, c2, 1.0)
    r1 = (-c1 - sq) / (2.0 * safe_c2)
    r2 = (-c1 + sq) / (2.0 * safe_c2)
    safe_c1 = torch.where(torch.abs(c1) > 1e-300, c1, 1.0)
    rlin = -c0 / safe_c1

    def is_min_root(r):
        # E'' sign at a root of E' equals the sign of Q' (K > 0 in-bracket).
        return ((disc >= 0.0) & (torch.abs(c2) > 1e-300)
                & (r > lo) & (r < hi) & (2.0 * c2 * r + c1 > 0.0))

    lin_ok = (torch.abs(c2) <= 1e-300) & (torch.abs(c1) > 1e-300) \
        & (rlin > lo) & (rlin < hi) & (c1 > 0.0)

    t_root = torch.where(is_min_root(r1), r1,
                         torch.where(is_min_root(r2), r2,
                                     torch.where(lin_ok, rlin, t_num)))
    # Never return a root whose energy loses to the numeric argmin.
    e_root = energy_final_batched(t_root, p, T_base)
    e_num = energy_final_batched(t_num, p, T_base)
    return torch.where(e_root <= e_num * (1.0 + 1e-9), t_root, t_num)


def t_opt_energy_batched(p, T_base=1.0):
    """AlgoE: minimum-branch quadratic root, numeric fallback elementwise;
    NaN at degenerate grid points."""
    lo, hi, valid = _bracket(p)
    t_num = golden_section_batched(
        lambda t: energy_final_batched(t, p, T_base), lo, hi)
    return torch.where(valid, _t_opt_energy_from(p, T_base, t_num), math.nan)


def t_young_batched(p):
    return torch.sqrt(2.0 * p["C"] * p["mu"]) + p["C"]


def t_daly_batched(p):
    return torch.sqrt(2.0 * p["C"] * (p["mu"] + p["D"] + p["R"])) + p["C"]


def _msk_energy(T, p0, T_base=1.0):
    """MSK objective on the omega=0 parameter set (paper §3.2 side note)."""
    C, R = p0["C"], p0["R"]
    Tf = time_final_batched(T, p0, T_base)
    nf = Tf / p0["mu"]
    T_cal = T_base + nf * (T - 2.0 * C) / 2.0
    T_io = T_base * C / (T - C) + nf * (R + C)
    T_down = nf * p0["D"]
    return _precision.psum((T_cal * p0["P_cal"], T_io * p0["P_io"],
                            T_down * p0["P_down"], Tf * p0["P_static"]))


def _msk_setup(p):
    """(omega=0 params, lo, hi, valid) for the MSK numeric argmin."""
    p0 = dict(p)
    p0["omega"] = torch.zeros_like(p["omega"])
    lo, hi, valid = _bracket(p0)
    return p0, torch.maximum(lo, 2.0 * p0["C"] + 1e-12), hi, valid


def t_msk_energy_batched(p, T_base=1.0):
    """MSK energy-optimal period; NaN at degenerate points."""
    p0, lo, hi, valid = _msk_setup(p)
    t = golden_section_batched(lambda t: _msk_energy(t, p0, T_base), lo, hi)
    return torch.where(valid, t, math.nan)


# ---------------------------------------------------------------------------
# Grid evaluation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridResult:
    """Periods/ratios for a whole grid; tensors of ``grid.shape`` on the
    grid's device.

    Degenerate points (``~valid``) carry T_time = T_energy = T_msk = C and
    ratios of exactly 1.0; their Tf_*/E_* are NaN.
    """

    grid: ParamGrid
    T_base: float
    T_time: torch.Tensor         # AlgoT period
    T_energy: torch.Tensor       # AlgoE period
    T_young: torch.Tensor
    T_daly: torch.Tensor
    T_msk: torch.Tensor
    Tf_time: torch.Tensor        # T_final at the AlgoT period
    Tf_energy: torch.Tensor      # T_final at the AlgoE period
    E_time: torch.Tensor         # E_final at the AlgoT period
    E_energy: torch.Tensor       # E_final at the AlgoE period
    time_ratio: torch.Tensor     # Tf_energy / Tf_time  (>= 1, "loss")
    energy_ratio: torch.Tensor   # E_time / E_energy    (>= 1, "gain")
    valid: torch.Tensor

    @property
    def energy_saving(self) -> torch.Tensor:
        return 1.0 - 1.0 / self.energy_ratio

    @property
    def time_overhead(self) -> torch.Tensor:
        return self.time_ratio - 1.0


_FIELD_ORDER = ("C", "R", "D", "mu", "omega",
                "P_static", "P_cal", "P_io", "P_down")
_OUT_ORDER = ("T_time", "T_energy", "T_young", "T_daly", "T_msk",
              "Tf_time", "Tf_energy", "E_time", "E_energy",
              "time_ratio", "energy_ratio", "valid")


def _evaluate_core(P, T_base):
    """All outputs of :func:`evaluate_grid` for one stacked (9, N) chunk,
    as a (12, N) tensor of P's dtype."""
    p = dict(zip(_FIELD_ORDER, P))
    lo, hi, valid = _bracket(p)
    p0, lo_m, hi_m, _ = _msk_setup(p)

    # The three numeric argmins (AlgoT fallback, AlgoE guard, MSK) share
    # ONE golden-section loop over a stacked leading axis; each row
    # evaluates its own objective.
    def objective(t):
        return torch.stack([time_final_batched(t[0], p, T_base),
                            energy_final_batched(t[1], p, T_base),
                            _msk_energy(t[2], p0, T_base)])

    t_num = golden_section_batched(objective,
                                   torch.stack([lo, lo, lo_m]),
                                   torch.stack([hi, hi, hi_m]))
    Tt = _t_opt_time_from(p, t_num[0])
    Te = _t_opt_energy_from(p, T_base, t_num[1])
    Ty = t_young_batched(p)
    Td = t_daly_batched(p)
    Tm = t_num[2]
    Tf_t = time_final_batched(Tt, p, T_base)
    Tf_e = time_final_batched(Te, p, T_base)
    E_t = energy_final_batched(Tt, p, T_base)
    E_e = energy_final_batched(Te, p, T_base)
    C = p["C"]
    return torch.stack([torch.where(valid, Tt, C),
                        torch.where(valid, Te, C),
                        Ty, Td,
                        torch.where(valid, Tm, C),
                        torch.where(valid, Tf_t, math.nan),
                        torch.where(valid, Tf_e, math.nan),
                        torch.where(valid, E_t, math.nan),
                        torch.where(valid, E_e, math.nan),
                        torch.where(valid, Tf_e / Tf_t, 1.0),
                        torch.where(valid, E_t / E_e, 1.0),
                        valid.to(C.dtype)])


def evaluate_grid(grid: ParamGrid, T_base: float = 1.0, dispatch=None,
                  precision=None, device="cuda") -> GridResult:
    """Periods + time/energy ratios for every grid point, on ``device``.

    The grid axis is cut into one piece a device of the sweep mesh
    (``dispatch`` is a :class:`~repro_torch.sim.dispatch.DispatchConfig`;
    None = environment defaults; one piece on the CPU), each piece into
    chunks that fit the device-memory budget, and the results are gathered
    on ``device``; the computation is elementwise, so neither the split nor
    the chunk size changes results.  ``precision`` selects the
    :class:`~repro_torch.sim.precision.PrecisionPolicy` (None = config /
    env / device default): a reduced-precision policy computes in its dtype
    with compensated energy sums and returns f64 tensors.
    """
    dev = resolve_device(device)
    pol = _dispatch.resolve_precision(dispatch, precision, dev)
    flat = grid.ravel().to(dev)
    P = torch.stack([getattr(flat, f) for f in _FIELD_ORDER])
    raw = torch.empty((len(_OUT_ORDER), flat.size), dtype=F64, device=dev)
    with _precision.use_policy(pol):
        for d, lo, hi in _dispatch.pieces(
                flat.size, _dispatch.split_devices(dispatch, dev)):
            Pd = P[:, lo:hi].to(d)
            with _dispatch.on_device(d):
                for start, stop in _dispatch.chunk_plan(
                        hi - lo, _MODEL_BYTES_PER_POINT, dispatch):
                    raw[:, lo + start:lo + stop] = _evaluate_core(
                        pol.cast(Pd[:, start:stop]), float(T_base)).to(dev)
    out = {k: raw[i].reshape(grid.shape) for i, k in enumerate(_OUT_ORDER)}
    out["valid"] = out["valid"] > 0.5
    return GridResult(grid=grid, T_base=float(T_base), **out)


# ---------------------------------------------------------------------------
# Figure-level conveniences
# ---------------------------------------------------------------------------

def sweep_rho_grid(rhos: Sequence[float], mu_minutes: float,
                   alpha: float = 1.0, device="cuda",
                   precision=None) -> GridResult:
    """Figure 1: rho swept at one MTBF (grid shape ``(1, len(rhos))``)."""
    return evaluate_grid(scenarios.mu_rho_grid([mu_minutes], rhos, alpha,
                                               device), precision=precision,
                         device=device)


def sweep_mu_rho_grid(mus: Sequence[float], rhos: Sequence[float],
                      alpha: float = 1.0, device="cuda",
                      precision=None) -> GridResult:
    """Figure 2: the (mu x rho) ratio surfaces in one call."""
    return evaluate_grid(scenarios.mu_rho_grid(mus, rhos, alpha, device),
                         precision=precision, device=device)


def sweep_nodes_grid(n_nodes: Sequence[float], power: PowerParams,
                     device="cuda", precision=None) -> GridResult:
    """Figure 3: scalability in N at one power scenario."""
    return evaluate_grid(scenarios.nodes_grid(n_nodes, power, device),
                         precision=precision, device=device)


# ---------------------------------------------------------------------------
# Multilevel (buddy + PFS): jointly optimal (T, m) for a whole grid
# ---------------------------------------------------------------------------

#: device-memory estimate per (grid point, candidate cadence) of the
#: multilevel sweep (the stacked golden-section state per m plus the by-m
#: outputs, with headroom); sizes the chunks of
#: :func:`evaluate_multilevel_grid`.
_ML_BYTES_PER_POINT_M = 2048


def _ml_omega_terms(p, m):
    """(w1, w2, Cw, S2, S2w): the per-level overlap aggregates.

    Where the two overlap factors coincide the shared-omega expressions
    are evaluated as written (bit for bit with the scalar
    ``MultilevelCheckpointParams`` branches).  ``omega1``/``omega2`` fall
    back to ``omega`` when a plain parameter dict omits them.
    """
    C1, C2 = p["C1"], p["C2"]
    w1 = p.get("omega1", p["omega"])
    w2 = p.get("omega2", p["omega"])
    shared = w1 == w2
    Cb = ((m - 1.0) * C1 + C2) / m
    S2 = ((m - 1.0) * C1**2 + C2**2) / m
    Cw = torch.where(shared, w1 * Cb, ((m - 1.0) * w1 * C1 + w2 * C2) / m)
    S2w = torch.where(shared, w1 * S2,
                      ((m - 1.0) * w1 * C1**2 + w2 * C2**2) / m)
    return w1, w2, Cw, S2, S2w


def _ml_derived(p, m):
    """(C_mean, a_m, b_m, mu_m) of the multilevel §3.1 analogue."""
    Cb = ((m - 1.0) * p["C1"] + p["C2"]) / m
    w1, w2, Cw, _, _ = _ml_omega_terms(p, m)
    a = torch.where(w1 == w2, (1.0 - w1) * Cb,
                    ((m - 1.0) * (1.0 - w1) * p["C1"]
                     + (1.0 - w2) * p["C2"]) / m)
    soft = p["D1"] + p["R1"] + Cw
    hard = p["D2"] + p["R2"] + w2 * p["C2"]
    b = 1.0 - (soft + p["q"] * (hard - soft)) / p["mu"]
    mu_m = p["mu"] / (1.0 + p["q"] * (m - 1.0))
    return Cb, a, b, mu_m


def ml_time_final_batched(T, m, p, T_base=1.0):
    """Two-level expected makespan, elementwise (period T, deep every m)."""
    _, a, b, mu_m = _ml_derived(p, m)
    return T_base * T / ((T - a) * (b - T / (2.0 * mu_m)))


def ml_energy_final_batched(T, m, p, T_base=1.0):
    """Two-level E_final with per-level I/O powers, elementwise."""
    C1, R1, D1 = p["C1"], p["R1"], p["D1"]
    C2, R2, D2 = p["C2"], p["R2"], p["D2"]
    q = p["q"]
    Cb, a, b, mu_m = _ml_derived(p, m)
    w1, w2, Cw, S2, S2w = _ml_omega_terms(p, m)

    Tf = T_base * T / ((T - a) * (b - T / (2.0 * mu_m)))
    nf = Tf / p["mu"]
    Ew = (T**2 - S2) / (2.0 * T) + S2w / (2.0 * T)
    w_soft = Cw + Ew
    w_hard = w2 * C2 + (m - 1.0) * (T - (1.0 - w1) * C1) / 2.0 + Ew
    T_cal = T_base + nf * (w_soft + q * (w_hard - w_soft))

    ck_io1 = T_base * ((m - 1.0) * C1 / m) / (T - a)
    ck_io2 = T_base * (C2 / m) / (T - a)
    io1_pf = ((m - 1.0) / m) * C1**2 / (2.0 * T) + (1.0 - q) * R1 \
        + q * (m - 1.0) * C1 / 2.0
    io2_pf = C2**2 / (2.0 * m * T) + q * R2
    T_down = nf * (D1 + q * (D2 - D1))
    return _precision.psum((T_cal * p["P_cal"],
                            (ck_io1 + nf * io1_pf) * p["P_io1"],
                            (ck_io2 + nf * io2_pf) * p["P_io2"],
                            T_down * p["P_down"], Tf * p["P_static"]))


def _ml_bracket(p, m):
    """Shrunk (lo, hi, valid) per (m, grid point)."""
    _, a, b, mu_m = _ml_derived(p, m)
    lo0 = torch.maximum(torch.maximum(a, p["C1"]), p["C2"])
    hi0 = 2.0 * mu_m * b
    valid = hi0 > lo0 * (1.0 + 1e-9)
    hi0 = torch.where(valid, hi0, 2.0 * lo0 + 1.0)
    span = hi0 - lo0
    return lo0 + 1e-9 * span + 1e-12, hi0 - 1e-9 * span, valid


def _ml_energy_prime_batched(T, m, p, T_base=1.0):
    """Analytic two-level dE/dT (the W normal form of ``core.model``)."""
    C1, C2 = p["C1"], p["C2"]
    q = p["q"]
    Pc, P1, P2, Pd = p["P_cal"], p["P_io1"], p["P_io2"], p["P_down"]
    Cb, a, b, mu_m = _ml_derived(p, m)
    w1, w2, Cw, S2, S2w = _ml_omega_terms(p, m)

    W0 = (Pc * (Cw + q * (w2 * C2 - Cw
                          - (m - 1.0) * (1.0 - w1) * C1 / 2.0))
          + P1 * ((1.0 - q) * p["R1"] + q * (m - 1.0) * C1 / 2.0)
          + P2 * q * p["R2"]
          + Pd * (p["D1"] + q * (p["D2"] - p["D1"])))
    W1 = Pc * (1.0 + q * (m - 1.0)) / 2.0
    Wm = (Pc * (S2w - S2) / 2.0
          + P1 * (m - 1.0) * C1**2 / (2.0 * m)
          + P2 * C2**2 / (2.0 * m))
    J = P1 * (m - 1.0) * C1 / m + P2 * C2 / m

    Tf = T_base * T / ((T - a) * (b - T / (2.0 * mu_m)))
    Tfp = T_base * (-a * b + T**2 / (2.0 * mu_m)) \
        / ((T - a) ** 2 * (b - T / (2.0 * mu_m)) ** 2)
    W = W0 + W1 * T + Wm / T
    Wp = W1 - Wm / T**2
    return (p["P_static"] * Tfp + Tfp / p["mu"] * W + Tf / p["mu"] * Wp
            - J * T_base / (T - a) ** 2)


def _ml_quadratic(p, m, lo, hi, T_base):
    """(c2, c1, c0, quad_ok) of Q_m = K_m * E' by 3-point Newton
    interpolation of the analytic product, checked at a 4th point."""
    _, a, b, mu_m = _ml_derived(p, m)

    def Q(t):
        K = (t - a) ** 2 * (b - t / (2.0 * mu_m)) ** 2 \
            / (p["P_static"] * T_base)
        return K * _ml_energy_prime_batched(t, m, p, T_base)

    span = hi - lo
    t1, t2, t3 = lo + 0.2 * span, lo + 0.45 * span, lo + 0.7 * span
    q1, q2, q3 = Q(t1), Q(t2), Q(t3)
    d1 = (q2 - q1) / (t2 - t1)
    d2 = (q3 - q2) / (t3 - t2)
    c2 = (d2 - d1) / (t3 - t1)
    c1 = d1 - c2 * (t1 + t2)
    c0 = q1 - t1 * (d1 - c2 * t2)

    t4 = lo + 0.9 * span
    q4 = Q(t4)
    q4_poly = c2 * t4**2 + c1 * t4 + c0
    scale = torch.maximum(torch.maximum(torch.abs(q4), torch.abs(q4_poly)),
                          torch.clamp_min(torch.abs(c0), 1e-300))
    quad_ok = torch.abs(q4 - q4_poly) <= 1e-6 * scale
    return c2, c1, c0, quad_ok


def _t_opt_time_ml_from(p, m, t_num):
    """Per-m AlgoT closed form, the numeric argmin where it degenerates."""
    _, a, b, mu_m = _ml_derived(p, m)
    lo, hi, _ = _ml_bracket(p, m)
    val = 2.0 * a * b * mu_m
    t_closed = torch.clamp(torch.sqrt(torch.clamp_min(val, 0.0)), lo, hi)
    return torch.where(val > 0.0, t_closed, t_num)


def _t_opt_energy_ml_from(p, m, T_base, t_num):
    """Per-m AlgoE quadratic root with the scalar solver's guards."""
    lo, hi, _ = _ml_bracket(p, m)
    c2, c1, c0, quad_ok = _ml_quadratic(p, m, lo, hi, T_base)

    disc = c1**2 - 4.0 * c2 * c0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    safe_c2 = torch.where(torch.abs(c2) > 1e-300, c2, 1.0)
    r1 = (-c1 - sq) / (2.0 * safe_c2)
    r2 = (-c1 + sq) / (2.0 * safe_c2)
    safe_c1 = torch.where(torch.abs(c1) > 1e-300, c1, 1.0)
    rlin = -c0 / safe_c1

    def is_min_root(r):
        return (quad_ok & (disc >= 0.0) & (torch.abs(c2) > 1e-300)
                & (r > lo) & (r < hi) & (2.0 * c2 * r + c1 > 0.0))

    lin_ok = quad_ok & (torch.abs(c2) <= 1e-300) \
        & (torch.abs(c1) > 1e-300) & (rlin > lo) & (rlin < hi) & (c1 > 0.0)

    t_root = torch.where(is_min_root(r1), r1,
                         torch.where(is_min_root(r2), r2,
                                     torch.where(lin_ok, rlin, t_num)))
    e_root = ml_energy_final_batched(t_root, m, p, T_base)
    e_num = ml_energy_final_batched(t_num, m, p, T_base)
    return torch.where(e_root <= e_num * (1.0 + 1e-9), t_root, t_num)


@dataclasses.dataclass(frozen=True)
class MultilevelGridResult:
    """Jointly optimal (T, m) per grid point, plus the per-m curves;
    tensors on the grid's device.

    Per-point tensors have ``grid.shape``; the ``*_by_m`` tensors carry a
    leading axis over ``m_values``.  Degenerate points (no valid period at
    any m) follow :class:`GridResult`: periods C2, m 1, ratios exactly
    1.0, Tf/E NaN.
    """

    grid: MultilevelParamGrid
    m_values: tuple
    T_base: float
    T_time: torch.Tensor          # AlgoT period
    m_time: torch.Tensor          # AlgoT deep-checkpoint cadence (int64)
    T_energy: torch.Tensor        # AlgoE period
    m_energy: torch.Tensor        # (int64)
    Tf_time: torch.Tensor
    Tf_energy: torch.Tensor
    E_time: torch.Tensor
    E_energy: torch.Tensor
    time_ratio: torch.Tensor      # Tf_energy / Tf_time  (>= 1, "loss")
    energy_ratio: torch.Tensor    # E_time / E_energy    (>= 1, "gain")
    time_vs_single: torch.Tensor  # Tf(AlgoT, 2-level) / Tf(AlgoT, PFS-only)
    energy_vs_single: torch.Tensor  # E(AlgoE, 2-level) / E(AlgoE, PFS-only)
    T_time_by_m: torch.Tensor     # (M,) + grid.shape
    Tf_by_m: torch.Tensor
    T_energy_by_m: torch.Tensor
    E_by_m: torch.Tensor
    valid_by_m: torch.Tensor
    valid: torch.Tensor

    @property
    def energy_saving(self) -> torch.Tensor:
        return 1.0 - 1.0 / self.energy_ratio

    @property
    def time_overhead(self) -> torch.Tensor:
        return self.time_ratio - 1.0

    def point_at(self, idx):
        """Scalar :class:`~repro_torch.core.tradeoff
        .MultilevelTradeoffPoint` view of one grid point."""
        from ..core.tradeoff import MultilevelTradeoffPoint
        f = lambda name: getattr(self, name)[idx].item()
        return MultilevelTradeoffPoint(
            ckpt=self.grid.ckpt_at(idx), power=self.grid.power_at(idx),
            T_time=float(f("T_time")), m_time=int(f("m_time")),
            T_energy=float(f("T_energy")), m_energy=int(f("m_energy")),
            time_ratio=float(f("time_ratio")),
            energy_ratio=float(f("energy_ratio")),
            time_vs_single=float(f("time_vs_single")),
            energy_vs_single=float(f("energy_vs_single")))


_ML_FIELD_ORDER = ("C1", "R1", "D1", "C2", "R2", "D2", "mu", "omega", "q",
                   "P_static", "P_cal", "P_io1", "P_io2", "P_down",
                   "omega1", "omega2")
_ML_OUT_ORDER = ("T_time", "m_time", "T_energy", "m_energy",
                 "Tf_time", "Tf_energy", "E_time", "E_energy",
                 "time_ratio", "energy_ratio",
                 "time_vs_single", "energy_vs_single", "valid")
_ML_BY_M_ORDER = ("T_time_by_m", "Tf_by_m", "T_energy_by_m", "E_by_m",
                  "valid_by_m")


def _evaluate_ml_core(P, T_base, m_values, m_max=None):
    """All outputs of :func:`evaluate_multilevel_grid` for one stacked
    (16, N) chunk: a (13, N) tensor of per-point outputs and a (5, M, N)
    tensor of per-m tables, of P's dtype.  ``m_max`` (N,), if given, masks
    the candidates ``m > m_max`` of each point invalid."""
    p = dict(zip(_ML_FIELD_ORDER, P))
    mv = torch.as_tensor(m_values, dtype=P.dtype,
                         device=P.device).reshape(-1, 1)       # (M, 1)
    lo, hi, valid_m = _ml_bracket(p, mv)                       # (M, N)
    if m_max is not None:
        valid_m = valid_m & (mv <= m_max[None, :])

    # The per-m time and energy argmins share ONE golden-section loop over
    # a stacked leading axis; each row evaluates its own objective.
    def objective(t):
        return torch.stack([ml_time_final_batched(t[0], mv, p, T_base),
                            ml_energy_final_batched(t[1], mv, p, T_base)])

    t_num = golden_section_batched(objective, torch.stack([lo, lo]),
                                   torch.stack([hi, hi]))
    Tt_m = _t_opt_time_ml_from(p, mv, t_num[0])               # (M, N)
    Te_m = _t_opt_energy_ml_from(p, mv, T_base, t_num[1])
    Tf_m = ml_time_final_batched(Tt_m, mv, p, T_base)
    E_m = ml_energy_final_batched(Te_m, mv, p, T_base)

    i_t = torch.argmin(torch.where(valid_m, Tf_m, math.inf), dim=0)  # (N,)
    i_e = torch.argmin(torch.where(valid_m, E_m, math.inf), dim=0)
    take = lambda arr, i: torch.gather(arr, 0, i[None, :])[0]
    m_arr = mv[:, 0]
    T_time, m_time = take(Tt_m, i_t), m_arr[i_t]
    T_energy, m_energy = take(Te_m, i_e), m_arr[i_e]
    Tf_time, E_energy = take(Tf_m, i_t), take(E_m, i_e)
    # cross metrics at the jointly optimal operating points
    Tf_energy = ml_time_final_batched(T_energy, m_energy, p, T_base)
    E_time = ml_energy_final_batched(T_time, m_time, p, T_base)

    # the PFS-only single-level comparator on the same grid (C2/R2/D2/P_io2
    # at the deep level's overlap factor, as grid.single_level())
    p_sl = {"C": p["C2"], "R": p["R2"], "D": p["D2"], "mu": p["mu"],
            "omega": p["omega2"], "P_static": p["P_static"],
            "P_cal": p["P_cal"], "P_io": p["P_io2"], "P_down": p["P_down"]}
    lo_s, hi_s, valid_s = _bracket(p_sl)

    def objective_s(t):
        return torch.stack([time_final_batched(t[0], p_sl, T_base),
                            energy_final_batched(t[1], p_sl, T_base)])

    t_num_s = golden_section_batched(objective_s, torch.stack([lo_s, lo_s]),
                                     torch.stack([hi_s, hi_s]))
    Tt_s = _t_opt_time_from(p_sl, t_num_s[0])
    Te_s = _t_opt_energy_from(p_sl, T_base, t_num_s[1])
    Tf_s = time_final_batched(Tt_s, p_sl, T_base)
    E_s = energy_final_batched(Te_s, p_sl, T_base)

    valid = torch.any(valid_m, dim=0)
    C2 = p["C2"]
    nan = math.nan
    scalars = torch.stack([
        torch.where(valid, T_time, C2),
        torch.where(valid, m_time, 1.0),
        torch.where(valid, T_energy, C2),
        torch.where(valid, m_energy, 1.0),
        torch.where(valid, Tf_time, nan),
        torch.where(valid, Tf_energy, nan),
        torch.where(valid, E_time, nan),
        torch.where(valid, E_energy, nan),
        torch.where(valid, Tf_energy / Tf_time, 1.0),
        torch.where(valid, E_time / E_energy, 1.0),
        # the vs-single ratios mean nothing where the PFS-only comparator
        # has no valid period (the buddy level rescuing an infeasible
        # platform): NaN there
        torch.where(valid, torch.where(valid_s, Tf_time / Tf_s, nan), 1.0),
        torch.where(valid, torch.where(valid_s, E_energy / E_s, nan), 1.0),
        valid.to(C2.dtype)])
    by_m = torch.stack([Tt_m, torch.where(valid_m, Tf_m, nan),
                        Te_m, torch.where(valid_m, E_m, nan),
                        valid_m.to(C2.dtype)])
    return scalars, by_m


def evaluate_multilevel_grid(grid: MultilevelParamGrid,
                             m_values: Sequence[int] = tuple(range(1, 13)),
                             T_base: float = 1.0, dispatch=None, m_max=None,
                             precision=None,
                             device="cuda") -> MultilevelGridResult:
    """Jointly optimal (T, m) and the ratios for every grid point, on
    ``device``.

    ``m_values`` is the candidate set of deep-checkpoint cadences.  The
    grid axis is cut into one piece a device of the sweep mesh and each
    piece into chunks under the device-memory budget (``dispatch``;
    ``_ML_BYTES_PER_POINT_M`` a point and cadence), the results gathered
    on ``device``; the computation is elementwise, so neither the split
    nor the chunks change results.

    ``m_max`` (optional) caps the cadence per grid point: integers
    broadcastable to ``grid.shape``; candidates ``m > m_max[point]`` are
    masked invalid at that point only, so requests with different cadence
    budgets share one call over the union of their candidates.
    ``m_max=None`` is the unmasked computation.

    ``precision`` selects the :class:`~repro_torch.sim.precision
    .PrecisionPolicy` as in :func:`evaluate_grid` (explicit > config >
    env > the device's default).
    """
    dev = resolve_device(device)
    pol = _dispatch.resolve_precision(dispatch, precision, dev)
    m_values = tuple(int(m) for m in m_values)
    if not m_values or min(m_values) < 1:
        raise ValueError(f"m_values must be positive ints, got {m_values}")
    flat = grid.ravel().to(dev)
    P = torch.stack([getattr(flat, f) for f in _ML_FIELD_ORDER])
    mm = None
    if m_max is not None:
        mm = torch.broadcast_to(torch.as_tensor(m_max, dtype=F64, device=dev),
                                grid.shape).reshape(-1)
    M, N = len(m_values), flat.size
    scalars = torch.empty((len(_ML_OUT_ORDER), N), dtype=F64, device=dev)
    by_m = torch.empty((len(_ML_BY_M_ORDER), M, N), dtype=F64, device=dev)
    with _precision.use_policy(pol):
        for d, lo, hi in _dispatch.pieces(
                N, _dispatch.split_devices(dispatch, dev)):
            Pd = P[:, lo:hi].to(d)
            mmd = None if mm is None else mm[lo:hi].to(d)
            with _dispatch.on_device(d):
                for start, stop in _dispatch.chunk_plan(
                        hi - lo, _ML_BYTES_PER_POINT_M * M, dispatch):
                    s, b = _evaluate_ml_core(
                        pol.cast(Pd[:, start:stop]), float(T_base), m_values,
                        None if mmd is None else pol.cast(mmd[start:stop]))
                    scalars[:, lo + start:lo + stop] = s.to(dev)
                    by_m[:, :, lo + start:lo + stop] = b.to(dev)
    out = {k: scalars[i].reshape(grid.shape)
           for i, k in enumerate(_ML_OUT_ORDER)}
    out["valid"] = out["valid"] > 0.5
    for k in ("m_time", "m_energy"):
        out[k] = torch.where(out["valid"], out[k], 1.0).to(torch.int64)
    shp = (M,) + grid.shape
    tables = {k: by_m[i].reshape(shp) for i, k in enumerate(_ML_BY_M_ORDER)}
    tables["valid_by_m"] = tables["valid_by_m"] > 0.5
    return MultilevelGridResult(grid=grid, m_values=m_values,
                                T_base=float(T_base), **tables, **out)


# ---------------------------------------------------------------------------
# Robustness: exponential-assumption periods under realistic failures
# ---------------------------------------------------------------------------
#
# No closed form exists for non-exponential processes, so the grid solver
# is Monte Carlo: one schedule set per grid point, sampled on the host from
# the caller's generator and moved to the device once, is reused for every
# candidate period (common random numbers); the argmins are localized by
# coarse-to-fine refinement, each round one ``simulate_candidates`` call
# for every candidate and grid point; every reported period is scored on
# the same schedules, so the penalties are CRN-paired.  The candidate
# bookkeeping is host numpy (a few floats per grid point); the means come
# back from the device once per call.

@dataclasses.dataclass(frozen=True)
class RobustnessResult:
    """Per-grid-point periods and CRN penalties; numpy arrays of
    ``grid.shape``.

    ``*_penalty_*`` are ratios >= ~1: wall time (or energy) at the
    exponential-assumption period divided by its value at the MC
    process-optimal period, under the non-exponential process.
    """

    grid: ParamGrid
    process: object                # FailureProcess
    T_base: np.ndarray             # per-point simulated work (grid.shape)
    n_trials: int
    T_exp_time: np.ndarray         # AlgoT closed form (exponential model)
    T_exp_energy: np.ndarray       # AlgoE quadratic root
    T_young: np.ndarray
    T_daly: np.ndarray
    T_mc_time: np.ndarray          # process-optimal (MC surrogate)
    T_mc_energy: np.ndarray
    eval_periods: np.ndarray       # (6,) + grid.shape, the scored periods
                                   # [mc_t, mc_e, algoT, algoE, young, daly]
                                   # clipped into the safe range; feed to
                                   # evaluate_periods_grid to validate them
    wall_mc: np.ndarray            # E[T_final] at T_mc_time
    energy_mc: np.ndarray          # E[E_final] at T_mc_energy
    wall_mc_se: np.ndarray
    energy_mc_se: np.ndarray
    time_penalty_exp: np.ndarray
    energy_penalty_exp: np.ndarray
    time_penalty_young: np.ndarray
    time_penalty_daly: np.ndarray
    energy_penalty_young: np.ndarray
    energy_penalty_daly: np.ndarray
    valid: np.ndarray


def _flat_tbase(T_base, grid: ParamGrid) -> np.ndarray:
    """Per-point T_base as a flat (grid.size,) array, from a scalar, an
    already-flat vector, or a grid-shaped array."""
    arr = np.asarray(T_base, dtype=np.float64)
    if arr.shape == grid.shape:
        return arr.ravel().copy()
    return np.broadcast_to(arr, (grid.size,)).copy()


def _mc_eval(T_cand, flat: ParamGrid, T_base, gaps, n_steps=None,
             engine_kind: Optional[str] = None, dispatch=None):
    """Means (and standard errors) over trials of wall time and energy for
    candidate periods ``T_cand`` of shape ``(M, B)`` against the flat grid,
    in one ``simulate_candidates`` call on the grid's device; host numpy
    arrays of shape ``(M, B)``."""
    T_cand = np.atleast_2d(np.asarray(T_cand, dtype=np.float64))
    tb = _engine.simulate_candidates(T_cand, flat, T_base, gaps=gaps,
                                     n_steps=n_steps,
                                     engine_kind=engine_kind,
                                     dispatch=dispatch, device=flat.device)
    if bool(tb.truncated.any()):
        raise RuntimeError("robustness sweep: step budget exceeded — "
                           "candidate period too close to a bracket edge")
    if bool(tb.gaps_exhausted.any()):
        raise RuntimeError("robustness sweep: failure schedule exhausted — "
                           "increase the capacity margins")
    n = tb.wall_time.shape[-1]
    host = lambda x: x.cpu().numpy()
    se = lambda a: host(a.std(dim=-1, correction=1)) / math.sqrt(n)
    return (host(tb.wall_time.mean(dim=-1)), host(tb.energy.mean(dim=-1)),
            se(tb.wall_time), se(tb.energy))


def _mc_setup(flat: ParamGrid, probes, T_base, n_trials: int,
              rng: np.random.Generator, process, engine_kind: str):
    """(device schedule, step budget) of the candidate calls: the capacity
    and the budget of the worst probe, the schedule sampled once on the
    host from ``rng`` and moved to the grid's device."""
    cap = _engine.default_fail_capacity(probes, flat, T_base,
                                        process=process)
    n_steps = (None if engine_kind in _engine._EVENT_LIKE else
               _engine.default_step_budget(probes, flat, T_base,
                                           process=process))
    gaps = _engine.presample_gaps(flat, n_trials, cap, rng, process=process)
    return torch.as_tensor(gaps, dtype=F64, device=flat.device), n_steps


def evaluate_robustness_grid(grid: ParamGrid, process,
                             T_base: Optional[float] = None,
                             n_trials: int = 160, *,
                             rng: np.random.Generator,
                             n_candidates: int = 13, rounds: int = 3,
                             engine_kind: Optional[str] = None,
                             dispatch=None,
                             device="cuda") -> RobustnessResult:
    """MC robustness evaluation of a whole grid under ``process``, on
    ``device``.

    Each refinement round scores ``n_candidates`` periods for every grid
    point in one candidate call; a final call scores the six reported
    periods (MC-time, MC-energy, AlgoT, AlgoE, Young, Daly) on the same
    schedules, sampled once from the caller's ``rng``
    (``np.random.default_rng(s)`` reproduces the reference's ``seed=s``).
    The closed-form periods come from :func:`evaluate_grid` under the
    engine kind's policy (f64 for ``"event"``).  Re-validate the reported
    optima with :func:`evaluate_periods_grid` on another generator.
    """
    process = as_process(process)
    kind = _engine.resolve_engine_kind(engine_kind)
    dev = resolve_device(device)
    pol = _engine._engine_policy(kind, dispatch, None, dev)
    grid = grid.to(dev)
    res = evaluate_grid(grid, T_base=1.0, dispatch=dispatch, precision=pol,
                        device=dev)
    if not bool(res.valid.all()):
        raise ValueError("robustness sweep: grid contains degenerate points "
                         "(no valid period); filter them first")
    flat = grid.ravel()
    B = flat.size
    host = lambda x: x.cpu().numpy().ravel()
    Tt, Te, Ty, Td = (host(x) for x in (res.T_time, res.T_energy,
                                        res.T_young, res.T_daly))
    lo0, hi0 = (host(x) for x in flat.period_bounds())
    # Search well clear of the bracket edges, where E[T_final] (and with it
    # the budgets) diverges; the optimum sits near the exponential T* for
    # every renewal process with the same mean.
    lo = np.maximum(lo0 * 1.02, Tt / 6.0)
    hi = np.minimum(lo0 + 0.75 * (hi0 - lo0), Tt * 6.0)
    if T_base is None:
        T_base = np.maximum(30.0 * Tt, 10.0 * host(flat.mu))
    T_base = _flat_tbase(T_base, grid)
    probes = lo[None, :] * (hi / lo)[None, :] ** np.linspace(
        0.0, 1.0, 9)[:, None]
    gaps, n_steps = _mc_setup(flat, probes, T_base, n_trials, rng, process,
                              kind)
    mc = lambda xs: _mc_eval(xs, flat, T_base, gaps, n_steps, kind, dispatch)

    # Coarse-to-fine localization of both argmins (batched over the grid).
    frac = np.linspace(0.0, 1.0, n_candidates)[:, None]
    xs_t = lo[None, :] * (hi / lo)[None, :] ** frac     # geometric first pass
    xs_e = xs_t

    def shrink(xs, ys):
        i = np.argmin(ys, axis=0)
        lo2 = xs[np.maximum(i - 1, 0), np.arange(B)]
        hi2 = xs[np.minimum(i + 1, n_candidates - 1), np.arange(B)]
        return lo2[None, :] + (hi2 - lo2)[None, :] * frac

    def score(xs_time, xs_energy):
        # one call returns both objectives, so the shared first round is
        # simulated once
        wall_t, energy_t, _, _ = mc(xs_time)
        if xs_energy is xs_time:
            return wall_t, energy_t
        return wall_t, mc(xs_energy)[1]

    for _ in range(rounds):
        wall_t, energy_e = score(xs_t, xs_e)
        xs_t = shrink(xs_t, wall_t)
        xs_e = shrink(xs_e, energy_e)
    wall_t, energy_e = score(xs_t, xs_e)
    T_mc_t = xs_t[np.argmin(wall_t, axis=0), np.arange(B)]
    T_mc_e = xs_e[np.argmin(energy_e, axis=0), np.arange(B)]

    # Score all six reported periods on the same schedules (CRN-paired).
    cands = np.clip(np.stack([T_mc_t, T_mc_e, Tt, Te, Ty, Td]),
                    lo[None, :], hi[None, :])
    wall, energy, wall_se, energy_se = mc(cands)
    shp = grid.shape
    r = lambda a: np.asarray(a, dtype=np.float64).reshape(shp)
    return RobustnessResult(
        grid=grid, process=process, T_base=r(T_base),
        n_trials=int(n_trials),
        T_exp_time=r(Tt), T_exp_energy=r(Te), T_young=r(Ty), T_daly=r(Td),
        T_mc_time=r(T_mc_t), T_mc_energy=r(T_mc_e),
        eval_periods=cands.reshape((6,) + shp),
        wall_mc=r(wall[0]), energy_mc=r(energy[1]),
        wall_mc_se=r(wall_se[0]), energy_mc_se=r(energy_se[1]),
        time_penalty_exp=r(wall[2] / wall[0]),
        energy_penalty_exp=r(energy[3] / energy[1]),
        time_penalty_young=r(wall[4] / wall[0]),
        time_penalty_daly=r(wall[5] / wall[0]),
        energy_penalty_young=r(energy[4] / energy[1]),
        energy_penalty_daly=r(energy[5] / energy[1]),
        valid=res.valid.cpu().numpy().copy())


def evaluate_periods_grid(grid: ParamGrid, process, periods, T_base,
                          n_trials: int = 160, *,
                          rng: np.random.Generator,
                          engine_kind: Optional[str] = None, dispatch=None,
                          device="cuda") -> dict:
    """MC means at given candidate periods under ``process``, on
    ``device`` (common random numbers across candidates, a schedule sampled
    from the caller's ``rng``).

    ``periods`` has shape ``(M,) + grid.shape``; returns a dict of numpy
    ``wall`` / ``energy`` (+ ``_se``) arrays of the same shape.  This is the
    independent-validation entry: score ``RobustnessResult.eval_periods``
    on another generator and compare the derived penalties.
    """
    process = as_process(process)
    kind = _engine.resolve_engine_kind(engine_kind)
    flat = grid.ravel().to(resolve_device(device))
    B = flat.size
    P = np.asarray(periods, dtype=np.float64).reshape((-1, B))
    T_base = _flat_tbase(T_base, grid)
    gaps, n_steps = _mc_setup(flat, P, T_base, n_trials, rng, process, kind)
    wall, energy, wall_se, energy_se = _mc_eval(P, flat, T_base, gaps,
                                                n_steps, kind, dispatch)
    shp = (P.shape[0],) + grid.shape
    return {"wall": wall.reshape(shp), "energy": energy.reshape(shp),
            "wall_se": wall_se.reshape(shp),
            "energy_se": energy_se.reshape(shp)}


def sweep_weibull_shapes(shapes: Sequence[float], mu_minutes: Sequence[float],
                         base: str = "exascale_rho55", device="cuda",
                         **kwargs) -> RobustnessResult:
    """Weibull shape x exascale-platform MTBF robustness sweep (fig5's
    entry point); ``kwargs`` go to :func:`evaluate_robustness_grid` (its
    ``rng`` among them)."""
    grid, process = scenarios.robustness_grid(shapes, mu_minutes, base=base,
                                              device=device)
    return evaluate_robustness_grid(grid, process, device=device, **kwargs)
