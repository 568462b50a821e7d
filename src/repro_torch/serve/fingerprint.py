"""Fingerprint cache: quantized request keys with a certified tolerance.

Pay for a computation once per *equivalence class*, not once per call:
the same idea as the kernel-build cache (``sim/cache.py``), applied to
solved answers.  Two requests whose platform parameters
round to the same point of a logarithmic lattice share one cache entry;
the entry stores the EXACT solve of the lattice representative, so every
request mapping to a fingerprint receives bit-identical numbers whether
it hits or misses.

Lattice
-------
Positive scale parameters (C, R, D, mu, P_*) are rounded in log space
with relative step ``rel`` (each parameter moves by at most a factor
``(1 + rel)^(1/2)``); the bounded mixing parameters (omega, q) are
rounded on a linear grid of step ``absolute``.  ``T_base`` is excluded
(both objectives are degree-1 homogeneous in it — see ``serve.schema``)
and ``objective`` is excluded (one entry stores both optima).

Tolerance contract (the sandwich lemma)
---------------------------------------
Let ``J_p(T)`` be the served objective (expected makespan or energy) on
platform ``p``, ``p^`` the lattice representative of ``p``'s cell, and

    ``T* = argmin J_p``,   ``T^ = argmin J_{p^}`` (the cached answer).

Suppose every platform in the cell satisfies the two-sided ratio bound
``J_{p'}(T) <= e^L * J_{p''}(T)`` for all ``T`` in ``{T^, T*}`` and all
cell members ``p', p''``.  Then serving ``T^`` instead of ``T*`` costs

    ``J_p(T^) <= e^L J_{p^}(T^) <= e^L J_{p^}(T*) <= e^{2L} J_p(T*)``,

i.e. a relative degradation of at most ``e^{2L} - 1`` — the middle
inequality is just the optimality of ``T^`` for ``p^``.  The bound needs
NO smoothness of the argmin itself, only of the objective's value, which
is why it survives the flat-valley regions where the argmin moves a lot.

``certified_bound`` computes, per cache entry, a conservative ``L``:
for each parameter it perturbs the representative to both edges of its
cell (holding ``T^`` fixed), measures the worst log-change of the
objective with the exact closed form, and sums over parameters; the sum
is doubled (``_CELL_SAFETY``) to cover cross terms and the fact that the
request sits up to a full half-step from the representative in every
coordinate simultaneously.  Every perturbed platform of an entry is one
row of a (K, N) stack, so each objective is evaluated once over all of
them, wherever the fields live (the solve's device); the log-ratios are
then taken on the host in numpy, lane by lane, so a lane's bound does not
depend on where it sits in a window.  The service compares ``expm1(2 * L)``
against the documented tolerance and falls back to an exact per-request
solve whenever the certificate fails — so the contract

    served objective  <=  (1 + tol) * exact optimum

holds for every answer the cache is allowed to serve, and the property
suite (``tests/test_torch_advisor.py``) checks it against brute-force
exact solves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .._device import F64
from ..sim import sweep as _sweep
from .schema import AdviceRequest, StoreTier

#: safety factor on the per-cell log-ratio ``L``: the axis sweep measures
#: one coordinate at a time; doubling covers simultaneous perturbation of
#: all coordinates plus curvature beyond first order.
_CELL_SAFETY = 2.0


@dataclasses.dataclass(frozen=True)
class Quantization:
    """Cache lattice knobs.

    ``rel``      — relative log-space step for positive scale params.
    ``absolute`` — linear step for omega / q in [0, 1].
    ``tol``      — documented relative-degradation tolerance: entries
                   whose certified bound exceeds it are not served from
                   the lattice (the request is solved exactly instead).

    The defaults certify well under ``tol`` on the paper's platform
    ranges; pass ``rel=0.0`` to disable quantization entirely (the
    fingerprint then only merges bit-identical requests).
    """

    rel: float = 1e-3
    absolute: float = 1e-3
    tol: float = 1e-2

    def __post_init__(self):
        if self.rel < 0.0 or self.absolute < 0.0 or self.tol < 0.0:
            raise ValueError("quantization steps must be >= 0")


def _qlog(x: float, rel: float) -> float:
    """Round ``x > 0`` to the nearest point of the log-lattice."""
    if rel <= 0.0 or x <= 0.0:
        return float(x)
    step = math.log1p(rel)
    return float(math.exp(round(math.log(x) / step) * step))


def _qlin(x: float, step: float) -> float:
    """Round ``x`` to the nearest multiple of ``step`` (clipped to [0,1])."""
    if step <= 0.0:
        return float(x)
    return float(min(1.0, max(0.0, round(x / step) * step)))


def _qtier(t: StoreTier, q: Quantization) -> StoreTier:
    return StoreTier(name=t.name, C=_qlog(t.C, q.rel), R=_qlog(t.R, q.rel),
                     D=_qlog(t.D, q.rel), P_io=_qlog(t.P_io, q.rel),
                     q=_qlin(t.q, q.absolute))


def quantize_request(req: AdviceRequest, q: Quantization) -> AdviceRequest:
    """The lattice representative of ``req``'s cell.

    Canonicalized to ``T_base = 1`` (homogeneity) — the objective and the
    tier names are carried through untouched (they don't enter the solve).
    """
    return dataclasses.replace(
        req,
        mu=_qlog(req.mu, q.rel),
        tiers=tuple(_qtier(t, q) for t in req.tiers),
        omega=_qlin(req.omega, q.absolute),
        omega2=(None if req.omega2 is None
                else _qlin(req.omega2, q.absolute)),
        P_static=_qlog(req.P_static, q.rel),
        P_cal=_qlog(req.P_cal, q.rel),
        P_down=_qlog(req.P_down, q.rel),
        T_base=1.0,
        process_param=_qlog(req.process_param, q.rel),
    )


def fingerprint(req: AdviceRequest, q: Quantization) -> Tuple:
    """Hashable cache key of ``req``'s cell (quantize + key)."""
    return quantized_key(quantize_request(req, q))


def quantized_key(qr: AdviceRequest) -> Tuple:
    """Cache key of an ALREADY-QUANTIZED request.

    Built from the quantized numeric fields; excludes ``objective`` (one
    entry serves both), ``T_base`` (homogeneity) and tier names (labels,
    not physics).  Two-tier keys include ``max_deep_every`` because it
    caps the cadence search space and can change the answer.
    """
    tiers = tuple((t.C, t.R, t.D, t.P_io, t.q) for t in qr.tiers)
    key = ("2l" if qr.is_multilevel else "1l", qr.mu, tiers, qr.omega,
           qr.P_static, qr.P_cal, qr.P_down, qr.process, qr.process_param)
    if qr.is_multilevel:
        # the effective deep-flush overlap enters the solve, so it enters
        # the key (w2 == omega for requests without an async split).
        key = key + (qr.max_deep_every, qr.w2)
    return key


def exact_fingerprint(req: AdviceRequest) -> Tuple:
    """Zero-width cache key: merges only bit-identical platforms.

    Used for entries whose lattice cell failed certification — repeats of
    the same request still hit, but nothing is shared across a cell.
    """
    tiers = tuple((t.C, t.R, t.D, t.P_io, t.q) for t in req.tiers)
    key = ("exact", "2l" if req.is_multilevel else "1l", req.mu, tiers,
           req.omega, req.P_static, req.P_cal, req.P_down, req.process,
           req.process_param)
    if req.is_multilevel:
        key = key + (req.max_deep_every, req.w2)
    return key


# ---------------------------------------------------------------------------
# Certified bound: axis-edge sweep of the exact closed forms.
# ---------------------------------------------------------------------------

_SINGLE_LOG_FIELDS = ("C", "R", "D", "mu", "P_static", "P_cal", "P_io",
                      "P_down")
_SINGLE_LIN_FIELDS = ("omega",)
_ML_LOG_FIELDS = ("C1", "R1", "D1", "C2", "R2", "D2", "mu", "P_static",
                  "P_cal", "P_io1", "P_io2", "P_down")
# the objectives read the per-level overlaps, not the shared ``omega``
# (omega1 carries the buddy overlap, omega2 the deep flush), so those are
# the axes the certificate must sweep.
_ML_LIN_FIELDS = ("omega1", "omega2", "q")


def _tensors(fields: dict, *arrays):
    """``fields`` and ``arrays`` as f64 tensors on the fields' device (the
    host for numpy input)."""
    dev = next((v.device for v in fields.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    conv = lambda v: torch.as_tensor(v, dtype=F64, device=dev)
    return {k: conv(v) for k, v in fields.items()}, [conv(a) for a in arrays]


def _edge_stack(fields: dict, q: Quantization, log_fields, lin_fields):
    """``(p, axes)``: every field as a (K, N) stack whose row 0 is the
    representative and rows ``2i + 1``/``2i + 2`` move swept axis ``i`` to
    the upper/lower edge of its cell (log axes by ``(1 + rel)^(+-1/2)``,
    linear ones by ``+-absolute/2`` clipped to [0, 1]); ``axes`` is the
    number of swept axes.  Rows that leave a field alone hold it exactly
    (``x * 1.0``, ``clip(x + 0.0)`` of an x in [0, 1])."""
    swept = ([(f, True) for f in log_fields if q.rel > 0.0]
             + [(f, False) for f in lin_fields if q.absolute > 0.0])
    K = 1 + 2 * len(swept)
    coef = np.zeros((len(swept), K))
    half_log = 0.5 * math.log1p(q.rel)
    for i, (_, is_log) in enumerate(swept):
        if is_log:
            coef[i] = 1.0
            coef[i, 2 * i + 1] = math.exp(half_log)
            coef[i, 2 * i + 2] = math.exp(-half_log)
        else:
            coef[i, 2 * i + 1] = 0.5 * q.absolute
            coef[i, 2 * i + 2] = -0.5 * q.absolute
    any_field = next(iter(fields.values()))
    coef = torch.as_tensor(coef, dtype=F64, device=any_field.device)
    p = {k: v[None, :].expand(K, -1) for k, v in fields.items()}
    for i, (name, is_log) in enumerate(swept):
        x = fields[name][None, :]
        p[name] = (x * coef[i, :, None] if is_log
                   else torch.clamp(x + coef[i, :, None], 0.0, 1.0))
    return p, len(swept)


def _log_span(J: np.ndarray, axes: int) -> np.ndarray:
    """Per-point worst-case sum of axis log-ratios ``L`` from the objective
    stack ``J`` (K, N) of :func:`_edge_stack`.  Points where any perturbed
    evaluation leaves the model's domain (objective <= 0 or non-finite)
    get ``L = inf``: the certificate fails closed."""
    J0 = J[0]
    bad = ~np.isfinite(J0) | (J0 <= 0.0)
    logJ0 = np.log(np.where(bad, 1.0, J0))
    L = np.zeros_like(logJ0)
    for i in range(axes):
        span = np.zeros_like(logJ0)
        for Jr in (J[2 * i + 1], J[2 * i + 2]):
            ok = np.isfinite(Jr) & (Jr > 0.0)
            bad |= ~ok
            span = np.maximum(span,
                              np.abs(np.log(np.where(ok, Jr, 1.0)) - logJ0))
        L += span
    return np.where(bad, np.inf, L)


def _bound(J: torch.Tensor, axes: int) -> np.ndarray:
    """``expm1(2 * safety * L)`` from the stacked (2, K, N) time and energy
    objectives, ``L`` the worse of the two (one host copy)."""
    J = J.cpu().numpy()
    L = np.maximum(_log_span(J[0], axes), _log_span(J[1], axes))
    with np.errstate(over="ignore"):
        return np.where(np.isfinite(L),
                        np.expm1(2.0 * _CELL_SAFETY * L), np.inf)


def certified_bound_single(fields: dict, T_time, T_energy,
                           q: Quantization) -> np.ndarray:
    """Per-point certified degradation bound for single-level entries.

    ``fields`` holds the QUANTIZED platform arrays (the 9 ``ParamGrid``
    fields: tensors on the solve's device, or numpy float64);
    ``T_time``/``T_energy`` the served optima at ``T_base = 1``.  Returns
    ``expm1(2 * safety * L)`` (numpy) with ``L`` the worse of the two
    objectives' axis spans: one number certifying the entry for BOTH
    objectives.
    """
    fields, (T_time, T_energy) = _tensors(fields, T_time, T_energy)
    p, axes = _edge_stack(fields, q, _SINGLE_LOG_FIELDS, _SINGLE_LIN_FIELDS)
    return _bound(torch.stack([_sweep.time_final_batched(T_time, p),
                               _sweep.energy_final_batched(T_energy, p)]),
                  axes)


def certified_bound_multilevel(fields: dict, T_time, m_time, T_energy,
                               m_energy, q: Quantization) -> np.ndarray:
    """Per-point certified bound for two-tier ``(T, m)`` entries.

    Same sandwich argument with the operating point ``(T^, m^)`` held
    fixed; the cadence is discrete and identical on both sides of every
    comparison, so only the objective's parameter sensitivity enters.
    """
    fields, (T_time, m_t, T_energy, m_e) = _tensors(
        fields, T_time, m_time, T_energy, m_energy)
    p, axes = _edge_stack(fields, q, _ML_LOG_FIELDS, _ML_LIN_FIELDS)
    return _bound(torch.stack([
        _sweep.ml_time_final_batched(T_time, m_t, p),
        _sweep.ml_energy_final_batched(T_energy, m_e, p)]), axes)
