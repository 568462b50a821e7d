"""Admission batching: many heterogeneous requests -> one grid solve.

The batcher turns a set of QUANTIZED requests (cache misses of one
admission window) into the struct-of-arrays grids the sweep layer
consumes, so a whole burst is answered by one dispatched
``evaluate_grid`` call (single-level group) plus at most one
``evaluate_multilevel_grid`` call (two-tier group).

The grids are built on the service's device from one host-to-device copy
of the stacked rows per grid (the two-tier cadence caps ride in the same
copy), never one copy per field per lane.

Heterogeneity is handled in two ways:

dedup
    Requests sharing a fingerprint collapse to one grid lane; the plan
    records the lane index of every fingerprint.

cadence masking (two-tier)
    Two-tier requests may cap the deep cadence differently
    (``max_deep_every``).  The group always solves the FIXED candidate
    set ``1..DEFAULT_MAX_DEEP_EVERY`` in one call and masks each lane
    down to its own cap via the sweep layer's per-point ``m_max``
    argument — no per-cap splits, and each lane's answer is
    bit-identical to the solve it would have gotten alone.

Lane order is the first-seen order of fingerprints.  The sweep is
elementwise (its only transcendental is a correctly rounded sqrt), so
batch composition is a bit-exact no-op: a request's lane sees the same
values whether it is solved alone or inside any burst.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..sim.scenarios import MultilevelParamGrid, ParamGrid
from .schema import DEFAULT_MAX_DEEP_EVERY, AdviceRequest

_SINGLE_FIELDS = ("C", "R", "D", "mu", "omega", "P_static", "P_cal",
                  "P_io", "P_down")
_ML_FIELDS = ("C1", "R1", "D1", "C2", "R2", "D2", "mu", "omega", "q",
              "P_static", "P_cal", "P_io1", "P_io2", "P_down",
              "omega1", "omega2")


def _single_row(req: AdviceRequest) -> Tuple[float, ...]:
    t = req.tiers[0]
    return (t.C, t.R, t.D, req.mu, req.omega, req.P_static, req.P_cal,
            t.P_io, req.P_down)


def _ml_row(req: AdviceRequest) -> Tuple[float, ...]:
    t1, t2 = req.tiers
    return (t1.C, t1.R, t1.D, t2.C, t2.R, t2.D, req.mu, req.omega, t1.q,
            req.P_static, req.P_cal, t1.P_io, t2.P_io, req.P_down,
            req.omega, req.w2)


def _upload(rows, device) -> torch.Tensor:
    """The (lanes, fields) host rows as a (fields, lanes) f64 tensor on
    ``device``: one host-to-device copy."""
    cols = np.ascontiguousarray(np.array(rows, dtype=np.float64).T)
    return torch.from_numpy(cols).to(resolve_device(device))


def single_grid(reqs: Sequence[AdviceRequest], device="cuda") -> ParamGrid:
    """1-D :class:`ParamGrid` on ``device`` with one lane per request, in
    order."""
    cols = _upload([_single_row(r) for r in reqs], device)
    return ParamGrid(**{f: cols[i] for i, f in enumerate(_SINGLE_FIELDS)})


def multilevel_grid(reqs: Sequence[AdviceRequest], device="cuda") -> Tuple[
        MultilevelParamGrid, Tuple[int, ...], torch.Tensor]:
    """1-D two-level grid + union cadence set + per-lane cadence cap.

    Returns ``(grid, m_values, m_max)`` ready for
    ``evaluate_multilevel_grid(grid, m_values=m_values, m_max=m_max)``;
    ``m_max`` is an f64 tensor on ``device`` (the caps are small integers,
    exact in f64), uploaded in the grid's copy.
    """
    cols = _upload([_ml_row(r) + (float(r.max_deep_every),) for r in reqs],
                   device)
    grid = MultilevelParamGrid(**{f: cols[i]
                                  for i, f in enumerate(_ML_FIELDS)})
    # The candidate set is FIXED at 1..DEFAULT_MAX_DEEP_EVERY (the schema
    # bounds every request's cap by it); per-request caps act only
    # through the m_max mask, so a lane's answer is bit-identical whether
    # it is solved alone or inside any mix of cadence budgets.
    m_values = tuple(range(1, DEFAULT_MAX_DEEP_EVERY + 1))
    return grid, m_values, cols[len(_ML_FIELDS)]


@dataclasses.dataclass
class BatchPlan:
    """Deduped solve plan of one admission window.

    ``single_lanes`` / ``ml_lanes`` map each distinct fingerprint to its
    grid lane; ``single_reqs`` / ``ml_reqs`` hold the lane-ordered
    quantized representatives the grids were built from.
    """

    single_lanes: Dict[Tuple, int]
    single_reqs: List[AdviceRequest]
    ml_lanes: Dict[Tuple, int]
    ml_reqs: List[AdviceRequest]

    @property
    def n_lanes(self) -> int:
        return len(self.single_reqs) + len(self.ml_reqs)

    def grids(self, device="cuda") -> Tuple[
            Optional[ParamGrid], Optional[MultilevelParamGrid],
            Tuple[int, ...], Optional[torch.Tensor]]:
        """The window's grids on ``device`` (see :func:`single_grid` and
        :func:`multilevel_grid`); None for an empty group."""
        pg = (single_grid(self.single_reqs, device) if self.single_reqs
              else None)
        if self.ml_reqs:
            mg, m_values, m_max = multilevel_grid(self.ml_reqs, device)
        else:
            mg, m_values, m_max = None, (), None
        return pg, mg, m_values, m_max


def plan_batch(keyed_reqs: Sequence[Tuple[Tuple, AdviceRequest]]
               ) -> BatchPlan:
    """Dedup ``(fingerprint, quantized request)`` pairs into a solve plan.

    Lane order is first-seen fingerprint order, independently for the
    single-level and two-tier groups.
    """
    plan = BatchPlan(single_lanes={}, single_reqs=[], ml_lanes={},
                     ml_reqs=[])
    for fp, qr in keyed_reqs:
        if qr.is_multilevel:
            if fp not in plan.ml_lanes:
                plan.ml_lanes[fp] = len(plan.ml_reqs)
                plan.ml_reqs.append(qr)
        else:
            if fp not in plan.single_lanes:
                plan.single_lanes[fp] = len(plan.single_reqs)
                plan.single_reqs.append(qr)
    return plan
