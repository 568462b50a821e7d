"""Per-device precision policy for the sweep/engine stack.

``f64``
    Compute dtype float64, plain accumulation.  The oracle, and the
    default on the CPU.

``compensated_f32``
    Compute dtype float32 with Neumaier (two-sum) compensated accumulation
    for every running sum (the event kernel's wall/work/io/down/committed
    accumulators, the model sweep's energy-term sum).  The default on a
    CUDA device, which is the reference's rule for accelerators; choosing
    another default for the H100 waits for measurements.  Documented
    tolerances versus the f64 oracle:

    * objectives at the served optimum, re-evaluated in f64:
      ``objective_tol`` (1e-6 relative) — near an argmin the objective is
      locally quadratic, so a period error ``dT/T`` costs ``O((dT/T)^2)``;
    * the argmin itself: ``argmin_rtol`` (1e-2 relative), a flat-valley
      bound rather than f32 resolution.

Policies resolve per call through
:func:`repro_torch.sim.dispatch.resolve_precision` (explicit argument >
``DispatchConfig.precision`` > ``$REPRO_PRECISION`` > device default).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One named precision trade (see module docstring).

    ``dtype`` is a dtype NAME; ``compensated`` turns every policy-routed
    running sum into a Neumaier sum; ``objective_tol``/``argmin_rtol`` are
    the documented tolerances versus the f64 oracle (0.0 for the oracle).
    """

    name: str
    dtype: str
    compensated: bool
    objective_tol: float
    argmin_rtol: float

    @property
    def exact(self) -> bool:
        """True for the f64 oracle policy (plain accumulation)."""
        return self.dtype == "float64" and not self.compensated

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the policy's compute dtype (same device)."""
        return x.to(self.torch_dtype)


F64 = PrecisionPolicy(name="f64", dtype="float64", compensated=False,
                      objective_tol=0.0, argmin_rtol=0.0)
COMPENSATED_F32 = PrecisionPolicy(name="compensated_f32", dtype="float32",
                                  compensated=True, objective_tol=1e-6,
                                  argmin_rtol=1e-2)

#: registry of named policies (``resolve`` accepts these names).
POLICIES = {p.name: p for p in (F64, COMPENSATED_F32)}


def default_policy(device) -> PrecisionPolicy:
    """The device's default policy: f64 on the CPU, compensated f32 on a
    CUDA device (the reference's CPU/accelerator rule)."""
    return F64 if torch.device(device).type == "cpu" else COMPENSATED_F32


def resolve(policy, device="cuda") -> PrecisionPolicy:
    """Coerce ``policy`` (None / name / :class:`PrecisionPolicy`); None
    means ``device``'s default policy."""
    if policy is None:
        return default_policy(device)
    if isinstance(policy, str):
        try:
            return POLICIES[policy]
        except KeyError:
            raise ValueError(
                f"unknown precision policy {policy!r}; "
                f"one of {sorted(POLICIES)}") from None
    if isinstance(policy, PrecisionPolicy):
        return policy
    raise TypeError(f"expected a PrecisionPolicy, name, or None; "
                    f"got {type(policy).__name__}")


# ---------------------------------------------------------------------------
# Compensated accumulation (Neumaier / two-sum)
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """Knuth's exact two-sum: ``(s, err)`` with ``a + b == s + err`` exactly
    in the working precision (eager PyTorch never reassociates)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def comp_add(s, c, x):
    """One Neumaier step: add ``x`` to the compensated pair ``(s, c)``; the
    corrected value is ``s + c``."""
    s2, err = two_sum(s, x)
    return s2, c + err


def compensated_sum(terms):
    """Neumaier sum of a sequence of (broadcast-compatible) tensors."""
    terms = list(terms)
    s = terms[0]
    c = torch.zeros_like(torch.as_tensor(s))
    for t in terms[1:]:
        s, c = comp_add(s, c, t)
    return s + c


# ---------------------------------------------------------------------------
# Policy context
# ---------------------------------------------------------------------------
#
# The model sweep shares one algebra between the f64 oracle and the reduced
# precision policy; :func:`evaluate_grid` runs the core under
# ``use_policy`` so ``psum`` picks the compensated form without a policy
# argument threaded through every closed-form helper.

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_precision_policy", default=F64)


def active_policy() -> PrecisionPolicy:
    """The policy in effect for the current context."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_policy(policy: PrecisionPolicy):
    """Set the active policy for the duration of the block."""
    token = _ACTIVE.set(policy)
    try:
        yield policy
    finally:
        _ACTIVE.reset(token)


#: the reference's name for :func:`use_policy` (it sets the policy for a
#: trace there; the eager port runs the block itself).
trace_policy = use_policy


def psum(terms):
    """Policy-aware sum: the plain left-associated chain ``t0 + t1 + ...``
    under the f64 oracle, a Neumaier sum under a compensated policy."""
    terms = list(terms)
    if _ACTIVE.get().compensated:
        return compensated_sum(terms)
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    return s
