"""Exact expectation formulas of the paper (§3.1 time, §3.2 energy).

Every function takes ``T`` as a scalar, array or tensor and evaluates in
float64 on ``device`` (default ``"cuda"``), returning a tensor of
``T``'s shape.  The expressions are the reference's term for term.
:func:`K_dE_dT_autodiff` is an independent ``torch.autograd`` cross-check
of the analytic derivative.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import F64, as_f64
from .params import (CheckpointParams, MultilevelCheckpointParams,
                     MultilevelPowerParams, PowerParams)


# --------------------------------------------------------------------------
# §3.1 — execution time
# --------------------------------------------------------------------------

def time_fault_free(T, ckpt: CheckpointParams, T_base: float = 1.0,
                    device="cuda"):
    """T_ff = T_base * T / (T - (1-omega) C)."""
    T = as_f64(T, device)
    return T_base * T / (T - ckpt.a)


def time_lost_per_failure(T, ckpt: CheckpointParams, device="cuda"):
    """Expected time lost per failure = D + R + omega*C + T/2."""
    T = as_f64(T, device)
    return ckpt.D + ckpt.R + ckpt.omega * ckpt.C + T / 2.0


def time_final(T, ckpt: CheckpointParams, T_base: float = 1.0,
               device="cuda"):
    """T_final = T_base * T / ((T - a)(b - T/(2 mu))), valid on
    a < T < 2*mu*b (returned as-is outside)."""
    T = as_f64(T, device)
    a, b, mu = ckpt.a, ckpt.b, ckpt.mu
    return T_base * T / ((T - a) * (b - T / (2.0 * mu)))


def time_final_prime(T, ckpt: CheckpointParams, T_base: float = 1.0,
                     device="cuda"):
    """dT_final/dT = T_base (-ab + T^2/2mu) / ((T-a)^2 (b - T/2mu)^2)."""
    T = as_f64(T, device)
    a, b, mu = ckpt.a, ckpt.b, ckpt.mu
    num = -a * b + T**2 / (2.0 * mu)
    den = (T - a) ** 2 * (b - T / (2.0 * mu)) ** 2
    return T_base * num / den


def expected_failures(T, ckpt: CheckpointParams, T_base: float = 1.0,
                      device="cuda"):
    """E[#failures] = T_final / mu."""
    return time_final(T, ckpt, T_base, device) / ckpt.mu


# --------------------------------------------------------------------------
# §3.2 — energy
# --------------------------------------------------------------------------

class PhaseTimes(NamedTuple):
    """Expected cumulative phase durations over the whole execution."""

    T_final: torch.Tensor   # wall clock
    T_cal: torch.Tensor     # CPU-busy time (power overhead P_cal)
    T_io: torch.Tensor      # I/O-busy time (power overhead P_io)
    T_down: torch.Tensor    # downtime (power overhead P_down)


def _re_exec(T, ckpt: CheckpointParams):
    """Expected work re-executed per failure (paper §3.2)."""
    C, omega = ckpt.C, ckpt.omega
    return omega * C + (T**2 - C**2) / (2.0 * T) + omega * C**2 / (2.0 * T)


def _io_per_failure(T, ckpt: CheckpointParams):
    """Expected extra I/O time per failure: R + C^2/(2T)."""
    return ckpt.R + ckpt.C**2 / (2.0 * T)


def phase_times(T, ckpt: CheckpointParams, T_base: float = 1.0,
                device="cuda") -> PhaseTimes:
    """All phase expectations of §3.2 (T_final != T_cal + T_io + T_down
    unless omega == 0: CPU and I/O overlap during checkpoints)."""
    T = as_f64(T, device)
    C, D, mu, omega = ckpt.C, ckpt.D, ckpt.mu, ckpt.omega
    Tf = time_final(T, ckpt, T_base, T.device)
    n_fail = Tf / mu
    T_cal = T_base + n_fail * _re_exec(T, ckpt)
    ckpt_io = T_base * C / (T - (1.0 - omega) * C)
    T_io = ckpt_io + n_fail * _io_per_failure(T, ckpt)
    T_down = n_fail * D
    return PhaseTimes(T_final=Tf, T_cal=T_cal, T_io=T_io, T_down=T_down)


def energy_final(T, ckpt: CheckpointParams, power: PowerParams,
                 T_base: float = 1.0, device="cuda"):
    """E_final = T_cal P_cal + T_io P_io + T_down P_down + T_final P_static."""
    ph = phase_times(T, ckpt, T_base, device)
    return (ph.T_cal * power.P_cal
            + ph.T_io * power.P_io
            + ph.T_down * power.P_down
            + ph.T_final * power.P_static)


def energy_breakdown(T, ckpt: CheckpointParams, power: PowerParams,
                     T_base: float = 1.0, device="cuda") -> dict:
    """Per-component energies and T_final at a scalar period, as host
    floats (for reports and tests)."""
    ph = phase_times(T, ckpt, T_base, device)
    comp = {
        "E_cal": float(ph.T_cal * power.P_cal),
        "E_io": float(ph.T_io * power.P_io),
        "E_down": float(ph.T_down * power.P_down),
        "E_static": float(ph.T_final * power.P_static),
    }
    comp["E_final"] = sum(comp.values())
    comp["T_final"] = float(ph.T_final)
    return comp


def energy_final_prime(T, ckpt: CheckpointParams, power: PowerParams,
                       T_base: float = 1.0, device="cuda"):
    """Analytic dE_final/dT (see the reference for the derivation)."""
    T = as_f64(T, device)
    C, mu, omega = ckpt.C, ckpt.mu, ckpt.omega
    a = ckpt.a
    Tf = time_final(T, ckpt, T_base, T.device)
    Tfp = time_final_prime(T, ckpt, T_base, T.device)
    W = (power.P_cal * _re_exec(T, ckpt)
         + power.P_io * _io_per_failure(T, ckpt)
         + power.P_down * ckpt.D)
    Wp = (power.P_cal * (0.5 + (1.0 - omega) * C**2 / (2.0 * T**2))
          - power.P_io * C**2 / (2.0 * T**2))
    return (power.P_static * Tfp
            - power.P_io * T_base * C / (T - a) ** 2
            + Tfp / mu * W
            + Tf / mu * Wp)


# --------------------------------------------------------------------------
# K(T) * dE/dT — the paper's quadratic
# --------------------------------------------------------------------------

def K_factor(T, ckpt: CheckpointParams, power: PowerParams,
             T_base: float = 1.0, device="cuda"):
    """K = (T-a)^2 (b - T/2mu)^2 / (P_static * T_base)  (paper §3.2)."""
    T = as_f64(T, device)
    a, b, mu = ckpt.a, ckpt.b, ckpt.mu
    return (T - a) ** 2 * (b - T / (2.0 * mu)) ** 2 / (power.P_static * T_base)


def K_dE_dT(T, ckpt: CheckpointParams, power: PowerParams,
            T_base: float = 1.0, device="cuda"):
    """K(T) * E'(T) — an exact quadratic polynomial in T (paper §3.2)."""
    return K_factor(T, ckpt, power, T_base, device) * energy_final_prime(
        T, ckpt, power, T_base, device)


# --------------------------------------------------------------------------
# Multilevel (buddy + PFS) model — first-order extension of §3.1 / §3.2
# --------------------------------------------------------------------------
#
# Periods 1..m-1 of a superperiod write the buddy level (C1), period m the
# deep level (C2).  With a_m, b_m and mu_m = mu/(1+q(m-1)) from the params,
# the makespan keeps the paper's form
#
#     T_final(T, m) = T_base * T / ((T - a_m)(b_m - T/(2 mu_m)))
#
# and K_m(T) * dE/dT stays an exact quadratic in T.  Every expression is
# the reference's term for term, so degenerate levels at m=1 reduce
# bit-for-bit to the single-level forms.


class MultilevelPhaseTimes(NamedTuple):
    """Expected cumulative phase durations, split per I/O level."""

    T_final: torch.Tensor
    T_cal: torch.Tensor
    T_io1: torch.Tensor    # buddy-level I/O (writes + soft recoveries)
    T_io2: torch.Tensor    # deep-level I/O (writes + hard recoveries)
    T_down: torch.Tensor


def ml_time_final(T, m: int, ck: MultilevelCheckpointParams,
                  T_base: float = 1.0, device="cuda"):
    """Expected makespan of the two-level scheme at period T, PFS every m."""
    T = as_f64(T, device)
    a, b, mu_m = ck.a(m), ck.b(m), ck.mu_eff(m)
    return T_base * T / ((T - a) * (b - T / (2.0 * mu_m)))


def ml_phase_times(T, m: int, ck: MultilevelCheckpointParams,
                   T_base: float = 1.0,
                   device="cuda") -> MultilevelPhaseTimes:
    """Per-phase expectations of the two-level scheme (§3.2 analogue)."""
    T = as_f64(T, device)
    m = int(m)
    C1, R1, D1 = ck.C1, ck.R1, ck.D1
    C2, R2, D2 = ck.C2, ck.R2, ck.D2
    q, w1, w2 = ck.q, ck.w1, ck.w2
    a = ck.a(m)

    Tf = ml_time_final(T, m, ck, T_base, T.device)
    nf = Tf / ck.mu

    # Re-executed work per failure; the overlapped share S2_omega is the
    # hazard-during-flush quadratic.
    S2 = ck.S2(m)
    Ew = (T**2 - S2) / (2.0 * T) + ck.S2_omega(m) / (2.0 * T)
    w_soft = ck.C_omega_mean(m) + Ew
    w_hard = w2 * C2 + (m - 1) * (T - (1.0 - w1) * C1) / 2.0 + Ew
    T_cal = T_base + nf * (w_soft + q * (w_hard - w_soft))

    # Fault-free checkpoint I/O per level, then per-failure I/O: wasted
    # in-flight write + recovery read + (hard only) the (m-1)/2 re-executed
    # buddy writes of the rolled-back periods.
    ck_io1 = T_base * ((m - 1) * C1 / m) / (T - a)
    ck_io2 = T_base * (C2 / m) / (T - a)
    io1_pf = ((m - 1) / m) * C1**2 / (2.0 * T) + (1.0 - q) * R1 \
        + q * (m - 1) * C1 / 2.0
    io2_pf = C2**2 / (2.0 * m * T) + q * R2
    T_io1 = ck_io1 + nf * io1_pf
    T_io2 = ck_io2 + nf * io2_pf

    T_down = nf * (D1 + q * (D2 - D1))
    return MultilevelPhaseTimes(T_final=Tf, T_cal=T_cal, T_io1=T_io1,
                                T_io2=T_io2, T_down=T_down)


def ml_energy_final(T, m: int, ck: MultilevelCheckpointParams,
                    power: MultilevelPowerParams, T_base: float = 1.0,
                    device="cuda"):
    """E_final with per-level I/O powers."""
    ph = ml_phase_times(T, m, ck, T_base, device)
    return (ph.T_cal * power.P_cal
            + ph.T_io1 * power.P_io1
            + ph.T_io2 * power.P_io2
            + ph.T_down * power.P_down
            + ph.T_final * power.P_static)


def ml_energy_breakdown(T, m: int, ck: MultilevelCheckpointParams,
                        power: MultilevelPowerParams, T_base: float = 1.0,
                        device="cuda") -> dict:
    """Per-component energy dict (reports and tests)."""
    ph = ml_phase_times(T, m, ck, T_base, device)
    comp = {
        "E_cal": float(ph.T_cal * power.P_cal),
        "E_io1": float(ph.T_io1 * power.P_io1),
        "E_io2": float(ph.T_io2 * power.P_io2),
        "E_down": float(ph.T_down * power.P_down),
        "E_static": float(ph.T_final * power.P_static),
    }
    comp["E_final"] = sum(comp.values())
    comp["T_final"] = float(ph.T_final)
    return comp


def _ml_W_coefficients(m: int, ck: MultilevelCheckpointParams,
                       power: MultilevelPowerParams):
    """(W0, W1, Wm, J) with E = Pc*Tb + Ps*Tf + (Tf/mu)(W0 + W1*T + Wm/T)
    + J*Tb/(T - a_m), the rational normal form of :func:`ml_energy_final`
    (host floats)."""
    C1, R1, D1 = ck.C1, ck.R1, ck.D1
    C2, R2, D2 = ck.C2, ck.R2, ck.D2
    q, w1, w2 = ck.q, ck.w1, ck.w2
    Cw = ck.C_omega_mean(m)
    Pc, P1, P2, Pd = power.P_cal, power.P_io1, power.P_io2, power.P_down
    S2 = ck.S2(m)

    W0 = (Pc * (Cw + q * (w2 * C2 - Cw
                          - (m - 1) * (1.0 - w1) * C1 / 2.0))
          + P1 * ((1.0 - q) * R1 + q * (m - 1) * C1 / 2.0)
          + P2 * q * R2
          + Pd * (D1 + q * (D2 - D1)))
    W1 = Pc * (1.0 + q * (m - 1)) / 2.0
    Wm = (Pc * (ck.S2_omega(m) - S2) / 2.0
          + P1 * (m - 1) * C1**2 / (2.0 * m)
          + P2 * C2**2 / (2.0 * m))
    J = P1 * (m - 1) * C1 / m + P2 * C2 / m
    return W0, W1, Wm, J


def ml_energy_final_prime(T, m: int, ck: MultilevelCheckpointParams,
                          power: MultilevelPowerParams, T_base: float = 1.0,
                          device="cuda"):
    """Analytic dE_final/dT of the two-level model (W normal form)."""
    T = as_f64(T, device)
    a, b, mu_m = ck.a(m), ck.b(m), ck.mu_eff(m)
    W0, W1, Wm, J = _ml_W_coefficients(m, ck, power)

    Tf = ml_time_final(T, m, ck, T_base, T.device)
    Tfp = T_base * (-a * b + T**2 / (2.0 * mu_m)) \
        / ((T - a) ** 2 * (b - T / (2.0 * mu_m)) ** 2)
    W = W0 + W1 * T + Wm / T
    Wp = W1 - Wm / T**2
    return (power.P_static * Tfp
            + Tfp / ck.mu * W
            + Tf / ck.mu * Wp
            - J * T_base / (T - a) ** 2)


def ml_K_factor(T, m: int, ck: MultilevelCheckpointParams,
                power: MultilevelPowerParams, T_base: float = 1.0,
                device="cuda"):
    """K_m = (T-a_m)^2 (b_m - T/2mu_m)^2 / (P_static * T_base)."""
    T = as_f64(T, device)
    a, b, mu_m = ck.a(m), ck.b(m), ck.mu_eff(m)
    return (T - a) ** 2 * (b - T / (2.0 * mu_m)) ** 2 \
        / (power.P_static * T_base)


def ml_K_dE_dT(T, m: int, ck: MultilevelCheckpointParams,
               power: MultilevelPowerParams, T_base: float = 1.0,
               device="cuda"):
    """K_m(T) * E'(T), an exact quadratic in T."""
    return ml_K_factor(T, m, ck, power, T_base, device) \
        * ml_energy_final_prime(T, m, ck, power, T_base, device)


def K_dE_dT_autodiff(T, ckpt: CheckpointParams, power: PowerParams,
                     T_base: float = 1.0, device="cuda"):
    """Independent cross-check of :func:`K_dE_dT`: K(T) times the
    ``torch.autograd`` derivative of E_final written out afresh."""
    C, R, D, mu, omega = ckpt.C, ckpt.R, ckpt.D, ckpt.mu, ckpt.omega
    a, b = ckpt.a, ckpt.b
    Pc, Pi, Pd, Ps = power.P_cal, power.P_io, power.P_down, power.P_static

    def e_final(t):
        tf = T_base * t / ((t - a) * (b - t / (2.0 * mu)))
        nf = tf / mu
        t_cal = T_base + nf * (omega * C + (t**2 - C**2) / (2 * t)
                               + omega * C**2 / (2 * t))
        t_io = (T_base * C / (t - (1 - omega) * C)
                + nf * (R + C**2 / (2 * t)))
        t_down = nf * D
        return t_cal * Pc + t_io * Pi + t_down * Pd + tf * Ps

    tv = as_f64(T, device).detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(e_final(tv).sum(), tv)
    tv = tv.detach()
    k = (tv - a) ** 2 * (b - tv / (2 * mu)) ** 2 / (Ps * T_base)
    return (k * g).to(F64)
