"""Config-driven fault-tolerant runs: one spec, a built trainer, and the
model's predictions next to the measurements.

Counterpart of the reference's ``repro/ft/run.py``: a :class:`RunSpec`
dataclass fully describes a run (architecture, policy strategy, failure
scenario, power profile, scaled-time world), :func:`build` assembles the
components on ``device`` (default ``"cuda"``; it raises without a GPU),
and :func:`execute` runs it and attaches a ``predicted`` block — the
paper's ``time_final`` / ``energy_final`` (``ml_*`` for two-level runs)
evaluated at the period the run actually executed — so every run is a
predicted-vs-measured experiment by construction.

The model's initial parameters are drawn from a ``torch.Generator`` seeded
with ``spec.seed``: they agree with the reference's in distribution, not
bit for bit (callers that need the reference's parameters set
``trainer.state`` from ``interop.params_from_numpy`` before ``run()``).
The failure schedule, the data stream and, in scaled time, every duration
are the reference's exactly.

Scaled-time methodology: when ``step_s`` is set, ALL durations are virtual
— steps, per-level checkpoint costs (C1/C2), recoveries (R1/R2) and
downtimes (D1/D2) — so the run inhabits one consistent virtual-time world
whose parameters equal the analytical scenario's exactly, and the failure
schedule is the only randomness.  ``repro_torch.benchmarks.validate_runtime``
builds on this.  With ``step_s=None`` the step, checkpoint and restore
times are measured on the host clock and feed the policy's estimates.
"""
from __future__ import annotations

import dataclasses
import math
import tempfile
from typing import Optional

from .._device import resolve_device
from ..ckpt import CheckpointManager, ManagerConfig, ShardedStore, StoreConfig
from ..core import model as core_model
from ..core.failures import get_process
from ..core.params import MultilevelCheckpointParams
from ..core.policy import ML_STRATEGIES, CheckpointPolicy, PolicyConfig
from ..energy import (PAPER_EXASCALE_ML_PROFILE, PAPER_EXASCALE_PROFILE,
                      TPU_V5E_HOST_PROFILE, EnergyMeter)
from .failures import FailureInjector, FailureModel
from .tracker import Tracker
from .trainer import FaultTolerantTrainer, TrainerConfig
from .watchdog import StepTimeWatchdog, WatchdogConfig

#: power models of the energy report.  "v5e" is a TPU host's, kept as a
#: named profile for parity with the reference; the card's runs use
#: "paper" / "paper_ml".
PROFILES = {"paper": PAPER_EXASCALE_PROFILE,
            "paper_ml": PAPER_EXASCALE_ML_PROFILE,
            "v5e": TPU_V5E_HOST_PROFILE}


@dataclasses.dataclass
class RunSpec:
    """Everything a fault-tolerant training run needs, as data."""

    # -- model / data --------------------------------------------------------
    arch: str = "xlstm-125m"
    reduce: bool = True               # reduced same-family config
    layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    batch: int = 4
    seq: int = 32
    lr: float = 3e-4
    seed: int = 0
    total_steps: int = 200

    # -- policy --------------------------------------------------------------
    strategy: str = "algo_t"          # optimal.STRATEGIES + ML_STRATEGIES
    fixed_period_s: float = 600.0
    #: deep-storage cadence; None = policy-chosen (the (T, m) solver's m
    #: under the *_ml strategies, 1 otherwise).
    pfs_every: Optional[int] = None
    use_buddy: bool = True
    #: learn mu from observed gaps (True) or trust the scenario (False —
    #: the validation default: predictions need the configured mu).
    mu_from_observations: bool = False

    # -- failure scenario (virtual-time world) -------------------------------
    #: virtual seconds per training step; None = measured wall time (the
    #: scaled-time machinery below then stays off).
    step_s: Optional[float] = 1.0
    mu_s: float = float("inf")        # inf = no failure injection
    C_s: float = 0.5                  # deep (PFS, level-2) checkpoint cost
    R_s: float = 0.5
    D_s: float = 0.1
    C1_s: Optional[float] = None      # buddy (level-1) costs; None = deep's
    R1_s: Optional[float] = None
    D1_s: Optional[float] = None
    q: float = 0.0                    # P[failure also loses the buddy]
    omega: float = 0.0                # checkpoint overlap factor
    #: deep-flush overlap (VELOC async flush); None -> shared ``omega``.
    #: At omega2 > 0 the deep write stays in flight for ``omega2 * C``
    #: after its stall — a failure inside that window aborts the flush
    #: and rolls back to the previous surviving generation.
    omega2: Optional[float] = None
    process: str = "exponential"      # core.failures.PROCESSES name
    process_kwargs: dict = dataclasses.field(default_factory=dict)

    # -- accounting / storage ------------------------------------------------
    profile: str = "paper"            # PROFILES name
    ckpt_dir: Optional[str] = None    # None = fresh tempdir
    compress: bool = False
    checkpoint_at_start: bool = True
    max_failures: int = 10_000

    # -- derived -------------------------------------------------------------
    @property
    def scaled_time(self) -> bool:
        return self.step_s is not None

    @property
    def inject(self) -> bool:
        return self.mu_s > 0 and math.isfinite(self.mu_s)

    def level1(self) -> tuple[float, float, float]:
        """(C1, R1, D1), defaulting to degenerate levels."""
        return (self.C_s if self.C1_s is None else self.C1_s,
                self.R_s if self.R1_s is None else self.R1_s,
                self.D_s if self.D1_s is None else self.D1_s)

    def ml_params(self) -> MultilevelCheckpointParams:
        """The scenario as the two-level model's parameters (degenerate
        levels + m=1 reduce bit-for-bit to the single-level model)."""
        C1, R1, D1 = self.level1()
        return MultilevelCheckpointParams(
            C1=C1, R1=R1, D1=D1, C2=self.C_s, R2=self.R_s, D2=self.D_s,
            mu=self.mu_s, q=self.q, omega=self.omega, omega2=self.omega2)


def build(spec: RunSpec, tracker: Optional[Tracker] = None,
          device="cuda") -> FaultTolerantTrainer:
    """Assemble the full trainer stack from a spec, its state, store,
    policy and data on ``device``."""
    import torch

    from ..configs import get_config, reduced
    from ..data import synthetic
    from ..models import build as build_model
    from ..optim import adamw

    dev = resolve_device(device)
    cfg = get_config(spec.arch)
    if spec.reduce:
        cfg = reduced(cfg, n_layers=spec.layers, d_model=spec.d_model,
                      n_heads=spec.n_heads)
    model = build_model(cfg)
    ocfg = adamw.AdamWConfig(lr=spec.lr, warmup_steps=20,
                             total_steps=spec.total_steps)
    gen = torch.Generator(device=dev).manual_seed(spec.seed)
    params = model.init(gen, device=dev)
    opt = adamw.init_state(params, ocfg, device=dev)

    profile = PROFILES[spec.profile]
    C1, R1, D1 = spec.level1()
    policy = CheckpointPolicy(
        PolicyConfig(strategy=spec.strategy,
                     fixed_period_s=spec.fixed_period_s,
                     C_s=spec.C_s, R_s=spec.R_s, D_s=spec.D_s,
                     C1_s=C1, R1_s=R1, D1_s=D1, q=spec.q,
                     mu_s=spec.mu_s, omega=spec.omega, omega2=spec.omega2,
                     mu_from_observations=spec.mu_from_observations),
        profile.power_params(), ml_power=profile.ml_power_params(),
        device=dev)

    ckpt_dir = spec.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    store = ShardedStore(StoreConfig(root=ckpt_dir, compress=spec.compress,
                                     device=dev))
    manager = CheckpointManager(store, policy, ManagerConfig(
        async_write=True, use_buddy=spec.use_buddy,
        pfs_every=spec.pfs_every,
        virtual_C1_s=C1 if spec.scaled_time else None,
        virtual_C2_s=spec.C_s if spec.scaled_time else None))

    # Without a buddy level every recovery is deep: downtime is D2 flat.
    soft_D = D1 if spec.use_buddy else spec.D_s
    injector = FailureInjector(FailureModel(
        mu_s=spec.mu_s if spec.inject else float("inf"),
        downtime_s=soft_D if spec.scaled_time else spec.D_s,
        downtime_hard_s=spec.D_s if spec.scaled_time else None,
        recovery_buddy_s=R1 if spec.scaled_time else None,
        recovery_deep_s=spec.R_s if spec.scaled_time else None,
        buddy_loss_prob=spec.q if spec.use_buddy else 0.0,
        seed=spec.seed,
        process=(None if spec.process == "exponential"
                 else get_process(spec.process, **spec.process_kwargs))))

    data = synthetic.for_arch(cfg, batch=spec.batch, seq_len=spec.seq,
                              seed=spec.seed, device=dev)
    step_fn = model.make_train_step(ocfg)
    # Straggler watchdog + manager alarms both surface through the
    # trainer's Tracker (events: "straggler", "alarm") and run report.
    watchdog = StepTimeWatchdog(WatchdogConfig())
    return FaultTolerantTrainer(
        train_step=step_fn, state=(params, opt), data=data, policy=policy,
        manager=manager, meter=EnergyMeter(profile), failures=injector,
        tracker=tracker, watchdog=watchdog,
        config=TrainerConfig(total_steps=spec.total_steps,
                             sim_seconds_per_step=spec.step_s,
                             checkpoint_at_start=spec.checkpoint_at_start,
                             max_failures=spec.max_failures))


def predictions(spec: RunSpec, report: dict, device="cuda") -> dict:
    """The paper's expected wall time and energy at the period the run
    actually executed (the operating point's realized T and the manager's
    effective m), against a base work of ``total_steps * step_s``,
    evaluated in f64 on ``device``."""
    if not (spec.scaled_time and spec.inject):
        return {}
    op = report["operating_point"]
    T_used, m = op["period_realized_s"], int(op["deep_every"])
    T_base = spec.total_steps * spec.step_s
    ck = spec.ml_params()
    power = PROFILES[spec.profile].ml_power_params()
    out = {"T_used_s": T_used, "m": m, "T_base_s": T_base,
           "wall_s": float(core_model.ml_time_final(
               T_used, m, ck, T_base=T_base, device=device)),
           "energy_j": float(core_model.ml_energy_final(
               T_used, m, ck, power, T_base=T_base, device=device))}
    meas_wall = report["wall_s"]
    meas_energy = report["energy"]["E_total_j"]
    out["wall_ratio"] = meas_wall / out["wall_s"]
    out["energy_ratio"] = meas_energy / out["energy_j"]
    return out


def execute(spec: RunSpec, tracker: Optional[Tracker] = None,
            device="cuda") -> dict:
    """Build, run, and attach the ``predicted`` block to the report."""
    trainer = build(spec, tracker=tracker, device=device)
    report = trainer.run()
    report["spec"] = dataclasses.asdict(spec)
    report["predicted"] = predictions(spec, report, device=device)
    return report


__all__ = ["RunSpec", "build", "execute", "predictions", "PROFILES",
           "ML_STRATEGIES"]
