"""Vectorized simulation + sweep subsystem (PyTorch).

Layers:
  scenarios — the scenario catalog and the struct-of-tensors
              :class:`ParamGrid` (and the two-level
              :class:`MultilevelParamGrid`) the batched layers consume.
  sweep     — batched closed-form model + period solvers (AlgoT/AlgoE/
              Young/Daly/MSK) for a whole grid, chunked to a memory budget,
              the MC robustness grids, and the two-level joint (T, m)
              solver (:func:`evaluate_multilevel_grid`).
  engine    — the Monte-Carlo engine over (grid point x trial) lanes:
              the event kernel or the step scan (``engine_kind``),
              M candidate periods on one shared schedule, and the
              two-level (buddy + PFS) step scan.
  dispatch  — memory-budget chunking, precision resolution, the named
              bounded caches (:func:`cache_stats`) and
              :func:`backend_info`.
  cache     — the persistent kernel-build directory
              (``$REPRO_COMPILE_CACHE``).
  precision — :class:`PrecisionPolicy` (f64 oracle on the CPU,
              compensated f32 on CUDA) with documented tolerances.

The scalar ``repro_torch.core.simulator.simulate_once`` is the oracle the
engine is held against.
"""
from .cache import (enable_compile_cache, maybe_enable_from_env,
                    active_cache_dir)
from .dispatch import (DispatchConfig, default_config, effective_devices,
                       sweep_mesh, resolve_precision, chunk_plan,
                       cache_stats, reset_cache_stats, BackendInfo,
                       backend_info)
from .precision import PrecisionPolicy, F64, COMPENSATED_F32
from .scenarios import (ParamGrid, Scenario, get_scenario, list_scenarios,
                        register_scenario, mu_rho_grid, nodes_grid,
                        product_grid, grid_from_scenarios, robustness_grid,
                        arch_grid, MultilevelScenario, MultilevelParamGrid,
                        multilevel_grid_from_scenarios, buddy_ratio_grid,
                        multilevel_arch_grid)
from .engine import (TrajectoryBatch, ScheduledRNG, ScheduleBlock,
                     simulate_trajectories, simulate_grid,
                     simulate_candidates, sampled_schedules,
                     presample_gaps, fail_capacity_points,
                     default_fail_capacity, step_budget_points,
                     default_step_budget, resolve_engine_kind,
                     MultilevelTrajectoryBatch, simulate_trajectories_ml,
                     simulate_grid_ml, presample_failures,
                     default_fail_capacity_ml, default_step_budget_ml)
from .sweep import (GridResult, evaluate_grid, golden_section_batched,
                    t_opt_time_batched, t_opt_energy_batched,
                    t_young_batched, t_daly_batched, t_msk_energy_batched,
                    time_final_batched, energy_final_batched,
                    sweep_rho_grid, sweep_mu_rho_grid, sweep_nodes_grid,
                    RobustnessResult, evaluate_robustness_grid,
                    evaluate_periods_grid, sweep_weibull_shapes,
                    MultilevelGridResult, evaluate_multilevel_grid,
                    ml_time_final_batched, ml_energy_final_batched)

# Persistent kernel-build directory: opt-in via $REPRO_COMPILE_CACHE (no-op
# otherwise; see sim/cache.py).
maybe_enable_from_env()
