"""Core: the paper's analytical checkpoint time/energy model (PyTorch)."""
from .params import (CheckpointParams, PowerParams,
                     MultilevelCheckpointParams, MultilevelPowerParams,
                     EXASCALE_POWER_RHO55, EXASCALE_POWER_RHO7,
                     EXASCALE_ML_POWER, MU_IND_JAGUAR_MIN,
                     fig12_checkpoint, fig3_checkpoint)
from .philox import CounterKey
from .failures import (FailureProcess, Exponential, Weibull, LogNormal,
                       TraceReplay, get_process, as_process, GapSpec,
                       draw_gaps)
from .model import (time_final, time_final_prime, time_fault_free,
                    time_lost_per_failure, expected_failures, phase_times,
                    energy_final, energy_breakdown, energy_final_prime,
                    K_factor, K_dE_dT,
                    K_dE_dT_autodiff, MultilevelPhaseTimes, ml_time_final,
                    ml_phase_times, ml_energy_final, ml_energy_breakdown,
                    ml_energy_final_prime, ml_K_factor, ml_K_dE_dT)
from .optimal import (t_opt_time, t_opt_time_ex, PeriodResult,
                      t_opt_time_numeric, t_opt_energy,
                      t_opt_energy_numeric, t_young, t_daly, t_msk_energy,
                      energy_quadratic_coefficients, derived_coefficients,
                      paper_printed_coefficients, MCSurrogate,
                      t_opt_time_mc, t_opt_energy_mc, mc_evaluate_periods,
                      period_for, STRATEGIES, golden_section,
                      DEFAULT_M_MAX, t_opt_time_multilevel,
                      t_opt_energy_multilevel,
                      ml_energy_quadratic_coefficients)
from .simulator import simulate, simulate_once, SimResult
from .policy import CheckpointPolicy, PolicyConfig, ML_STRATEGIES
from .tradeoff import (TradeoffPoint, evaluate, sweep_rho, sweep_mu_rho,
                       sweep_nodes, RobustnessPoint, evaluate_robustness,
                       MultilevelTradeoffPoint, evaluate_multilevel,
                       sweep_buddy_ratio)
