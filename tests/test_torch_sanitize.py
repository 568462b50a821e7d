"""The port's launch and leak sanitizer (``repro_torch.sanitize``) on the
CPU: the reference's five tests of ``tests/test_sanitizers.py``, on the
port's counts and its committed ``src/repro_torch/sanitize_budget.json``.

The negative controls prove the gates have teeth: fig2's sweep made one
point at a time must go over fig2_small's budget, the event MC made one
point at a time over mc_event_small's kernel-wrapper budget, and a
workload that keeps a tensor alive must fail the leak check.
"""
import pytest
import torch

from repro_torch import sanitize

WORKLOADS = sorted(sanitize.CANONICAL_WORKLOADS)
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", WORKLOADS)
def test_leak_clean(name):
    """No tensor a canonical workload makes outlives it."""
    sanitize.run_leak_checked(sanitize.CANONICAL_WORKLOADS[name], CPU)


@pytest.mark.parametrize("name", WORKLOADS)
def test_launch_budget(name):
    budgets = sanitize.load_budgets()
    assert budgets and name in budgets, (
        "no committed budget: run `python -m repro_torch.sanitize --write "
        "--device cpu`")
    measured = sanitize.measure_workload(sanitize.CANONICAL_WORKLOADS[name],
                                         CPU)
    sanitize.launch_gate(name, measured, budgets)   # raises on a breach
    for k in sanitize.COUNTS:
        assert measured[k] <= budgets[name][k]["budget"]
    # one cold run counts what the committed run counted
    assert measured == {k: budgets[name][k]["measured"]
                        for k in sanitize.COUNTS}


def test_budget_schema():
    budgets = sanitize.load_budgets()
    assert set(budgets) == set(WORKLOADS)
    for name in WORKLOADS:
        for k in sanitize.COUNTS:
            entry = budgets[name][k]
            assert entry["measured"] <= entry["budget"]
            # slack: committed budget = measured + max(4, 25%)
            assert entry["budget"] == entry["measured"] + max(
                4, -(-entry["measured"] // 4))


def _per_point_sweep(device):
    """The seed-era pattern: fig2_small's grid one point at a time."""
    from repro_torch.sim import F64, sweep_mu_rho_grid
    for mu in (120.0, 300.0, 600.0):
        for rho in (1.0, 2.5, 5.0):
            sweep_mu_rho_grid([mu], [rho], device=device, precision=F64)


def test_per_point_sweep_breaches_budget():
    budgets = sanitize.load_budgets()
    measured = sanitize.measure_workload(_per_point_sweep, CPU)
    assert measured["aten_ops"] > 4 * budgets["fig2_small"]["aten_ops"][
        "measured"], "expected the ops to grow with the points"
    with pytest.raises(sanitize.LaunchBudgetError, match="aten_ops"):
        sanitize.launch_gate("fig2_small", measured, budgets)


def _per_point_event_mc(device):
    """mc_event_small's grid one point at a time: a launch a point."""
    from repro_torch.launch.serve import generator
    from repro_torch.sim import F64, mu_rho_grid, simulate_trajectories
    rng = generator(0)
    for mu in (120.0, 300.0, 600.0):
        for rho in (1.0, 2.5, 5.0):
            gaps = torch.from_numpy(rng.exponential(300.0, (1, 32, 16)))
            simulate_trajectories(60.0, mu_rho_grid([mu], [rho],
                                                    device=device),
                                  gaps=gaps.to(device), engine_kind="event",
                                  precision=F64, device=device)


def test_per_point_event_mc_breaches_wrapper_budget():
    """The kernel wrapper's budget has teeth: nine launches where the
    batched workload makes one."""
    budgets = sanitize.load_budgets()
    assert budgets["mc_event_small"]["wrapper_calls"]["measured"] == 1
    measured = sanitize.measure_workload(_per_point_event_mc, CPU)
    assert measured["wrapper_calls"] == 9
    with pytest.raises(sanitize.LaunchBudgetError, match="wrapper_calls"):
        sanitize.launch_gate("mc_event_small", measured, budgets)


def test_gate_is_noop_without_committed_budget(tmp_path):
    missing = tmp_path / "nothing.json"
    assert sanitize.load_budgets(missing) is None
    sanitize.launch_gate("fig2_small", dict.fromkeys(sanitize.COUNTS,
                                                     10 ** 6), path=missing)


_KEPT = []


def test_leak_check_catches_a_kept_tensor():
    def leaky(device):
        _KEPT.append(torch.zeros(3, device=device))
    try:
        with pytest.raises(sanitize.LeakError, match="outlived"):
            sanitize.run_leak_checked(leaky, CPU)
    finally:
        _KEPT.clear()


def test_counts_a_wrapper_call_as_one_op():
    """A kernel wrapper is one aten op, one call and one signature; its
    plain version's ops are not counted; a sync shows."""
    from repro_torch.kernels import flash_attention as fa

    def run(device, calls=2):
        q = torch.randn(2, 40, 64, device=device)
        for _ in range(calls):
            fa.flash_attention(q, q, q, mode="causal")
        q.sum().item()
    counts = sanitize.measure_workload(run, CPU)
    assert counts["wrapper_calls"] == 2 and counts["signatures"] == 1
    assert counts["host_syncs"] == 1
    bare = sanitize.measure_workload(lambda d: run(d, 0), CPU)
    assert counts["aten_ops"] == bare["aten_ops"] + 2


def test_main_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sanitize.main([])
