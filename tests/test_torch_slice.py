"""The whole slice, reference against port, and the port's isolation.

The reference's ``evaluate_grid`` feeds its AlgoT and AlgoE periods to its
``simulate_trajectories`` on a shared numpy schedule; the port runs the
same pipeline on the state carried across by ``repro_torch.interop``.
Tolerances are those of the per-module tests: periods 1e-8, Tf/E 1e-10,
trajectory floats 1e-13 relative, failure counts and flags exact, and
checkpoint counts within one in at most 0.5% of lanes.

The port's package and ``chip_smoke.py`` never import JAX or the
reference package: checked in a fresh interpreter and by an AST scan.
"""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.sim as RS
from repro.core import Weibull
from repro.sim.engine import presample_gaps

import repro_torch.sim as TS
from repro_torch import interop

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CPU = "cpu"


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


@pytest.mark.parametrize("process", [None, "weibull"])
def test_slice_sweep_then_mc_matches_reference(process):
    proc = None if process is None else Weibull(shape=0.7)
    grid = RS.mu_rho_grid(np.geomspace(120.0, 1200.0, 4),
                          np.linspace(2.0, 10.0, 3))
    T_base, n_trials = 4000.0, 64
    ref = RS.evaluate_grid(grid, T_base=T_base)

    tgrid = interop.grid_from_fields(grid.fields(), device=CPU)
    got = TS.evaluate_grid(tgrid, T_base=T_base, device=CPU)
    for f in ("T_time", "T_energy"):
        assert _rel(getattr(got, f).numpy(), getattr(ref, f)).max() <= 1e-8
    for f in ("Tf_time", "Tf_energy", "E_time", "E_energy"):
        assert _rel(getattr(got, f).numpy(), getattr(ref, f)).max() <= 1e-10

    for f in ("T_time", "T_energy"):
        T_ref = np.asarray(getattr(ref, f))
        cap = int(RS.fail_capacity_points(T_ref.ravel(), grid.ravel(),
                                          T_base, process=proc).max())
        gaps = presample_gaps(grid, n_trials, cap, seed=17, process=proc)
        a = RS.simulate_trajectories(T_ref, grid, T_base=T_base, gaps=gaps,
                                     engine_kind="event")
        b = TS.simulate_trajectories(
            getattr(got, f), tgrid, T_base=T_base,
            gaps=interop.schedule_to_device(gaps, CPU), device=CPU)
        assert not bool(b.truncated.any() | b.gaps_exhausted.any())
        for k in ("wall_time", "energy", "work_executed", "io_time",
                  "down_time"):
            assert _rel(getattr(b, k).numpy(), getattr(a, k)).max() <= 1e-13
        for k in ("n_failures", "truncated", "gaps_exhausted"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)))
        dc = b.n_checkpoints.numpy().astype(np.int64) - np.asarray(
            a.n_checkpoints)
        assert np.abs(dc).max() <= 1
        assert np.count_nonzero(dc) <= 0.005 * dc.size


def test_interop_carries_params_and_schedules():
    from repro.core import EXASCALE_POWER_RHO7, fig12_checkpoint
    ck, pw = fig12_checkpoint(120.0), EXASCALE_POWER_RHO7
    tck = interop.ckpt_from_fields(dataclasses.asdict(ck))
    tpw = interop.power_from_fields(dataclasses.asdict(pw))
    assert dataclasses.asdict(tck) == dataclasses.asdict(ck)
    assert dataclasses.asdict(tpw) == dataclasses.asdict(pw)
    g = np.random.default_rng(0).exponential(100.0, size=(2, 3, 4))
    t = interop.schedule_to_device(g, CPU)
    assert t.is_contiguous() and t.dtype.is_floating_point
    np.testing.assert_array_equal(t.numpy(), g)
    t32 = interop.schedule_to_device(g, CPU, dtype=TS.COMPENSATED_F32
                                     .torch_dtype)
    np.testing.assert_array_equal(t32.numpy(), g.astype(np.float32))
    grid = RS.robustness_grid([0.5, 0.7], [120.0, 300.0])[0]
    tg = interop.grid_from_fields(grid.fields(), device=CPU)
    assert tg.shape == grid.shape and tg.device.type == "cpu"


def test_importing_the_port_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.sim, repro_torch.core, "
            "repro_torch.interop, repro_torch.kernels.event_sweep, "
            "repro_torch.kernels._build, repro_torch.kernels.ops, "
            "repro_torch.ckpt, repro_torch.energy, "
            "repro_torch.core.policy, repro_torch.kernels.ref, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.rglru_scan, "
            "repro_torch.kernels.mlstm_scan, "
            "repro_torch.benchmarks.bench_kernels, "
            "repro_torch.core.tradeoff, repro_torch.benchmarks.run, "
            "repro_torch.benchmarks.fig1_rho_sweep, "
            "repro_torch.benchmarks.fig2_mu_rho, "
            "repro_torch.benchmarks.fig3_scalability, "
            "repro_torch.benchmarks.fig5_robustness, "
            "repro_torch.benchmarks.table_baselines, "
            "repro_torch.benchmarks.table_simulation, "
            "repro_torch.benchmarks.quickstart, "
            "repro_torch.benchmarks.fig4_multilevel, "
            "repro_torch.benchmarks.energy_study, repro_torch.serve, "
            "repro_torch.launch.serve, "
            "repro_torch.benchmarks.bench_advisor, repro_torch.sim.cache, "
            "repro_torch.configs, repro_torch.models, repro_torch.optim, "
            "repro_torch.data, repro_torch.data.synthetic, "
            "repro_torch.optim.grad_compress, "
            "repro_torch.benchmarks.table_arch_periods, repro_torch.ft, "
            "repro_torch.ft.run, repro_torch.ft.trainer, "
            "repro_torch.launch.train, "
            "repro_torch.benchmarks.validate_runtime, "
            "repro_torch.benchmarks.train_fault_tolerant, "
            "repro_torch.models.attention, repro_torch.models.transformer, "
            "repro_torch.models.moe, repro_torch.benchmarks.serve_batched, "
            "repro_torch.parallel, repro_torch.parallel.sharding, "
            "repro_torch.launch, repro_torch.launch.mesh, "
            "repro_torch.ft.elastic, repro_torch.models.spec, "
            "repro_torch.sim.dispatch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "bad += sorted(m for m in sys.modules if m.startswith("
            "'torch.testing._internal.distributed'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)
        assert not mod.startswith("torch.testing"), (path, mod)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_a_checkout(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device, and in a directory holding nothing else of the repo."""
    import torch
    if where == "checkout" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=script.parent, env=env, timeout=300,
                         check=False)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _serving_rig(cd="bfloat16"):
    """Reduced recurrentgemma-9b at heads of 128 (the kernels' width): an
    (rglru, rglru, sliding) super-block."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    cfg = dataclasses.replace(
        reduced(get_config("recurrentgemma-9b"), d_model=128, n_heads=1),
        n_layers=3, compute_dtype=cd)
    return cfg, build(cfg)


def test_serving_entry_points_need_a_gpu_by_default():
    """Nothing of the serving path runs on the CPU unless asked to: the
    model's init, the reference's cache carried across and the launcher
    default to the card and raise without one."""
    import torch
    from repro_torch.ckpt.tree import tree_map
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, m = _serving_rig("float32")
    with pytest.raises(RuntimeError, match="cuda"):
        m.init(torch.Generator())
    tree = tree_map(lambda s: np.zeros(s.shape, s.dtype), m.cache_spec(1, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        interop.cache_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--batch", "1", "--prompt-len", "8"])
    for arch in ("dbrx-132b", "llama4-scout-17b-a16e", "whisper-tiny",
                 "internvl2-1b"):
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--arch", arch, "--batch", "1", "--prompt-len", "8"])


@pytest.mark.parametrize("wrapper", ["flash_attention", "decode_attention"])
def test_attention_kernels_take_heads_of_64_128_256(wrapper):
    """Both attention kernels are built for heads of 64 (whisper-tiny,
    internvl2-1b), 128 and 256; another width raises in the wrapper's
    launch path, before any build, and does not drop to the plain
    version."""
    import importlib
    import torch
    mod = importlib.import_module(f"repro_torch.kernels.{wrapper}")
    assert mod.HEAD_DIMS == (64, 128, 256)
    x = torch.zeros((2, 8, 32))
    args = (x, x, x, "causal", 0, 0) if wrapper == "flash_attention" else (
        x[:, :1], x, x, 8)
    calls = getattr(mod, f"{wrapper}_plain").calls
    with pytest.raises(ValueError, match="Dh"):
        mod._kernel(*args)
    assert getattr(mod, f"{wrapper}_plain").calls == calls

