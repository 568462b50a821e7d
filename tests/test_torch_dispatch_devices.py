"""The grid split across devices (``sim.dispatch``: ``effective_devices``,
``sweep_mesh``, ``pieces``) and the environment config, on the CPU.

A CPU machine shows one device, so the split is exercised by repeating it:
``sweep_mesh`` and ``effective_devices`` are monkeypatched to hand out
``(cpu,) * n`` (the counterpart of the reference's virtual-device recipe;
on the card ``chip_smoke.py`` phase 17 does the same with ``cuda:0``).
Every piece then runs the code a device of a real split runs (its own
inputs, blocks, draws and launches, the outputs gathered on the caller's
device), and each of the five entry points must equal its unsplit call
bit for bit, for n in {1, 2, 3}, on grids both larger and smaller than n.
``default_config`` is held against the reference's on the same
environment.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro.sim.dispatch as RD

import repro_torch.core as PC
import repro_torch.sim as TS
from repro_torch.kernels import event_sweep as ES
from repro_torch.sim import dispatch as TD
from repro_torch.sim import engine as TE

CPU = torch.device("cpu")
NS = [1, 2, 3]
BATCH_FIELDS = ("wall_time", "energy", "work_executed", "io_time",
                "down_time", "n_failures", "n_checkpoints", "truncated",
                "gaps_exhausted")


def _split(monkeypatch, n: int):
    """Make every call on the CPU split over ``n`` copies of the CPU."""
    monkeypatch.setattr(TD, "effective_devices",
                        lambda config=None, device="cuda": n)
    monkeypatch.setattr(TD, "sweep_mesh", lambda k: (CPU,) * k)


def _grid(n_mu: int, n_rho: int):
    return TS.mu_rho_grid(np.geomspace(120.0, 1200.0, n_mu),
                          np.linspace(2.0, 10.0, n_rho), device=CPU)


GRIDS = {"15pt": (5, 3), "2pt": (2, 1)}


def _equal(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape, f
        assert torch.equal(x, y) or (
            x.is_floating_point() and torch.equal(x.isnan(), y.isnan())
            and torch.equal(x[~x.isnan()], y[~y.isnan()])), f


def _periods(grid):
    res = TS.evaluate_grid(grid, device=CPU)
    return res.T_time.reshape(-1), res.T_energy.reshape(-1)


def test_pieces_cover_the_axis_once():
    d = (CPU,) * 3
    assert TD.pieces(10, d) == [(CPU, 0, 4), (CPU, 4, 7), (CPU, 7, 10)]
    assert TD.pieces(2, d) == [(CPU, 0, 1), (CPU, 1, 2)]
    assert TD.pieces(0, d) == []
    assert TD.pieces(5, (CPU,)) == [(CPU, 0, 5)]


def test_effective_devices_on_the_cpu_and_sweep_mesh():
    assert TD.effective_devices(TS.DispatchConfig(), CPU) == 1
    assert TD.effective_devices(TS.DispatchConfig(shard=False), "cpu") == 1
    assert TD.split_devices(None, CPU) == (CPU,)
    assert TD.sweep_mesh(2) == (torch.device("cuda", 0),
                                torch.device("cuda", 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TD.effective_devices()


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("shape", list(GRIDS), ids=list(GRIDS))
def test_evaluate_grid_split_is_bitwise(monkeypatch, n, shape):
    grid = _grid(*GRIDS[shape])
    cfgs = (None, TS.DispatchConfig(chunk=2))
    want = [TS.evaluate_grid(grid, dispatch=c, device=CPU) for c in cfgs]
    _split(monkeypatch, n)
    for c, w in zip(cfgs, want):
        got = TS.evaluate_grid(grid, dispatch=c, device=CPU)
        _equal(got, w, ("T_time", "T_energy", "T_young", "T_daly", "T_msk",
                        "Tf_time", "Tf_energy", "E_time", "E_energy",
                        "time_ratio", "energy_ratio", "valid"))


@pytest.mark.parametrize("n", NS)
def test_evaluate_multilevel_grid_split_is_bitwise(monkeypatch, n):
    grids = [TS.buddy_ratio_grid([0.05, 0.2, 1.0], [0.02, 0.1, 0.3],
                                 mu_min=300.0, device=CPU),
             TS.buddy_ratio_grid([0.1, 0.5], [0.2], mu_min=600.0,
                                 device=CPU)]
    kw = dict(m_values=(1, 2, 4, 8), device=CPU)
    want = [TS.evaluate_multilevel_grid(g, m_max=3, **kw) for g in grids]
    _split(monkeypatch, n)
    for g, w in zip(grids, want):
        got = TS.evaluate_multilevel_grid(g, m_max=3, **kw)
        _equal(got, w, ("T_time", "T_energy", "m_time", "m_energy",
                        "Tf_time", "E_energy", "valid", "T_time_by_m",
                        "valid_by_m"))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", ["event", "step"])
def test_simulate_trajectories_split_is_bitwise(monkeypatch, n, kind):
    cases = []
    for shape in GRIDS.values():
        grid = _grid(*shape)
        T = _periods(grid)[1].reshape(grid.shape)
        gaps = np.random.default_rng(3).exponential(
            300.0, size=(grid.size, 16, 64))
        cases.append((grid, T, dict(gaps=gaps)))
        cases.append((grid, T, dict(process=PC.Weibull(shape=0.7))))
    kw = dict(T_base=2000.0, n_trials=16, seed=4, engine_kind=kind,
              device=CPU)
    want = [TS.simulate_trajectories(T, g, **kw, **x) for g, T, x in cases]
    _split(monkeypatch, n)
    for (g, T, x), w in zip(cases, want):
        got = TS.simulate_trajectories(T, g, **kw, **x)
        _equal(got, w, BATCH_FIELDS)


@pytest.mark.parametrize("n", NS)
def test_simulate_candidates_split_is_bitwise(monkeypatch, n):
    grid = _grid(*GRIDS["15pt"])
    one = _grid(1, 1)
    Tt, Te = _periods(grid)
    T_cand = torch.stack([Tt, Te, 1.5 * Te]).reshape((3,) + grid.shape)
    T_one = torch.tensor([60.0, 90.0, 140.0, 200.0], dtype=torch.float64)
    rng = np.random.default_rng(5)
    cases = [(T_cand, grid, dict(gaps=rng.exponential(
                  300.0, size=(grid.size, 8, 64)))),
             (T_cand, grid, dict(process=PC.Exponential())),
             (T_one, one, dict(gaps=rng.exponential(300.0, size=(8, 64)))),
             (T_one, one, dict(process=PC.Weibull(shape=0.7)))]
    kw = dict(T_base=2000.0, n_trials=8, seed=6, device=CPU)
    want = [TS.simulate_candidates(T, g, **kw, **x) for T, g, x in cases]
    _split(monkeypatch, n)
    for (T, g, x), w in zip(cases, want):
        got = TS.simulate_candidates(T, g, **kw, **x)
        _equal(got, w, BATCH_FIELDS)


@pytest.mark.parametrize("n", NS)
def test_simulate_trajectories_ml_split_is_bitwise(monkeypatch, n):
    kw = dict(T_base=2000.0, device=CPU)
    cases = [(TS.buddy_ratio_grid([0.1, 0.25], [0.1, 0.3], mu_min=600.0,
                                  device=CPU), 24),
             (TS.buddy_ratio_grid([0.1], [0.3], mu_min=600.0, device=CPU),
              2)]
    want = [TS.simulate_trajectories_ml(60.0, 3, g, n_trials=t,
                                        rng=np.random.default_rng(2), **kw)
            for g, t in cases]
    _split(monkeypatch, n)
    for (g, t), w in zip(cases, want):
        got = TS.simulate_trajectories_ml(60.0, 3, g, n_trials=t,
                                          rng=np.random.default_rng(2), **kw)
        _equal(got, w, ("wall_time", "energy", "work_executed", "io1_time",
                        "io2_time", "down_time", "n_failures",
                        "n_hard_failures", "n_ckpt1", "n_ckpt2",
                        "truncated", "gaps_exhausted"))
        assert got.steps == w.steps


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("policy", [TS.F64, TS.COMPENSATED_F32],
                         ids=["f64", "compensated_f32"])
def test_sampled_launches_one_a_piece(monkeypatch, n, policy):
    """The card's auto-sampled path (``_run_sampled``: one in-kernel-draw
    call a block), run on CPU tensors: bitwise the unsplit call, one call
    a (bucket, device piece), the pieces drawing by global point index."""
    grid = _grid(*GRIDS["15pt"])
    T = _periods(grid)[0].reshape(grid.shape)
    proc = PC.Weibull(shape=0.7)
    flat, T_arr, Tb_arr = TE._flat_inputs(T, grid, 2000.0, CPU)
    run = lambda: TE._assemble_batch(TE._run_sampled(
        flat, T_arr, Tb_arr, 32, 9, proc, None, None, policy), grid, 32)
    want = run()
    buckets = list(TE._buckets(T_arr, flat, Tb_arr, proc, None))
    _split(monkeypatch, n)
    c0 = ES.event_sweep_sampled_plain.calls
    got = run()
    calls = ES.event_sweep_sampled_plain.calls - c0
    _equal(got, want, BATCH_FIELDS)
    assert calls == sum(min(n, len(idx)) for _, _, idx in buckets)


ENV = {"REPRO_SWEEP_DEVICES": "3", "REPRO_SWEEP_CHUNK": "4096",
       "REPRO_SWEEP_MEMORY_MB": "64"}


@pytest.mark.parametrize("env", [{}, ENV, {"REPRO_SWEEP_DEVICES": "1"},
                                 {"REPRO_SWEEP_CHUNK": "x"}],
                         ids=["unset", "all", "one_device", "malformed"])
def test_default_config_reads_the_reference_environment(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    warns = (lambda: pytest.warns(RuntimeWarning)) if "x" in env.values() \
        else contextlib.nullcontext
    with warns():
        ref = RD.default_config()
    with warns():
        got = TS.default_config()
    assert got.devices == ref.devices
    assert got.chunk_size() == ref.chunk
    assert got.budget() == ref.budget()
    assert got.shard == ref.shard
