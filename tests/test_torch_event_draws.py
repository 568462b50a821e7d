"""The event kernel's in-kernel draws, held on the CPU.

``kernels/event_sweep.py::event_sweep_sampled`` draws each lane's gaps
inside the kernel (Philox-4x32-10 and the process's inverse CDF, from a
:class:`~repro_torch.core.failures.GapSpec`).  What can be checked without
a card:

* the kernel's integer path, modelled in numpy uint32/uint64 (``__umulhi``
  as ``(a * b) >> 32``, one Philox call per pair of gaps with words 2-3
  kept for the odd gap, ``_unit``), equals ``CounterKey.uniforms`` bit for
  bit;
* the spec, applied gap by gap, equals ``sample_gaps`` bitwise;
* ``event_sweep_sampled`` on CPU tensors is its plain version (the drawn
  schedule through ``event_sweep_plain``), the engine's fused path equals
  its two-step path under any ``DispatchConfig``, and both agree with the
  JAX package's engine on the same schedule (trajectory floats 1e-13
  relative, failure counts and flags exactly, checkpoint counts within one
  in at most 0.5% of lanes: the tolerances of ``test_torch_engine.py``);
* the explicit wrapper reads a ``(B, N, F)`` schedule and its ``(B, F,
  N)``-strided copy to the same bits.

The kernel itself runs only on the card (``chip_smoke.py``; the ``gpu``
test below).
"""
import numpy as np
import pytest
import torch

import repro.sim as RS

import repro_torch.core as PC
import repro_torch.sim as TS
from repro_torch import interop
from repro_torch.core import failures as FL
from repro_torch.core.philox import CounterKey
from repro_torch.kernels import event_sweep as ES
from repro_torch.sim import engine as TE

CPU = "cpu"
F64 = torch.float64
FIELDS = ("wall_time", "energy", "work_executed", "io_time", "down_time",
          "n_failures", "n_checkpoints", "truncated", "gaps_exhausted")
TRACE = (40.0, 500.0, 120.0, 90.0, 800.0, 33.0)
PROCESSES = [PC.Exponential(), PC.Weibull(shape=0.7),
             PC.Weibull(shape=np.array([0.5, 0.9, 1.4, 0.7, 2.0])),
             PC.LogNormal(sigma=1.0), PC.TraceReplay(gaps=TRACE),
             PC.TraceReplay(gaps=TRACE, rescale=False)]
PIDS = ["exponential", "weibull", "weibull_per_point", "lognormal",
        "trace", "trace_raw"]
#: global point indices past 2^16, near 2^31 and past 2^32, as a block of
#: a large grid
POINTS = torch.tensor([0, 3, 70_000, 2**32 + 65_537, 2**31 - 5],
                      dtype=torch.int64)
MEANS = torch.tensor([120.0, 300.0, 700.0, 80.0, 1500.0], dtype=F64)


# ---------------------------------------------------------------------------
# The kernel's integer path, in numpy
# ---------------------------------------------------------------------------

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_LO = np.uint64(0xFFFFFFFF)


def _philox_np(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 as the kernel computes it: 32-bit words in uint64
    arrays, ``__umulhi(m, x)`` = ``(m * x) >> 32`` and the low product
    ``m * x`` mod 2^32."""
    c0, c1, c2, c3 = (np.asarray(c, dtype=np.uint64) for c in (c0, c1, c2,
                                                              c3))
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2          # < 2^64: exact in uint64
        hi0, lo0 = p0 >> np.uint64(32), p0 & _LO
        hi1, lo1 = p1 >> np.uint64(32), p1 & _LO
        c0, c1, c2, c3 = (hi1 ^ c1 ^ np.uint64(k0), lo1,
                          hi0 ^ c3 ^ np.uint64(k1), lo0)
        k0, k1 = (k0 + _W0) & 0xFFFFFFFF, (k1 + _W1) & 0xFFFFFFFF
    return c0, c1, c2, c3


def _unit_np(a, b) -> np.ndarray:
    x = ((a >> np.uint64(6)) << np.uint64(26)) | (b >> np.uint64(6))
    return (x.astype(np.float64) + 0.5) * 2.0**-52


def _kernel_uniforms(seed: int, points, trials, n: int) -> np.ndarray:
    """(points, trials, n) uniforms drawn as a lane of the kernel draws
    them: j = 0, 1, 2, ... in order, one Philox call at each even j, words
    2-3 kept for the odd j that follows; a point's low and high words are
    counter words 2 and 3."""
    pt = np.asarray(points, dtype=np.uint64)[:, None]
    tr = np.asarray(trials, dtype=np.uint64)[None, :]
    k0, k1 = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    out = np.empty(pt.shape[:1] + tr.shape[1:] + (n,), dtype=np.float64)
    cached = None
    for j in range(n):
        if j % 2 == 0:
            w0, w1, w2, w3 = _philox_np(np.uint64(j // 2), tr, pt & _LO,
                                        pt >> np.uint64(32), k0, k1)
            hi, lo, cached = w0, w1, (w2, w3)
        else:
            hi, lo = cached
        out[..., j] = _unit_np(hi, lo)
    return out


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 3, 2**40 + 2**33 + 11])
def test_integer_path_equals_counter_uniforms(seed):
    trials = np.array([0, 1, 65_535, 65_536, 131_071, 2**31 + 7])
    n = 2**12 + 1                           # odd, so the last gap is even
    want = CounterKey(seed, POINTS, torch.as_tensor(trials)).uniforms(n)
    got = _kernel_uniforms(seed, POINTS.numpy(), trials, n)
    assert np.array_equal(got.view(np.int64), want.numpy().view(np.int64))
    assert got.min() > 0.0 and got.max() < 1.0


def test_points_past_2_32_have_their_own_stream():
    """A point's high word is a counter word: point 2^32 + i draws neither
    point i's uniforms nor point 2^33 + i's."""
    trials = torch.arange(4)
    u = [CounterKey(7, torch.tensor([p]), trials).uniforms(6)
         for p in (3, 2**32 + 3, 2**33 + 3)]
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[1], u[2])
    assert np.array_equal(_kernel_uniforms(7, [2**32 + 3], trials.numpy(),
                                           6), u[1].numpy())


def test_philox_model_known_answers():
    """The numpy model against the Random123 known-answer vectors."""
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
            ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
             (0xA4093822, 0x299F31D0),
             (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))):
        got = _philox_np(*[np.uint64(c) for c in ctr], *key)
        assert [int(w) for w in got] == list(want)


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------

def _key(seed=7, trial0=65_530, n_trials=9):
    return CounterKey(seed, POINTS, torch.arange(trial0, trial0 + n_trials))


def _per_gap(spec: FL.GapSpec, key: CounterKey, n: int) -> torch.Tensor:
    """The spec applied one gap at a time, as a lane of the kernel applies
    it (uniforms from the kernel's integer path)."""
    u = torch.from_numpy(_kernel_uniforms(key.seed, key.points.numpy(),
                                          key.trials.numpy(), n))
    P, N = key.shape
    out = torch.empty((P, N, n), dtype=F64)
    one = lambda x: torch.tensor([float(x)], dtype=F64)
    for p in range(P):
        a, b = one(spec.a[p]), one(spec.b[p])
        for t in range(N):
            if spec.kind == "trace":
                m = spec.trace.numel()
                start = min(int(torch.floor(one(u[p, t, 0]) * m)), m - 1)
            for j in range(n):
                x = one(u[p, t, j])
                if spec.kind == "exponential":
                    g = a * (-torch.log(x))
                elif spec.kind == "weibull":
                    g = a * torch.exp(torch.log(-torch.log(x)) / b)
                elif spec.kind == "lognormal":
                    g = torch.exp(a + b * torch.special.ndtri(x))
                else:
                    g = spec.trace[(start + j) % m].reshape(1) * a
                out[p, t, j] = g[0]
    return out


@pytest.mark.parametrize("proc", PROCESSES, ids=PIDS)
def test_spec_per_gap_equals_sample_gaps(proc):
    key = _key()
    n = 13
    spec = proc.gap_spec(MEANS, len(POINTS), CPU)
    want = proc.sample_gaps(key, (len(POINTS), 9, n), mean=MEANS,
                            device=CPU)
    assert torch.equal(FL.draw_gaps(spec, key, n), want)
    got = _per_gap(spec, key, n)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("proc", PROCESSES, ids=PIDS)
def test_spec_of_a_block_is_the_block_of_the_spec(proc):
    """The engine takes one spec for the grid and cuts it per block; the
    two-step path builds each block's process and mean: same bits."""
    whole = proc.gap_spec(MEANS, len(MEANS), CPU)
    idx = np.array([4, 1, 3])
    part = proc.subset(idx).gap_spec(MEANS[idx], len(idx), CPU)
    cut = whole.take(torch.as_tensor(idx))
    assert cut.kind == part.kind
    assert torch.equal(cut.a, part.a) and torch.equal(cut.b, part.b)


def test_spec_values_and_kinds():
    spec = PC.Weibull(shape=0.5).gap_spec(MEANS, len(MEANS), CPU)
    assert spec.kind_id == 1 and spec.a.dtype == F64
    # mean / Gamma(1 + 1/k), with Gamma(3) = 2
    assert torch.equal(spec.a, MEANS / 2.0)
    assert torch.equal(spec.b, torch.full((5,), 0.5, dtype=F64))
    raw = PC.TraceReplay(gaps=TRACE, rescale=False).gap_spec(MEANS, 5, CPU)
    assert torch.equal(raw.a, torch.ones(5, dtype=F64))
    scaled = PC.TraceReplay(gaps=TRACE).gap_spec(MEANS, 5, CPU)
    assert torch.equal(scaled.a, MEANS / float(np.mean(TRACE)))
    assert [FL.GapSpec.KINDS.index(k) for k in FL.GapSpec.KINDS] == \
        [0, 1, 2, 3]
    with pytest.raises(ValueError, match="one value per point"):
        PC.Exponential().gap_spec(MEANS[:3], 5, CPU)


# ---------------------------------------------------------------------------
# The wrapper's CPU route and the engine's fused path
# ---------------------------------------------------------------------------

def _params(B, dtype=F64, T_base=3000.0, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)
    return (t(rng.uniform(30.0, 80.0, B)), t(np.full(B, 10.0)),
            t(np.full(B, 10.0)), t(np.full(B, 1.0)), t(np.full(B, 0.5)),
            t(np.full(B, T_base)))


@pytest.mark.parametrize("proc", PROCESSES, ids=PIDS)
@pytest.mark.parametrize("case", [
    (64, 65, 3000.0), (2, 3, 4000.0), (16, 2, 50000.0)],
    ids=["ordinary", "exhausted", "truncated"])
def test_cpu_route_is_the_plain_version(proc, case):
    F, n_steps, T_base = case
    spec = proc.gap_spec(MEANS, len(POINTS), CPU)
    kw = dict(seed=2**33 + 5, points=POINTS, trial0=65_530, n_trials=37,
              spec=spec, capacity=F, n_steps=n_steps)
    for dtype, comp in ((F64, False), (torch.float32, True)):
        params = _params(len(POINTS), dtype, T_base)
        k0 = ES.event_sweep_sampled.launches
        p0 = ES.event_sweep_sampled_plain.calls
        d0 = FL.draw_gaps.calls
        got = ES.event_sweep_sampled(*params, compensated=comp, **kw)
        assert ES.event_sweep_sampled.launches == k0
        assert ES.event_sweep_sampled_plain.calls == p0 + 1
        assert FL.draw_gaps.calls == d0 + 1
        gaps = proc.sample_gaps(_key(kw["seed"], 65_530, 37),
                                (len(POINTS), 37, F), mean=MEANS,
                                device=CPU, dtype=dtype)
        want = ES.event_sweep_plain(*params, gaps, n_steps=n_steps,
                                    compensated=comp)
        for k in ES.OUTPUT_KEYS:
            assert torch.equal(got[k], want[k]), k
        if F == 2:
            assert bool(got["gaps_exhausted"].any())
        if n_steps == 2:
            assert bool(got["truncated"].any())
    assert torch.equal(ES.event_draws(**{k: kw[k] for k in (
        "seed", "points", "trial0", "n_trials", "capacity")}, spec=spec),
        FL.draw_gaps(spec, _key(kw["seed"], 65_530, 37), F))


def _grid():
    T = torch.tensor([[40.0, 45.0], [60.0, 70.0], [110.0, 130.0]],
                     dtype=F64)
    return TS.mu_rho_grid([120.0, 300.0, 900.0], [2.0, 7.0], device=CPU), T


@pytest.mark.parametrize("proc", PROCESSES[:2] + PROCESSES[3:5],
                         ids=["exponential", "weibull", "lognormal",
                              "trace"])
@pytest.mark.parametrize("policy", [TS.F64, TS.COMPENSATED_F32],
                         ids=["f64", "compensated_f32"])
def test_fused_path_equals_two_step_path(proc, policy):
    """The engine's CUDA branch (``_run_sampled``: one in-kernel-draw call a
    block, blocks cut from the outputs' bytes), run here on CPU tensors,
    equals the CPU two-step path bitwise under any DispatchConfig."""
    grid, T = _grid()
    kw = dict(T_base=2000.0, n_trials=300, seed=5, process=proc,
              precision=policy, device=CPU)
    want = TS.simulate_trajectories(T, grid, **kw)
    flat, T_arr, Tb_arr = TE._flat_inputs(T, grid, 2000.0, CPU)
    for cfg in (None, TS.DispatchConfig(chunk=1),
                TS.DispatchConfig(memory_mb=1)):
        c0 = ES.event_sweep_sampled_plain.calls
        out = TE._run_sampled(flat, T_arr, Tb_arr, 300, 5, proc, None, cfg,
                              policy)
        calls = ES.event_sweep_sampled_plain.calls - c0
        got = TE._assemble_batch(out, grid, 300)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (cfg, f)
        assert calls >= 1 if cfg is None else calls > 1


def test_fused_blocks_count_outputs_only():
    assert TE._lane_bytes(4096, stored=False) == 4 * 8 + 2 * 4 + 2
    assert TE._lane_bytes(4096) == 8 * (4096 + 32)
    idx = np.arange(1000)
    cfg = TS.DispatchConfig(memory_mb=1)
    fused = list(TE._blocks(idx, 4096, TE._lane_bytes(64, False), cfg))
    stored = list(TE._blocks(idx, 4096, TE._lane_bytes(64), cfg))
    assert len(fused) < len(stored)


def test_fused_path_matches_reference_on_its_schedule():
    """The drawn schedule of a block, fed to the JAX package's engine,
    gives the port's fused-path outputs (tolerances as in
    test_torch_engine.py)."""
    grid = RS.mu_rho_grid([120.0, 300.0, 900.0], [2.0, 7.0])
    tg = interop.grid_from_fields(grid.fields(), device=CPU)
    T = np.array([[41.3, 47.9], [63.7, 70.1], [111.1, 131.9]])
    proc = PC.Weibull(shape=0.7)
    flat = tg.ravel()
    cap = 256
    spec = proc.gap_spec(TE._process_mean(proc, flat, CPU), flat.size, CPU)
    pts = torch.arange(flat.size)
    kw = dict(seed=3, points=pts, trial0=0, n_trials=128, spec=spec,
              capacity=cap, n_steps=cap + 1)
    Tt = torch.as_tensor(T.ravel(), dtype=F64)
    got = ES.event_sweep_sampled(
        Tt, flat.C, flat.R, flat.D, flat.omega,
        torch.full_like(Tt, 3000.0), **kw)
    gaps = ES.event_draws(**{k: kw[k] for k in (
        "spec", "seed", "points", "trial0", "n_trials", "capacity")})
    ref = RS.simulate_trajectories(T, grid, T_base=3000.0,
                                   gaps=gaps.numpy(), engine_kind="event")
    for f in ("wall_time", "work_executed", "io_time", "down_time"):
        np.testing.assert_allclose(got[f].numpy().reshape(3, 2, 128),
                                   np.asarray(getattr(ref, f)), rtol=1e-13,
                                   atol=0.0, err_msg=f)
    for f in ("n_failures", "truncated", "gaps_exhausted"):
        np.testing.assert_array_equal(got[f].numpy().reshape(3, 2, 128),
                                      np.asarray(getattr(ref, f)))
    dc = got["n_checkpoints"].numpy().reshape(3, 2, 128).astype(np.int64) \
        - np.asarray(ref.n_checkpoints)
    assert np.abs(dc).max() <= 1 and np.count_nonzero(dc) <= 0.005 * dc.size


def test_sampled_wrapper_validation():
    spec = PC.Exponential().gap_spec(MEANS, 5, CPU)
    params = _params(5)
    kw = dict(seed=0, points=POINTS, trial0=0, n_trials=4, spec=spec,
              capacity=8, n_steps=9)
    with pytest.raises(ValueError, match="capacity"):
        ES.event_sweep_sampled(*params, **{**kw, "capacity": 0})
    with pytest.raises(ValueError, match="int64"):
        ES.event_sweep_sampled(*params, **{**kw, "points": POINTS.int()})
    with pytest.raises(ValueError, match="32-bit"):
        ES.event_sweep_sampled(*params, **{**kw, "trial0": 2**32 - 2})
    with pytest.raises(ValueError, match="shape"):
        ES.event_sweep_sampled(*params, **{**kw, "points": POINTS[:3]})
    with pytest.raises(ValueError, match="spec.a"):
        ES.event_sweep_sampled(*params, **{**kw, "spec": spec.take(
            torch.arange(3))})
    with pytest.raises(TypeError):
        ES.event_sweep_sampled(params[0].float(), *params[1:], **kw)
    with pytest.raises(ValueError, match="n_steps"):
        ES.event_sweep_sampled(*params, **{**kw, "n_steps": -1})


# ---------------------------------------------------------------------------
# Layouts of explicit schedules
# ---------------------------------------------------------------------------

def test_explicit_layouts_give_the_same_bits():
    rng = np.random.default_rng(11)
    B, N, F = 4, 37, 64
    gaps = torch.as_tensor(rng.exponential(300.0, size=(B, N, F)))
    for dtype, comp in ((F64, False), (torch.float32, True)):
        params = _params(B, dtype)
        g = gaps.to(dtype)
        bfn = g.transpose(1, 2).contiguous().transpose(1, 2)
        assert bfn.shape == (B, N, F) and bfn.stride() == (F * N, 1, N)
        assert torch.equal(bfn, g)
        a = ES.event_sweep(*params, g, n_steps=F + 1, compensated=comp)
        b = ES.event_sweep(*params, bfn, n_steps=F + 1, compensated=comp)
        for k in ES.OUTPUT_KEYS:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_sampled_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this check on "
                    "the card)")
    dev = torch.device("cuda")
    pts = POINTS.to(dev)
    for proc in PROCESSES:
        spec = proc.gap_spec(MEANS.to(dev), len(POINTS), dev)
        kw = dict(seed=7, points=pts, trial0=65_530, n_trials=333, spec=spec,
                  capacity=64)
        gaps = ES.event_draws(**kw)
        for dtype, comp in ((F64, False), (torch.float32, True)):
            params = tuple(x.to(dev) for x in _params(len(POINTS), dtype))
            a = ES.event_sweep_sampled(*params, n_steps=65, compensated=comp,
                                       **kw)
            b = ES.event_sweep(*params, gaps.to(dtype), n_steps=65,
                               compensated=comp)
            c = ES.event_sweep_plain(*params, gaps.to(dtype), n_steps=65,
                                     compensated=comp)
            for k in ES.OUTPUT_KEYS:
                assert torch.equal(a[k], b[k]) and torch.equal(b[k], c[k]), k
