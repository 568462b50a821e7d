"""The per-kernel work models (``repro_torch/kernels/cost.py``), the
kernel wrappers' shape-only paths and ``repro_torch/launch/cost.py``, on
the CPU.

* Each kernel's model against a count by hand at a tiny shape, and at
  the zoo's full-width shapes the bounds that PERF.md §6 lists for the
  H100 SXM (``chip_smoke.py``'s phase 8 and 7 numbers, to their printed
  digits).
* Each wrapper on ``meta`` tensors and on fake tensors
  (``FakeTensorMode``, fake ``cuda`` ones too): outputs of the right
  shapes and dtypes, no plain-version call, one unit of the model's work
  reported; on CPU tensors the plain version, counted as one unit with no
  aten op beside it.
* ``launch.cost.analyze``'s FLOPs for a reduced config's train, prefill
  and decode step against the reference's ``hlo_cost.analyze_compiled``
  on the same step and input shapes.  Attention is counted apart (the
  reference's online and banded attention compute their blocks densely,
  the kernel skips the masked tiles): the rest agrees exactly, and the
  decode step, whose attention both count over the whole cache, agrees
  in all.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import hlo_cost
from repro.models import attention as ref_attn
from repro.models import build as ref_build
from repro.models import input_specs as ref_input_specs
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_state as ref_init_state

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import cost, ops
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import event_sweep as es
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm_scan as ml
from repro_torch.kernels import quant_blockwise as qb
from repro_torch.kernels import rglru_scan as rg
from repro_torch.launch import H100
from repro_torch.launch import cost as lcost
from repro_torch.models import abstract_tree, build, input_specs
from repro_torch.models.attention import attention as port_attention
from repro_torch.optim import adamw

SXM = cost.PEAKS["SXM"]
BF16, F32 = torch.bfloat16, torch.float32


def _ms(work):
    return round(cost.bound_ms(work, SXM)["bound_ms"], 4)


class Recorder:
    def __init__(self):
        self.calls = []

    def kernel(self, name, work, sig):
        self.calls.append((name, work, sig))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def test_peaks_are_written_once():
    assert cost.variant("NVIDIA H100 80GB HBM3") == "SXM"
    assert cost.variant("NVIDIA H100 PCIe") == "PCIe"
    assert cost.variant("NVIDIA H100 NVL") == "NVL"
    assert H100["peak_bf16_flops"] == SXM.bf16 == 989e12
    assert H100["hbm_bandwidth"] == SXM.hbm_bw == 3.35e12
    assert H100["nvlink_bandwidth"] == SXM.nvlink_bw
    assert H100["hbm_bytes"] == SXM.hbm_bytes == 85_017_493_504
    for p in cost.PEAKS.values():
        assert p.int32 == p.f32 / 4 and p.tf32 == p.bf16 / 2


@pytest.mark.parametrize("mode,window,chunk", [
    ("causal", 0, 0), ("sliding", 3, 0), ("chunked", 0, 4),
    ("bidir", 0, 0)])
@pytest.mark.parametrize("Sq,Skv", [(7, 7), (10, 10), (5, 9)])
def test_attention_pairs_count_the_mask(mode, window, chunk, Sq, Skv):
    """The pairs the mask allows, against ``flash_attention.allowed``;
    the visited tiles hold them all."""
    want = int(fa.allowed(mode, Sq, Skv, window, chunk, "cpu").sum())
    assert cost.attention_pairs(mode, Sq, Skv, window, chunk) == want
    for rows in (2, 4):
        assert cost.visited_pairs(mode, Sq, Skv, window, chunk, rows) \
            >= want


def test_flash_and_decode_by_hand():
    w = cost.flash_work(2, 3, 3, 4, F32, "causal")
    # 6 causal pairs a head; q, k, v, out 2 x 3 x 4 f32 each
    assert w.ops == {"f32": 4 * 4 * 2 * 6}
    assert w.bytes == 4 * 4 * 2 * 3 * 4
    # one 64-row block visits one 64-key tile: 3 rows x 64 keys a head
    assert w.flops == 4 * 4 * 2 * 3 * 64
    w = cost.flash_work(1, 2, 5, 8, BF16, "bidir")
    assert w.ops == {"bf16": 4 * 8 * 10} and w.bytes == 2 * (16 + 40) * 2
    d = cost.decode_work(3, 7, 8, BF16)
    assert d.ops == {"f32": 4 * 3 * 7 * 8} and d.flops == 4 * 3 * 7 * 8
    assert d.bytes == 2 * (2 * 3 * 7 * 8 + 2 * 3 * 8)
    assert cost.decode_work(3, 0, 8, BF16).ops == {"f32": 0}


def test_scans_and_quant_by_hand():
    r = cost.rglru_work(2, 5, 3, F32)
    assert r.bytes == 3 * 4 * 30 + 4 * 6 and r.ops == {"f32": 60}
    assert cost.rglru_work(2, 5, 3, BF16).bytes == 3 * 2 * 30 + 4 * 6
    # chunks of 2 over S 4: q k^T and S v over 3 causal pairs a chunk
    # (4 Dh each), q C0 in the second chunk (4 L Dh^2)
    BH, S, Dh, L = 1, 4, 2, 2
    want = 4 * Dh * 2 * 3 + 4 * 1 * L * Dh * Dh
    assert cost.mlstm_flops(BH, S, Dh, L) == want
    m = cost.mlstm_work(BH, S, Dh, L)
    assert m.ops == {"tf32": 3 * want} and m.flops == want
    assert m.bytes == 4 * 4 * S * Dh + 2 * 4 * S
    assert cost.mlstm_work(BH, S, Dh, L, route="fp32").ops == {"f32": want}
    q = cost.quant_work("quantize", 1000, 8)
    assert q.bytes == 4000 + 132 * 8 and q.ops == {"f32": 7000}
    assert cost.quant_work("dequantize", 1000, 8).ops == {"f32": 2000}


def test_event_kernels_by_hand():
    w = cost.event_sweep_work(3, 12, 30)
    assert w.bytes == 30 * 8 + 12 * 42 + 6 * 3 * 8 and w.ops == {"f64": 1200}
    w = cost.event_sweep_work(3, 12, 10, 30)   # a stride-0 schedule
    assert w.bytes == 10 * 8 + 12 * 42 + 144 and w.ops == {"f64": 1200}
    c = cost.event_sweep_work(3, 12, 30, compensated=True)
    assert c.bytes == 30 * 4 + 12 * 42 + 6 * 3 * 4 and c.ops == {"f32": 2160}
    s = cost.event_sweep_sampled_work(3, 12, 30, draw_ops=(50, 7))
    assert s.bytes == 12 * 42 + 3 * (48 + 24)
    assert s.ops == {"f64": 1200, "int32": 1500, "f64_instr": 210}
    b = cost.bound_ms(s, SXM)
    assert b["parts_ms"]["fp64"] == pytest.approx(
        (1200 / SXM.f64 + 210 / (SXM.f64 / 2)) * 1e3)
    assert b["parts_ms"]["int32"] == pytest.approx(1500 / SXM.int32 * 1e3)
    assert cost.event_draws_work(3, 12, 5).bytes == 60 * 8 + 3 * 24


def test_zoo_bounds_are_perf_md_s():
    """Phase 8's bounds (PERF.md §6, H100 SXM): flash 0.2085 (local
    attention) and Dh 64 0.0559, 0.1217; decode 1.9093 (lengths 2048 and
    1000) and Dh 64 0.0356; RG-LRU 0.2404 (two h0); mLSTM 0.5967, 1.4679
    at the FP32 cores; the quant kernels 0.7799 over the checkpoint's
    leaves."""
    assert _ms(cost.flash_work(32, 4096, 4096, 256, BF16, "sliding",
                               2048)) == 0.2085
    assert _ms(cost.flash_work(96, 1500, 1500, 64, BF16, "bidir")) == 0.0559
    assert _ms(cost.flash_work(224, 2048, 2048, 64, BF16, "causal")) \
        == 0.1217
    dec = sum(cost.bound_ms(cost.decode_work(2048, n, 256, BF16),
                            SXM)["bound_ms"] for n in (2048, 1000))
    assert round(dec, 4) == 1.9093
    assert _ms(cost.decode_work(224, 2080, 64, BF16)) == 0.0356
    assert round(2 * cost.bound_ms(cost.rglru_work(2, 4096, 4096, F32),
                                   SXM)["bound_ms"], 4) == 0.2404
    assert _ms(cost.mlstm_work(32, 4096, 384, 256)) == 0.5967
    assert _ms(cost.mlstm_work(32, 4096, 384, 256, route="fp32")) == 1.4679
    import chip_smoke
    sizes = [int(np.prod(s)) for _, s in chip_smoke.XLSTM_125M_LEAVES]
    sizes = [n for n in sizes if n >= 4096] * 3      # params, m and v
    n = sum(sizes)
    g = sum((k + qb.pad_of(k)[0]) // 128 for k in sizes)
    assert len(sizes) == 57
    assert _ms(cost.quant_work("quantize", n, g)) == 0.7799
    assert _ms(cost.quant_work("dequantize", n, g)) == 0.7799


# ---------------------------------------------------------------------------
# the wrappers' shape-only paths
# ---------------------------------------------------------------------------

def _calls(dev):
    """(name, call, expected [(shape, dtype)]) of every wrapper."""
    f = lambda *s, dt=F32: torch.zeros(s, dtype=dt, device=dev)
    p = lambda: f(3, dt=torch.float64)
    from repro_torch.core.failures import GapSpec
    pts = torch.arange(3, device=dev)
    spec = GapSpec("exponential", p(), p())
    x = f(4, 512)
    qq, ss = f(4, 512, dt=torch.int8), f(4, 4)
    out = [
        ("flash_attention", lambda: fa.flash_attention(
            f(2, 70, 64, dt=BF16), f(2, 90, 64, dt=BF16),
            f(2, 90, 64, dt=BF16), mode="bidir"), [((2, 70, 64), BF16)]),
        ("decode_attention", lambda: da.decode_attention(
            f(2, 1, 64), f(2, 30, 64), f(2, 30, 64), 17),
         [((2, 1, 64), F32)]),
        ("rglru_scan", lambda: rg.rglru_scan(f(2, 9, 16), f(2, 9, 16),
                                             f(2, 16)),
         [((2, 9, 16), F32)]),
        ("mlstm_scan", lambda: ml.mlstm_scan(
            f(2, 64, 128), f(2, 64, 128), f(2, 64, 128), f(2, 64),
            f(2, 64), chunk=32), [((2, 64, 128), F32)]),
        ("quantize", lambda: qb.quantize(x),
         [((4, 512), torch.int8), ((4, 4), F32)]),
        ("dequantize", lambda: [qb.dequantize(qq, ss)], [((4, 512), F32)]),
        ("quantize_leaves", lambda: qb.quantize_leaves([x, f(300)])[:2],
         [((2048 + 384,), torch.int8), ((19,), F32)]),
        ("dequantize_leaves", lambda: qb.dequantize_leaves(
            [qq, f(3, 128, dt=torch.int8)], [ss, f(3, 1)],
            [(2048,), (300,)], [0, 84]), [((2048,), F32), ((300,), F32)]),
        ("event_sweep", lambda: [es.event_sweep(
            *[p() for _ in range(6)], f(3, 5, 8, dt=torch.float64),
            n_steps=4)["wall_time"]], [((3, 5), torch.float64)]),
        ("event_sweep_sampled", lambda: [es.event_sweep_sampled(
            *[p() for _ in range(6)], seed=0, points=pts, trial0=0,
            n_trials=5, spec=spec, capacity=8, n_steps=4)["n_failures"]],
         [((3, 5), torch.int32)]),
        ("event_draws", lambda: [es.event_draws(
            spec, seed=0, points=pts, trial0=0, n_trials=5, capacity=8)],
         [((3, 5, 8), torch.float64)]),
    ]
    return out


def _outs(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


@pytest.mark.parametrize("name", [c[0] for c in _calls("cpu")])
def test_wrappers_shape_only_on_meta(name):
    call, want = {n: (c, w) for n, c, w in _calls("meta")}[name]
    rec = Recorder()
    plain = {"flash_attention": fa.flash_attention_plain,
             "decode_attention": da.decode_attention_plain,
             "rglru_scan": rg.rglru_scan_plain,
             "mlstm_scan": ml.mlstm_scan_plain}.get(name)
    before = plain.calls if plain else 0
    with cost.counting(rec):
        got = _outs(call())
    assert [(tuple(t.shape), t.dtype) for t in got] == want
    assert all(t.device.type == "meta" for t in got)
    assert len(rec.calls) == 1 and rec.calls[0][0] == name
    assert isinstance(rec.calls[0][1], cost.Work)
    if plain:
        assert plain.calls == before


def test_wrappers_shape_only_on_fake_tensors():
    """Under ``FakeTensorMode`` (CPU and fake CUDA tensors) the wrappers
    return fake outputs and report their work; nothing is computed."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    for device in ("cpu", "cuda"):
        rec = Recorder()
        with FakeTensorMode(allow_non_fake_inputs=False), \
                cost.counting(rec):
            q = torch.empty(2, 70, 128, dtype=BF16, device=device)
            o = fa.flash_attention(q, q, q, mode="causal")
            a = torch.empty(2, 9, 16, device=device)
            h = rg.rglru_scan(a, a, torch.empty(2, 16, device=device))
            q1 = torch.empty(2, 1, 128, dtype=BF16, device=device)
            d = da.decode_attention(q1, q, q, 33)
        assert isinstance(o, FakeTensor) and o.shape == q.shape
        assert isinstance(h, FakeTensor) and h.shape == (2, 9, 16)
        assert d.shape == (2, 1, 128)
        assert [c[0] for c in rec.calls] == ["flash_attention", "rglru_scan",
                                             "decode_attention"]
        assert rec.calls[2][1].ops == {"f32": 4 * 2 * 33 * 128}


def test_cpu_wrappers_run_plain_as_one_unit():
    """On CPU tensors a wrapper runs its plain version, and a counter of
    aten ops sees the call as one unit: the plain version's ops are not
    counted beside it."""
    rec = Recorder()
    q = torch.randn(2, 70, 64)
    calls = fa.flash_attention_plain.calls
    mode = lcost.CostMode()
    with cost.counting(mode), mode:
        out = fa.flash_attention(q, q, q, mode="causal")
    assert fa.flash_attention_plain.calls == calls + 1
    assert torch.equal(out, fa.flash_attention_plain(q, q, q, mode="causal"))
    w = cost.flash_work(2, 70, 70, 64, F32, "causal")
    assert mode.cost.flops == w.flops and mode.cost.hbm_bytes == w.bytes
    assert dict(mode.cost.kernels) == {"flash_attention": 1}
    with cost.counting(rec):
        ops.rglru_scan(torch.rand(1, 4, 8), torch.rand(1, 4, 8),
                       torch.zeros(1, 8))
    assert [c[0] for c in rec.calls] == ["rglru_scan"]


def test_cuda_tensors_still_go_to_the_kernel():
    """A CUDA tensor that is not fake never takes the shape-only path: the
    launch path refuses an unbuilt width before any build, as before."""
    assert not cost.shape_only(torch.zeros(1))
    x = torch.zeros((2, 8, 32))
    with pytest.raises(ValueError, match="Dh"):
        fa._kernel(x, x, x, "causal", 0, 0)


# ---------------------------------------------------------------------------
# launch/cost.py against the reference's HLO walk
# ---------------------------------------------------------------------------

def test_costvec_adds_and_scales():
    a = lcost.CostVec(2.0, 10.0)
    a.coll_bytes["all-reduce"] += 8
    b = a.scaled(3)
    assert (b.flops, b.hbm_bytes, b.coll_bytes["all-reduce"]) == (6, 30, 24)
    a += b
    assert (a.flops, a.hbm_bytes, a.coll_bytes["all-reduce"]) == (8, 40, 32)


B, S = 2, 64
ARCH = "codeqwen1.5-7b"


@pytest.fixture(scope="module")
def rigs():
    rcfg = ref_reduced(ref_get_config(ARCH), n_layers=2, d_model=128)
    tcfg = reduced(get_config(ARCH), n_layers=2, d_model=128)
    return rcfg, ref_build(rcfg), tcfg, build(tcfg)


def _ref_attention_flops(rcfg, grad: bool) -> float:
    H, Dh = rcfg.n_heads, rcfg.resolved_head_dim
    spec = jax.ShapeDtypeStruct((B, S, H, Dh), jnp.float32)

    def fwd(q, k, v):
        return ref_attn.attention(q, k, v, mode="causal")

    if grad:
        return hlo_cost.analyze_compiled(
            jax.grad(lambda q, k, v: jnp.sum(fwd(q, k, v)), (0, 1, 2)),
            spec, spec, spec).flops
    return hlo_cost.analyze_compiled(fwd, spec, spec, spec).flops


def _port_attention_flops(tcfg, grad: bool) -> float:
    H, Dh = tcfg.n_heads, tcfg.resolved_head_dim
    qkv = [torch.empty((B, S, H, Dh), device="meta", requires_grad=grad)
           for _ in range(3)]

    def run():
        out = port_attention(*qkv, mode="causal")
        if grad:
            torch.autograd.grad(out.sum(), qkv)
    return lcost.analyze(run).flops


def test_train_step_flops_match_the_reference(rigs):
    rcfg, rm, tcfg, tm = rigs
    params = jax.eval_shape(rm.init, jax.random.key(0))
    opt = jax.eval_shape(lambda p: ref_init_state(p, RefAdamWConfig()),
                         params)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    ref = hlo_cost.analyze_compiled(rm.make_train_step(RefAdamWConfig()),
                                    params, opt, batch).flops
    pspec = tm.param_spec()
    got = lcost.analyze(
        tm.make_train_step(adamw.AdamWConfig()), abstract_tree(pspec),
        abstract_tree(adamw.state_spec(pspec, adamw.AdamWConfig())),
        {k: torch.empty((B, S), dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}).flops
    L = rcfg.n_layers
    rest_ref = ref - L * _ref_attention_flops(rcfg, True)
    rest_got = got - L * _port_attention_flops(tcfg, True)
    assert rest_got == pytest.approx(rest_ref, rel=1e-9)
    assert rest_got > 0.5 * got


def test_prefill_and_decode_flops_match_the_reference(rigs):
    rcfg, rm, tcfg, tm = rigs
    params = jax.eval_shape(rm.init, jax.random.key(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    ref = hlo_cost.analyze_compiled(
        lambda p, b: rm.prefill(p, b, max_cache_seq=S), params, batch).flops
    tparams = abstract_tree(tm.param_spec())
    got = lcost.analyze(lambda: tm.prefill(
        tparams, {"tokens": torch.empty((B, S), dtype=torch.int32,
                                        device="meta")},
        max_cache_seq=S)).flops
    L = rcfg.n_layers
    assert got - L * _port_attention_flops(tcfg, False) == pytest.approx(
        ref - L * _ref_attention_flops(rcfg, False), rel=1e-9)

    # decode at the last slot of a full cache: both count the whole cache
    shape = RefShape("decode_small", "decode", S, B)
    inp = ref_input_specs(rcfg, shape)
    ref = hlo_cost.analyze_compiled(rm.decode_step, params, inp["cache"],
                                    inp["token"]).flops
    from repro_torch.launch.dryrun import _host_positions
    tin = input_specs(tcfg, ShapeConfig("decode_small", "decode", S, B))
    cache = _host_positions(tin["cache"], S)
    rec = Recorder()
    with cost.counting(rec):
        got = lcost.analyze(tm.decode_step, tparams, cache,
                            tin["token"]).flops
    H, Dh = tcfg.n_heads, tcfg.resolved_head_dim
    assert [c[1].flops for c in rec.calls] == [4 * B * H * S * Dh] * L
    assert got == pytest.approx(ref, rel=1e-9)
