"""The port's bench_sweep (``repro_torch.benchmarks.bench_sweep``) on the
CPU: ``--quick``'s payload keys (the reference's keys where the port has
the path), its files, and ``--check`` flagging a payload three times
slower than its baseline.
"""
import copy
import json

import pytest
import torch

from repro_torch.benchmarks import _util, bench_sweep

#: the reference's gated and reference keys (``benchmarks/bench_sweep.py``
#: ``run``) but the two that ``--quick`` leaves out, ``QUICK_SKIPS``.
REF_KEYS = ("fig2_seed_grid", "dense_grid", "weibull_step_engine_reference",
            "weibull_event_engine", "pallas_event_engine", "mc_solver_warm",
            "sharded_dense_grid", "chunked_dense_1m",
            "async_overlap_collapse", "advisor_rps")
QUICK_SKIPS = ("cold_start_cached", "advisor_load_regimes")


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench")
    saved = _util.RESULTS
    _util.RESULTS = out
    try:
        payload = bench_sweep.main(["--quick", "--device", "cpu"])
    finally:
        _util.RESULTS = saved
    return out, payload


def test_quick_payload_keys(quick):
    out, payload = quick
    for k in REF_KEYS:
        assert "speedup_warm" in payload[k] and "batched_warm_s" in \
            payload[k], k
    assert not set(QUICK_SKIPS) & set(payload)
    assert payload["quick"] and payload["device"] == "cpu"
    assert payload["card"] == "cpu (no card)"
    assert payload["weibull_step_engine_reference"]["ungated"]
    assert payload["pallas_event_engine"]["kernel"] is False
    assert payload["sharded_dense_grid"]["bit_equal"]
    assert payload["sharded_dense_grid"]["n_devices"] == 1
    saved = json.loads((out / "bench_sweep.json").read_text())
    assert set(saved) == set(payload)
    table = (out / "bench_sweep_table.md").read_text()
    assert "cpu (no card)" in table and "fig2_seed_grid" in table


def test_check_flags_a_three_times_slower_payload(quick):
    _, payload = quick
    assert bench_sweep.check_regression(payload, payload) == []
    slow = copy.deepcopy(payload)
    for v in slow.values():
        if isinstance(v, dict) and "speedup_warm" in v:
            v["speedup_warm"] /= 3.0
    flagged = bench_sweep.check_regression(payload, slow)
    gated = [k for k, v in payload.items() if isinstance(v, dict)
             and "speedup_warm" in v and not v.get("ungated")]
    assert sorted(f.split(":")[0] for f in flagged) == sorted(gated)
    # a gated entry missing from either side fails too
    missing = copy.deepcopy(payload)
    del missing["dense_grid"]
    assert any("dense_grid" in f for f in
               bench_sweep.check_regression(payload, missing))
    assert any("dense_grid" in f for f in
               bench_sweep.check_regression(missing, payload))


def test_check_on_the_command_line(quick, tmp_path, monkeypatch):
    """``--check BASELINE`` exits non-zero when this run is 3x slower than
    the file it names (the run itself stubbed by the quick payload)."""
    _, payload = quick
    base = copy.deepcopy(payload)
    for v in base.values():
        if isinstance(v, dict) and "speedup_warm" in v:
            v["speedup_warm"] *= 3.0
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(base))
    monkeypatch.setattr(_util, "RESULTS", tmp_path)
    monkeypatch.setattr(bench_sweep, "run",
                        lambda device, quick: copy.deepcopy(payload))
    with pytest.raises(SystemExit, match="regression check FAILED"):
        bench_sweep.main(["--quick", "--device", "cpu", "--check",
                          str(path)])


def test_main_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_sweep.main(["--quick"])
