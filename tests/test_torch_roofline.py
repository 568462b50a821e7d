"""The port's roofline (``repro_torch.benchmarks.roofline``) on the CPU.

* The peaks come from ``kernels/cost.py``'s table; ``resolve_peaks``
  picks the longest device-name match; the launch plans' link is the
  slowest an axis crosses, and ``axis_links`` says which.
* Section 1 against the reference's formulas on a dry-run record
  (``model_flops_global``, ``analyze``'s terms and fractions).
* Section 2 on the CPU at a cut shape: the four programs costed by
  ``launch/cost.py``, the kernel rows bounded by their ``kernels/cost.py``
  model on the lanes the run ran; every file names the card and the
  peaks.
* The command line defaults to ``cuda`` and raises without a GPU.
"""
import json

import pytest
import torch

import benchmarks.roofline as ref_roofline
from repro_torch.benchmarks import _util, roofline
from repro_torch.kernels import cost


def test_peaks_read_the_cost_table():
    sxm = cost.PEAKS["SXM"]
    p = roofline.resolve_peaks("NVIDIA H100 80GB HBM3", "cuda")
    assert (p.flops, p.hbm_bw, p.nvlink_bw, p.net_bw) == (
        sxm.bf16, sxm.hbm_bw, sxm.nvlink_bw, sxm.net_bw)
    assert p.link_bw == min(sxm.nvlink_bw, sxm.net_bw)
    assert roofline.resolve_peaks("NVIDIA H100 PCIe").hbm_bw == \
        cost.PEAKS["PCIe"].hbm_bw
    assert roofline.resolve_peaks("", "cpu") == roofline.PEAKS["cpu"]
    assert roofline.resolve_peaks("", "cuda").flops == sxm.bf16
    over = roofline.resolve_peaks("h100", link_bw=1e9)
    assert over.link_bw == 1e9 and "override" in over.source


def test_axis_links():
    assert roofline.axis_links(("data", "model"), (16, 16)) == {
        "data": "network", "model": "network"}
    assert roofline.axis_links(("data", "model"), (32, 8)) == {
        "data": "network", "model": "nvlink"}
    assert roofline.axis_links(("pod", "data", "model"), (2, 2, 4)) == {
        "pod": "network", "data": "nvlink", "model": "nvlink"}


RECORD = {"arch": "starcoder2-3b", "shape": "train_4k", "mesh": "pod16x16",
          "n_chips": 256, "kind": "train", "seq_len": 4096,
          "global_batch": 256, "active_param_count": 3_000_000_000,
          "fits_hbm": True,
          "memory": {"peak_bytes_est": 2**34, "argument_bytes": 2**30},
          "walked": {"flops_per_device": 2e15, "hbm_bytes_per_device": 4e12,
                     "coll_bytes_total": 1e10}}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_section_1_uses_the_reference_formulas(kind):
    rec = dict(RECORD, kind=kind)
    assert roofline.model_flops_global(rec) == \
        ref_roofline.model_flops_global(rec)
    p = roofline.resolve_peaks(roofline.PLAN_BACKEND)
    ref_p = ref_roofline.Peaks(p.flops, p.hbm_bw, p.link_bw, p.source)
    got, want = roofline.analyze(rec, p), ref_roofline.analyze(rec, ref_p)
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "model_flops_per_dev", "useful_flop_ratio",
              "roofline_fraction", "fits_hbm", "peak_gib"):
        assert got[k] == want[k], k
    assert got["links"] == "data=network;model=network"


def test_sections_write_their_files(tmp_path, monkeypatch):
    """Section 1 over a written record and section 2 at a cut shape (16
    points x 16 trials, capacity 8) on the CPU."""
    monkeypatch.setattr(_util, "RESULTS", tmp_path)
    monkeypatch.setattr(roofline, "_SW_POINTS", 16)
    monkeypatch.setattr(roofline, "_SW_TRIALS", 16)
    monkeypatch.setattr(roofline, "_SW_CAP", 8)
    (tmp_path / "dryrun").mkdir()
    (tmp_path / "dryrun" / "x.json").write_text(json.dumps(RECORD))
    rows, srows = roofline.main(["--device", "cpu"])
    assert len(rows) == 1
    assert [r["program"] for r in srows] == [
        "model_sweep_core", "step_scan", "event_kernel_explicit",
        "event_kernel_sampled"]
    by = {r["program"]: r for r in srows}
    for name in ("event_kernel_explicit", "event_kernel_sampled"):
        r = by[name]
        assert r["kernel_calls"] == 1 and r["bound_by"] == "bytes"
        assert r["ms"] is None and r["bound_ms"] > 0
    assert by["model_sweep_core"]["kernel_calls"] == 0
    assert by["step_scan"]["hbm_bytes"] > by["event_kernel_explicit"][
        "hbm_bytes"]
    for f in ("roofline.csv", "roofline.md", "roofline_sweep.csv",
              "roofline_sweep.md"):
        text = (tmp_path / f).read_text()
        assert "cpu (no card)" in text and "4.95e+14" not in text
        assert "3.35e+12" in text or "2e+10" in text


def test_main_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        roofline.main([])
