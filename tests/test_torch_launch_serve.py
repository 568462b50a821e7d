"""The serving launcher's model path (``repro_torch.launch.serve``) against
the reference's (``repro.launch.serve``): the same flags and defaults
plus ``--device`` (default ``cuda``, raising without a GPU), the same
output lines for all ten archs, and the width rule of ``--reduce`` on
CUDA."""
import dataclasses
import re

import pytest
import torch

from repro.launch import serve as ref_serve

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import decode_attention as PD
from repro_torch.kernels import flash_attention as PF
from repro_torch.kernels import mlstm_scan as PM
from repro_torch.launch import serve
from repro_torch.benchmarks import serve_batched

SMALL = ["--batch", "2", "--prompt-len", "40", "--new-tokens", "5"]
LATER = ("dbrx-132b", "llama4-scout-17b-a16e", "whisper-tiny",
         "internvl2-1b")


def test_parser_has_the_reference_flags_and_defaults():
    ref = vars(ref_serve.build_parser().parse_args([]))
    got = vars(serve.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == ref
    for argv in (["--no-reduce"], ["--kv-cache", "int8", "--waves", "2"]):
        assert (vars(ref_serve.build_parser().parse_args(argv)).items()
                <= vars(serve.build_parser().parse_args(argv)).items())
    assert "n_heads=1" in serve.build_parser().format_help()


@pytest.mark.parametrize("argv", [
    [], ["--kv-cache", "int8", "--waves", "2"],
    ["--arch", "recurrentgemma-9b"], ["--arch", "xlstm-125m"],
    ["--arch", "granite-20b", "--kv-cache", "int8"]])
def test_cli_on_the_cpu_prints_the_reference_lines(argv, capsys):
    """The port's lines are the reference's, line for line (the timings
    and token ids are the run's own)."""
    argv = argv + SMALL
    run = serve.main(argv + ["--device", "cpu"])
    gen = run.tokens
    got = capsys.readouterr().out.splitlines()
    ref_serve.main(argv)
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    assert got[0] == want[0]
    num = r"[0-9.]+"
    for g, w in zip(got[1:3], want[1:3]):
        assert re.sub(num, "#", g) == re.sub(num, "#", w)
    ids = lambda line: [int(t) for t in re.findall(r"-?\d+",
                                                    line.split(":")[1])]
    assert got[3].split(":")[0] == want[3].split(":")[0]
    assert len(ids(got[3])) == len(ids(want[3])) == 5
    assert gen.shape == (2, 5) and gen.dtype == torch.int64
    assert ids(got[3]) == gen[0].tolist()
    assert run.logits.shape == (2, 1, run.cfg.padded_vocab())
    assert int(run.cache["pos"]) == 40 + 4
    assert run.prefill_s > 0 and run.decode_s > 0


def test_cli_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(SMALL)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_batched.main(SMALL)


def test_serve_batched_runs_the_launcher(capsys):
    run = serve_batched.main(SMALL + ["--kv-cache", "int8", "--waves", "2",
                                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "kv_cache=int8 waves=2" in out and run.tokens.shape == (2, 5)


@pytest.mark.parametrize("arch", serve.SERVED)
def test_reduce_width_rule(arch):
    """``--reduce``: the reference's ``reduced(cfg)`` on the CPU; on CUDA
    heads of 128 (one head of d 128), which the flash, decode and mLSTM
    kernels take; ``--no-reduce`` the full config on either."""
    args = serve.build_parser().parse_args(["--arch", arch, "--waves", "2"])
    cpu = serve.serving_config(args, torch.device("cpu"))
    assert cpu == dataclasses.replace(reduced(get_config(arch)),
                                      prefill_waves=2)
    card = serve.serving_config(args, torch.device("cuda"))
    assert (card.d_model, card.n_heads, card.n_layers) == (
        128, 1, cpu.n_layers)
    if arch == "xlstm-125m":
        assert 2 * card.d_model // card.n_heads in PM.HEAD_DIMS
    else:
        assert card.resolved_head_dim in PF.HEAD_DIMS
        assert card.resolved_head_dim in PD.HEAD_DIMS
    assert cpu.resolved_head_dim == 16
    full = serve.build_parser().parse_args(["--arch", arch, "--no-reduce"])
    for dev in ("cpu", "cuda"):
        assert serve.serving_config(full, torch.device(dev)) == \
            get_config(arch)


@pytest.mark.parametrize("arch", LATER)
def test_later_archs_exit_naming_the_next_slice(arch, capsys):
    """The archs that exited before the port's MoE and encoder-decoder
    slice are served now: the CLI on the CPU prints the reference's lines
    (timings and ids the run's own), with stub frames for whisper and a
    stub prefix for internvl, whose cache holds prefix, prompt and new
    tokens."""
    run = serve.main(["--arch", arch, "--device", "cpu"] + SMALL)
    got = capsys.readouterr().out.splitlines()
    ref_serve.main(["--arch", arch] + SMALL)
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4 and got[0] == want[0]
    num = r"[0-9.]+"
    for g, w in zip(got[1:], want[1:]):
        assert re.sub(num, "#", g) == re.sub(num, "#", w)
    assert run.tokens.shape == (2, 5)
    assert bool(torch.isfinite(run.logits.float()).all())
    assert int(run.cache["pos"]) == 40 + (run.cfg.n_prefix_tokens or 0) + 4


def test_chip_smoke_serve_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.phase_serve`` end to end on the CPU at reduced widths:
    its gates hold, every run's plain-version calls stand for the launches
    the card makes (none launch here), and card against CPU compares the
    CPU with itself."""
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    rep = chip_smoke.phase_serve(torch.device("cpu"), "cpu", rehearse=True)
    for name in ("starcoder2-3b", "starcoder2-3b-int8", "recurrentgemma-9b",
                 "xlstm-125m"):
        assert not any(rep[name]["launches"].values())
    assert rep["launches"] == dict.fromkeys(
        ("flash_attention", "decode_attention", "rglru_scan", "mlstm_scan"),
        0)
    for r in rep["vs_cpu"].values():
        if isinstance(r, dict):
            assert r["finite"] and r["rows"] == 4 * 3
            assert max(r["f32_rows"]) == 0 and max(r["bf16_rows"]) == 0
    out = capsys.readouterr().out
    assert out.count("[cpu]") >= 7 and "FAIL" not in out


def test_chip_smoke_serve15_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.phase_serve15`` (the MoE archs in both routings,
    whisper and internvl) end to end on the CPU at reduced widths: its
    gates hold, every run's plain-version calls stand for the launches the
    card makes, and card against CPU compares the CPU with itself (no
    routing flip)."""
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    rep = chip_smoke.phase_serve15(torch.device("cpu"), "cpu",
                                   rehearse=True)
    for name in chip_smoke.SERVE15_PARTS:
        assert not any(rep[name]["launches"].values())
    assert rep["launches"] == {"flash_attention": 0, "decode_attention": 0}
    for r in rep["vs_cpu"].values():
        if isinstance(r, dict):
            assert r["finite"] and r["rows"] == 2 * 5
            assert max(r["f32_rows"]) == 0 and max(r["bf16_rows"]) == 0
            assert r["flips"] == {"f32": 0, "bf16": 0}
    out = capsys.readouterr().out
    assert out.count("[cpu]") >= 13 and "FAIL" not in out
