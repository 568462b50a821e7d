"""The port's training launcher (``repro_torch.launch.train``), its
``--smoke`` run, ``validate_runtime`` and the fault-tolerant example,
against the JAX package's on the CPU.

The parser has the reference's flags, defaults and choices plus
``--device``; ``spec_from_args`` gives the reference's specs; the smoke's
report (reduced xLSTM, in place of the reference's reduced starcoder2-3b)
equals the reference's run of the same spec in wall time, energy, the
operating point and every count; ``validate_runtime`` on one scenario at
two seeds gives the reference's row.
"""
import argparse
import dataclasses
import json
import math

import pytest
import torch

from benchmarks import validate_runtime as RV
from repro.ft import run as RR
from repro.launch import train as RT

from repro_torch.benchmarks import train_fault_tolerant as TFT
from repro_torch.benchmarks import validate_runtime as TV
from repro_torch.launch import train as TT

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _actions(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.nargs, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_has_the_references_flags_plus_device():
    ref, got = _actions(RT.build_parser()), _actions(TT.build_parser())
    device = got.pop("device")
    n_heads = got.pop("n_heads")
    assert got == ref
    assert device[:3] == (("--device",), "cuda", None)
    assert n_heads[:4] == (("--n-heads",), 4, None, int)


@pytest.mark.parametrize("argv", [
    [],
    ["--strategy", "algo_t_ml", "--mtbf", "20", "--q", "0.15",
     "--ckpt-cost", "1.5", "--c1", "0.3", "--process", "weibull",
     "--process-param", "0.7", "--profile", "paper_ml", "--steps", "120",
     "--no-buddy"],
    ["--mtbf", "50", "--no-inject-failures", "--process", "lognormal",
     "--process-param", "1.5", "--compress"],
    ["--sim-step-seconds", "0", "--no-reduce", "--batch", "8", "--seq",
     "256", "--r1", "0.2", "--omega", "0.5", "--pfs-every", "3",
     "--ckpt-dir", "somewhere", "--seed", "7", "--lr", "1e-3"],
], ids=["defaults", "multilevel", "no-inject", "measured"])
def test_spec_from_args_equals_the_reference(argv):
    ref = RT.spec_from_args(RT.build_parser().parse_args(argv))
    got = TT.spec_from_args(TT.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.scaled_time, got.inject) == (ref.scaled_time, ref.inject)


def test_boolean_flags_and_choices():
    p = TT.build_parser()
    for flag, default in [("reduce", True), ("buddy", True),
                          ("inject-failures", True), ("compress", False),
                          ("quiet", False)]:
        dest = flag.replace("-", "_")
        assert getattr(p.parse_args([]), dest) is default
        assert getattr(p.parse_args([f"--{flag}"]), dest) is True
        assert getattr(p.parse_args([f"--no-{flag}"]), dest) is False
    with pytest.raises(SystemExit):
        p.parse_args(["--strategy", "not_a_strategy"])
    assert p.parse_args(["--device", "cpu"]).device == "cpu"


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The port's ``--smoke`` on the CPU and the reference's run of the
    same spec."""
    root = tmp_path_factory.mktemp("smoke")
    rep = TT.main(["--smoke", "--device", CPU, "--ckpt-dir",
                   str(root / "port")])
    ref = RR.execute(RR.RunSpec(ckpt_dir=str(root / "ref"),
                                **TT.SMOKE_SPEC))
    return rep, ref


def test_smoke_passes_on_the_cpu(smoke, capsys):
    rep, _ = smoke
    assert rep["final_step"] == 120
    assert rep["n_failures"] >= 1 and rep["n_rollbacks"] == rep["n_failures"]
    for key in ("wall_ratio", "energy_ratio"):
        assert 0.7 < rep["predicted"][key] < 1.3
    assert all(math.isfinite(x) for x in rep["losses"])


def test_smoke_report_equals_the_reference(smoke):
    rep, ref = smoke
    for key in ("final_step", "n_failures", "n_hard_failures",
                "n_rollbacks", "flush_aborts", "operating_point"):
        assert rep[key] == ref[key], key
    assert rep["wall_s"] == ref["wall_s"]
    assert rep["energy"] == ref["energy"]
    assert rep["predicted"] == pytest.approx(ref["predicted"], rel=1e-12)
    assert len(rep["checkpoints"]) == len(ref["checkpoints"])


def test_main_prints_the_report(tmp_path, capsys):
    rep = TT.main(["--device", CPU, "--layers", "2", "--d-model", "64",
                   "--batch", "2", "--seq", "16", "--steps", "4", "--mtbf",
                   "3", "--quiet", "--jsonl", str(tmp_path / "run.jsonl"),
                   "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    printed = json.loads(out)
    assert printed["final_step"] == rep["final_step"] == 4
    assert len(printed["losses"]) == 2
    kinds = [json.loads(line)["kind"]
             for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    assert kinds.count("step") >= 4 and kinds[-1] == "summary"


def test_validate_runtime_row_equals_the_reference():
    assert [n for n, _ in TV.SCENARIOS] == [n for n, _ in RV.SCENARIOS]
    for (_, kt), (_, kr) in zip(TV.SCENARIOS, RV.SCENARIOS):
        sub = dict(kr, arch="xlstm-125m", layers=2, d_model=64, n_heads=1)
        assert kt == sub
    assert (TV.TOLERANCE, TV.N_SEEDS, TV.STEPS) == (RV.TOLERANCE,
                                                    RV.N_SEEDS, RV.STEPS)
    name, kw = TV.SCENARIOS[3]              # ml_algo_t_exp
    kw = dict(kw, total_steps=30)
    got = TV.run_scenario(name, kw, n_seeds=2, device=CPU)
    ref = RV.run_scenario(name, kw, n_seeds=2)
    assert got == pytest.approx(ref, rel=1e-12)
    assert got["mean_failures"] > 0


def test_example_runs_on_the_cpu(capsys):
    rep = TFT.main(["--steps", "2", "--mtbf", "1e9", "--device", CPU])
    assert rep["final_step"] == 2
    assert "summary: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--smoke"], ["--steps", "1"]],
                         ids=["smoke", "run"])
def test_cli_defaults_to_cuda_and_raises_without_a_gpu(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TT.main(argv)
