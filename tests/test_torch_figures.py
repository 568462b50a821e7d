"""The paper's figures and tables on the port against the reference scripts.

``energy_breakdown``, ``paper_printed_coefficients`` and the trade-off
points are held to 1e-12.  Each figure and table script of
``repro_torch.benchmarks`` runs on the CPU beside its reference script in
``benchmarks/`` (both writing to a temporary directory): the CSVs must be
equal byte for byte (fig5's, of full-precision floats, value for value
within 1e-10), and the port's unrounded rows within 1e-8 (periods) and
1e-10 (values) of the reference's numbers.  fig4's CSV, of full-precision
floats, is byte-equal to the reference's script run operation by operation
(``jax.disable_jit``), and within 1e-13 of its compiled run, whose XLA
program contracts ``a + b * c`` into FMAs.  Draws go through numpy
generators: the port's ``np.random.default_rng(s)`` against the
reference's ``seed=s``.  ``energy_study`` matches the reference's
example section by section; its single-level Monte-Carlo lines (the
reference draws them through threefry, the port through Philox) within
four of their combined standard errors.
"""
import contextlib
import dataclasses
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.sim as RS

import repro_torch.core as PC
import repro_torch.sim as TS
from repro_torch import interop
from repro_torch.benchmarks import (_util, energy_study, fig1_rho_sweep,
                                    fig2_mu_rho, fig3_scalability,
                                    fig4_multilevel, fig5_robustness,
                                    quickstart, run, table_baselines,
                                    table_simulation)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"

sys.path.insert(0, str(ROOT))
import benchmarks._util as ref_util  # noqa: E402
from benchmarks import fig1_rho_sweep as ref_fig1  # noqa: E402
from benchmarks import fig2_mu_rho as ref_fig2  # noqa: E402
from benchmarks import fig3_scalability as ref_fig3  # noqa: E402
from benchmarks import fig4_multilevel as ref_fig4  # noqa: E402
from benchmarks import fig5_robustness as ref_fig5  # noqa: E402
from benchmarks import table_baselines as ref_tb  # noqa: E402
from benchmarks import table_simulation as ref_ts  # noqa: E402

PLATFORMS = [(RC.fig12_checkpoint(300.0), RC.EXASCALE_POWER_RHO55),
             (RC.fig12_checkpoint(60.0), RC.EXASCALE_POWER_RHO7),
             (RC.fig3_checkpoint(2e6), RC.PowerParams.from_rho(rho=3.0,
                                                               alpha=0.5))]


def _port(ck, pw):
    return (interop.ckpt_from_fields(dataclasses.asdict(ck)),
            interop.power_from_fields(dataclasses.asdict(pw)))


@pytest.fixture
def results(monkeypatch, tmp_path):
    """Both packages' scripts write under ``tmp_path``."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    for m in (ref_util, ref_fig1, ref_fig2, ref_fig3, ref_fig4, ref_fig5,
              ref_tb, ref_ts):
        monkeypatch.setattr(m, "RESULTS", ref_dir)
    monkeypatch.setattr(_util, "RESULTS", port_dir)
    return ref_dir, port_dir


def _same_csv(a: Path, b: Path):
    assert a.name == b.name
    assert a.read_text() == b.read_text()


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=0.0)


class TestCoreAdditions:
    @pytest.mark.parametrize("i", range(len(PLATFORMS)))
    def test_energy_breakdown(self, i):
        ck, pw = PLATFORMS[i]
        for T, T_base in ((60.0, 1.0), (85.5, 4000.0)):
            if not ck.valid_period_range()[0] < T < \
                    ck.valid_period_range()[1]:
                T = RC.t_opt_time(ck)
            a = RC.energy_breakdown(T, ck, pw, T_base)
            b = PC.energy_breakdown(T, *_port(ck, pw), T_base, device=CPU)
            assert set(a) == set(b)
            for k in a:
                assert b[k] == pytest.approx(a[k], rel=1e-12, abs=1e-300), k
            assert b["E_final"] == pytest.approx(
                float(PC.energy_final(T, *_port(ck, pw), T_base,
                                      device=CPU)), rel=1e-12)

    @pytest.mark.parametrize("i", range(len(PLATFORMS)))
    def test_paper_printed_coefficients(self, i):
        ck, pw = PLATFORMS[i]
        assert PC.paper_printed_coefficients(*_port(ck, pw)) == \
            RC.paper_printed_coefficients(ck, pw)

    @pytest.mark.parametrize("i", range(len(PLATFORMS)))
    def test_evaluate_tradeoff_point(self, i):
        ck, pw = PLATFORMS[i]
        a = RC.evaluate(ck, pw)
        b = PC.evaluate(*_port(ck, pw), device=CPU)
        for f in ("T_time", "T_energy", "time_ratio", "energy_ratio",
                  "energy_saving", "time_overhead"):
            assert getattr(b, f) == pytest.approx(getattr(a, f), rel=1e-12,
                                                  abs=1e-15), f
        degenerate = RC.fig3_checkpoint(1e8)
        d = PC.evaluate(_port(degenerate, pw)[0], _port(ck, pw)[1],
                        device=CPU)
        assert (d.time_ratio, d.energy_ratio) == (1.0, 1.0)

    @pytest.mark.parametrize("engine", ["batched", "scalar"])
    def test_sweeps_match_reference(self, engine):
        from repro.core import tradeoff as RT
        rhos = [1.5, 5.5, 9.0]
        pairs = [
            (RT.sweep_rho(rhos, 120.0, engine=engine),
             PC.sweep_rho(rhos, 120.0, engine=engine, device=CPU)),
            (sum(RT.sweep_mu_rho([60.0, 300.0], rhos, alpha=0.5,
                                 engine=engine), []),
             sum(PC.sweep_mu_rho([60.0, 300.0], rhos, alpha=0.5,
                                 engine=engine, device=CPU), [])),
            (RT.sweep_nodes([1e5, 1e7, 1e8], RC.EXASCALE_POWER_RHO7,
                            engine=engine),
             PC.sweep_nodes([1e5, 1e7, 1e8], PC.EXASCALE_POWER_RHO7,
                            engine=engine, device=CPU))]
        for ref, got in pairs:
            assert len(ref) == len(got)
            for a, b in zip(ref, got):
                assert dataclasses.asdict(b.ckpt) == dataclasses.asdict(a.ckpt)
                for f in ("T_time", "T_energy", "time_ratio",
                          "energy_ratio"):
                    assert getattr(b, f) == pytest.approx(
                        getattr(a, f), rel=1e-12), f


class TestScripts:
    @pytest.mark.parametrize("which", ["fig1", "fig2", "fig3"])
    def test_figure_rows_match_reference(self, which, results):
        ref_mod, port_mod = {"fig1": (ref_fig1, fig1_rho_sweep),
                             "fig2": (ref_fig2, fig2_mu_rho),
                             "fig3": (ref_fig3, fig3_scalability)}[which]
        ref_out, ref_head = ref_mod.run()
        out, head, rows = port_mod.run(device=CPU)
        _same_csv(ref_out, out)
        _close(head, ref_head, 1e-10)
        # the reference's unrounded numbers behind its rows
        if which == "fig3":
            want = []
            for rho, pw in ((5.5, RC.EXASCALE_POWER_RHO55),
                            (7.0, RC.EXASCALE_POWER_RHO7)):
                res = RS.sweep_nodes_grid(np.logspace(5, 8, 25), pw)
                want += [(rho, res.grid.mu[i], res.energy_ratio[i],
                          res.time_ratio[i]) for i in range(25)]
        else:
            rhos = list(np.linspace(1.0, 10.0, 19 if which == "fig1"
                                    else 10))
            res = RS.sweep_mu_rho_grid(ref_mod.MUS, rhos)
            want = [(mu, res.grid.rho[i, j], res.energy_ratio[i, j],
                     res.time_ratio[i, j]) for i, mu in enumerate(ref_mod.MUS)
                    for j in range(len(rhos))]
        _close(rows, want, 1e-10)

    def test_fig1_headline(self, results):
        _, (mu, rho, e_ratio, t_ratio), _ = fig1_rho_sweep.run(device=CPU)
        assert (mu, rho) == (300.0, 5.5)
        assert 1.0 - 1.0 / e_ratio > 0.18 and e_ratio > 1.2
        assert 1.05 < t_ratio < 1.15

    def test_table_baselines_match_reference(self, results):
        ref_out, (ref_ep, ref_eo) = ref_tb.run()
        out, (ep, eo), rows = table_baselines.run(device=CPU)
        _same_csv(ref_out, out)
        assert ep == pytest.approx(ref_ep, rel=1e-10)
        assert abs(eo - ref_eo) <= 1e-12
        for mu, name, T, Tf, E in rows:
            ck = RC.fig12_checkpoint(mu)
            T_ref = RC.period_for(name, ck, RC.EXASCALE_POWER_RHO55)
            # MSK is a golden-section argmin: held by its objective
            assert T == pytest.approx(T_ref, rel=1e-8 if name !=
                                      "msk_energy" else 1e-6), name
            assert Tf == pytest.approx(float(RC.time_final(T, ck)),
                                       rel=1e-10)
            assert E == pytest.approx(float(RC.energy_final(
                T, ck, RC.EXASCALE_POWER_RHO55)), rel=1e-10)

    def test_table_simulation_matches_reference(self, results):
        ref_out, ref_err = ref_ts.run()
        out, err, rows = table_simulation.run(np.random.default_rng(0),
                                              device=CPU)
        _same_csv(ref_out, out)
        assert err == pytest.approx(ref_err, rel=1e-10)
        ck, pw = RC.fig12_checkpoint(300.0), RC.EXASCALE_POWER_RHO55
        for name, T, T_sim, T_model, E_sim, E_model in rows:
            ref = RC.simulate(T, ck, pw, T_base=4000.0, n_trials=400, seed=0)
            assert T_sim == pytest.approx(ref["T_final"], rel=1e-10)
            assert E_sim == pytest.approx(ref["E_final"], rel=1e-10)
            assert T_model == pytest.approx(
                float(RC.time_final(T, ck, 4000.0)), rel=1e-10)

    def test_quickstart_matches_reference(self):
        spec = importlib.util.spec_from_file_location(
            "ref_quickstart", ROOT / "examples" / "quickstart.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        lines = quickstart.run(np.random.default_rng(0), device=CPU)
        assert "\n".join(lines) + "\n" == buf.getvalue()

    def test_fig5_matches_reference_at_small_size(self, results,
                                                  monkeypatch):
        for mod in (ref_fig5, fig5_robustness):
            monkeypatch.setattr(mod, "SHAPES", [0.5, 1.0])
            monkeypatch.setattr(mod, "MU_MINS", [120.0])
            monkeypatch.setattr(mod, "N_TRIALS", 48)
        ref, _, ref_worst, ref_drift = ref_fig5.run()
        res, _, worst, drift, rows = fig5_robustness.run(
            np.random.default_rng(0), np.random.default_rng(1), device=CPU)
        # its CSV holds full-precision floats: the same columns, values
        # within the penalties' tolerance
        a, b = (np.genfromtxt(d / "fig5_robustness.csv", delimiter=",",
                              names=True) for d in results)
        assert a.dtype.names == b.dtype.names
        for f in a.dtype.names:
            _close(b[f], a[f], 1e-10)
        for f in ("T_exp_time", "T_exp_energy", "T_young", "T_daly",
                  "T_mc_time", "T_mc_energy"):
            _close(getattr(res, f), getattr(ref, f), 1e-12)
        for f in ("time_penalty_exp", "energy_penalty_exp",
                  "time_penalty_young", "time_penalty_daly",
                  "energy_penalty_young", "energy_penalty_daly"):
            _close(getattr(res, f), getattr(ref, f), 1e-10)
        assert worst == pytest.approx(ref_worst, rel=1e-9, abs=1e-12)
        assert drift == pytest.approx(ref_drift, rel=1e-9, abs=1e-12)
        assert len(rows) == 2 and rows[0]["weibull_shape"] == 0.5

    def test_fig4_matches_reference(self, results, monkeypatch):
        """The CSV byte for byte against the reference's script run
        operation by operation; values within 1e-13 of its compiled run,
        the same cadences; the headline (40.56% below PFS-only at ratio
        0.02, q 0.01, m* = 12)."""
        monkeypatch.setattr(ref_fig4, "timed",
                            lambda fn, *a, repeat=3, **k: (fn(*a, **k), 0.0))
        with jax.disable_jit():
            ref_fig4.run()
        out, res, head, rows = fig4_multilevel.run(device=CPU)
        _same_csv(results[0] / "fig4_multilevel.csv", out)
        ref = RS.evaluate_multilevel_grid(
            RS.buddy_ratio_grid(ref_fig4.RATIOS, ref_fig4.QS,
                                mu_min=ref_fig4.MU_MIN),
            m_values=ref_fig4.M_VALUES)
        for f in ("m_time", "m_energy"):
            np.testing.assert_array_equal(getattr(res, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        for f in ("T_time", "T_energy", "time_ratio", "energy_ratio",
                  "time_vs_single", "energy_vs_single"):
            _close(getattr(res, f).numpy(), getattr(ref, f), 1e-13)
        evs = np.asarray(ref.energy_vs_single)
        assert head[0] == pytest.approx(1.0 - np.nanmin(evs), rel=1e-13)
        assert abs(head[0] - 0.4056) < 5e-5 and head[1:] == (0.02, 0.01, 12)
        assert len(rows) == 30 and rows[0]["m_energy"] == 12

    def test_energy_study_matches_reference(self):
        spec = importlib.util.spec_from_file_location(
            "ref_energy_study", ROOT / "examples" / "energy_study.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        split = lambda text: text.strip("\n").split("\n\n== ")
        ref = split(buf.getvalue())
        got = split("\n".join(energy_study.run(np.random.default_rng(0),
                                               device=CPU)))
        assert len(got) == len(ref) == 8
        # the catalog is the port's registry, a subset of the reference's
        # (the arch scenarios wait for configs/)
        ref_cat, got_cat = ref[0].split("\n"), got[0].split("\n")
        assert got_cat[0] == ref_cat[0] and set(got_cat) <= set(ref_cat)
        assert len(got_cat) == len(TS.list_scenarios()) + 1
        # the single-level MC point: simulated energies within 4 combined
        # standard errors (300 trials: 0.26% of E at AlgoT, 0.50% at
        # AlgoE), the gain within 4 points; the model numbers exact
        nums = lambda text: [float(x) for x in re.findall(r"[-\d.]+\d",
                                                          text)]
        (a_t, m_t, a_e, m_e, gain), (b_t, n_t, b_e, n_e, g2) = (
            nums(ref[2].split("\n", 1)[1]), nums(got[2].split("\n", 1)[1]))
        assert (m_t, m_e) == (n_t, n_e)
        assert abs(b_t / a_t - 1.0) <= 4 * 2**0.5 * 0.0026
        assert abs(b_e / a_e - 1.0) <= 4 * 2**0.5 * 0.0050
        assert abs(g2 - gain) <= 4.0
        # every other section, the Weibull rows and the two-level MC point
        # included, line for line
        for i in (1, 3, 4, 5, 6, 7):
            assert got[i] == ref[i], got[i]

    def test_run_figures_on_the_cpu(self, results, capsys):
        """run_figures at full size: fig4's headline (41% at ratio 0.02,
        q 0.01, m* 12), fig5's (the reference's 8.1% energy penalty at
        k = 0.5, mu = 120) and its 2% gate."""
        rows = run.run_figures(np.random.default_rng(0),
                               np.random.default_rng(0),
                               np.random.default_rng(1), device=CPU)
        names = [r.split(",")[0] for r in rows]
        assert names == ["fig1_rho_sweep", "fig2_mu_rho", "fig3_scalability",
                         "fig4_multilevel", "fig5_robustness",
                         "table_baselines", "table_simulation",
                         "table_arch_periods"]
        assert "best energy 41% below PFS-only (ratio=0.02, q=0.01, m*=12)" \
            in rows[3]
        assert "energy penalty 8.1% at k=0.5 mu=120min" in rows[4]
        assert capsys.readouterr().out.startswith("name,us_per_call,derived")
        for name in names:
            assert (results[1] / f"{name}.csv").is_file()


@pytest.mark.parametrize("call", [
    lambda: fig1_rho_sweep.run(),
    lambda: table_baselines.run(),
    lambda: PC.evaluate(PC.fig12_checkpoint(300.0), PC.EXASCALE_POWER_RHO55),
    lambda: PC.energy_breakdown(60.0, PC.fig12_checkpoint(300.0),
                                PC.EXASCALE_POWER_RHO55),
    lambda: fig4_multilevel.run(),
    lambda: energy_study.run(np.random.default_rng(0)),
], ids=["fig1", "table_baselines", "evaluate", "energy_breakdown", "fig4",
        "energy_study"])
def test_default_device_raises_without_cuda(call, results):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        call()
