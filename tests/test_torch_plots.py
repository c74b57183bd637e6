"""The port's fe/plots.py and the estimators' plots (ROADMAP P21), on the
CPU, where matplotlib imports.

Every figure function renders a PNG (its magic bytes) on JAX's test inputs
(tests/test_analysis_tools.py's test_plot_functions_render_png and
test_plot_forward_and_reverse_dg_on_gaussian_ukln), with the pair-BAR
figures make_pair_bar_plots draws and a SingleTopology's interpolation
schedules besides. The estimators' plots are rendered where matplotlib
imports (tests/test_torch_bisection.py and tests/test_torch_ahfe.py hold
that); with matplotlib made unimportable they are None, with exactly one
PlotsUnavailableWarning a call.
"""

import sys
import warnings

import numpy as np
import pytest
import torch

from timemachine_torch.fe import free_energy as tfe
from timemachine_torch.fe import plots
from timemachine_torch.fe import rbfe as trbfe
from timemachine_torch.testsystems.gaussian1d import make_gaussian_ukln

torch.set_num_threads(1)  # the suite's workers share the host's cores

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
TEMP = 300.0


def test_plot_functions_render_png():
    rng = np.random.default_rng(0)
    pngs = [
        plots.plot_as_png_fxn(plots.plot_fwd_reverse_predictions, rng.normal(size=6), np.abs(rng.normal(size=6)),
                              rng.normal(size=6), np.abs(rng.normal(size=6))),
    ]
    tm = np.full((4, 4), 0.05)
    np.fill_diagonal(tm, 0.85)
    pngs.append(plots.plot_as_png_fxn(plots.plot_hrex_transition_matrix, tm, prefix="test"))
    rates = np.clip(rng.uniform(0.2, 0.6, size=(10, 3)), 0, 1)
    pngs.append(plots.plot_as_png_fxn(plots.plot_hrex_swap_acceptance_rates_convergence, rates))
    counts = rng.integers(0, 50, size=(5, 4, 4)).cumsum(axis=0)
    pngs.append(plots.plot_as_png_fxn(plots.plot_hrex_replica_state_distribution_heatmap, counts, [0.0, 0.3, 0.7, 1.0]))
    proposals = np.stack([rng.integers(10, 50, size=6), np.full(6, 100)], axis=1)
    pngs.append(plots.plot_as_png_fxn(plots.plot_water_proposals_by_state, np.linspace(0, 1, 6), proposals))
    pngs.append(plots.plot_as_png_fxn(plots.plot_chiral_restraint_energies, rng.uniform(0, 5, size=(3, 20))))
    assert all(png.startswith(PNG_MAGIC) for png in pngs)


@pytest.mark.parametrize("two_legs", [False, True])
def test_plot_forward_and_reverse_dg_on_gaussian_ukln(two_legs):
    pair_ukln, _ = make_gaussian_ukln(np.linspace(0.0, 1.0, 4), n_samples=200, seed=5)
    if two_legs:
        other, _ = make_gaussian_ukln(np.linspace(0.0, 1.0, 4), n_samples=200, seed=6)
        png = plots.plot_as_png_fxn(plots.plot_forward_and_reverse_ddg, pair_ukln, other, frames_per_step=50)
    else:
        png = plots.plot_as_png_fxn(plots.plot_forward_and_reverse_dg, pair_ukln, frames_per_step=50)
    assert png.startswith(PNG_MAGIC)


def test_pair_bar_figures_render_png():
    rng = np.random.default_rng(3)
    components, lambdas = ["HarmonicBond", "Nonbonded"], [0.0, 0.4, 1.0]
    u_kln = rng.normal(size=(2, 2, 2, 2, 50))  # (pairs, components, 2, 2, frames)
    pngs = [
        plots.plot_as_png_fxn(plots.plot_dG_errs_figure, components, lambdas, [0.1, 0.2], rng.uniform(0, 1, (2, 2))),
        plots.plot_as_png_fxn(plots.plot_overlap_summary_figure, components, lambdas, [0.5, 0.6], rng.uniform(0, 1, (2, 2))),
        plots.plot_as_png_fxn(plots.plot_overlap_detail_figure, components, [1.0, -2.0], [0.1, 0.2], u_kln, TEMP, "edge"),
    ]
    assert all(png.startswith(PNG_MAGIC) for png in pngs)


def test_interpolation_schedules_render_png():
    from tests.test_torch_bisection import _vacuum_edge
    from timemachine_torch.fe.single_topology import SingleTopology

    mol_a, mol_b, core, ff = _vacuum_edge()
    st = SingleTopology(mol_a, mol_b, core, ff)
    for fn in (plots.plot_core_interpolation_schedule, plots.plot_dummy_a_interpolation_schedule,
               plots.plot_dummy_b_interpolation_schedule):
        assert plots.plot_as_png_fxn(fn, st, n_windows=4).startswith(PNG_MAGIC)


def test_plots_available_warns_once_without_matplotlib(monkeypatch):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert plots.plots_available("plots")
    assert not [w for w in seen if issubclass(w.category, plots.PlotsUnavailableWarning)]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.warns(plots.PlotsUnavailableWarning, match="matplotlib does not import"):
        assert not plots.plots_available("plots")


def test_estimators_return_no_plots_without_matplotlib(monkeypatch):
    from tests.test_torch_bisection import BISECT_MD, _vacuum_edge

    mol_a, mol_b, core, ff = _vacuum_edge()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    runs = {
        "fixed grid": lambda: trbfe.estimate_relative_free_energy(
            mol_a, mol_b, core, ff, None, n_windows=2, md_params=tfe.MDParams(**BISECT_MD), device="cpu"),
        "hrex": lambda: trbfe.run_vacuum(
            mol_a, mol_b, core, ff, None, n_windows=2, device="cpu",
            md_params=tfe.MDParams(**BISECT_MD, hrex_params=tfe.HREXParams(n_frames_bisection=2))),
    }
    for name, run in runs.items():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            res = run()
        ours = [w for w in seen if issubclass(w.category, plots.PlotsUnavailableWarning)]
        assert len(ours) == 1, name
        assert res.plots is None and getattr(res, "hrex_plots", None) is None
        assert np.isfinite(res.final_result.dGs).all()
