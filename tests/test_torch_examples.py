"""The port's entry points timemachine_torch/examples/biphenyl_torsion_sampling_hrex.py
and water_sampling_mc.py against the repository's JAX scripts in examples/,
imported by path, their module attributes patched only here; and the
helpers that tests/test_torch_examples_water.py and
tests/test_torch_examples_rbfe.py share.

The noise streams of the two packages differ by design (ROADMAP P15, P23,
P28), so each example is held three ways:
1. what it builds from its arguments is JAX's: make_state's potentials,
   integrator and velocities; the water box, HMR masses, integrator and
   TIBD mover handed to the Context (to 1e-12, mostly exactly);
2. with the sampling driver or the Context replaced in both packages by a
   recorder that returns one fixed result, it passes JAX's arguments (MDParams and its
   nested parameters field by field, the diagnostics interval) and prints
   JAX's summary lines;
3. it runs end to end on the CPU at a cut depth, finite, and a rerun is
   bitwise.
The biphenyl is JAX's embedding, given to both packages.
"""

import dataclasses
import importlib.util
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite's workers share the host's cores

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12


class _Stop(Exception):
    """Raised by a recorder to end an example once it has what it built."""


def jax_example(name: str, monkeypatch):
    """The JAX script examples/<name>.py as a fresh module (examples/ on the
    path for water_sampling_common)."""
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    return mod.main()


def assert_fields_equal(got, ref, path="md_params"):
    """ref's dataclass fields, recursively, equal got's (numbers exactly)."""
    if dataclasses.is_dataclass(ref):
        assert type(got).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(ref):
            assert_fields_equal(getattr(got, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    else:
        assert got == ref, (path, got, ref)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_close(got, ref, rel=REL):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(initial=0.0), np.finfo(np.float64).tiny)
    assert np.abs(got - ref).max(initial=0.0) <= rel * scale


def fixed_hrex_result(n_states: int, frames: np.ndarray, boxes: np.ndarray, water: bool):
    """What a recorder returns for run_sims_hrex: (pair BAR, trajectories,
    HREX diagnostics, water diagnostics)."""
    pair_bar = SimpleNamespace(dGs=np.linspace(1.0, 2.0, n_states - 1))
    trajs = [SimpleNamespace(frames=list(frames + 0.01 * k), boxes=list(boxes)) for k in range(n_states)]
    rates = np.linspace(0.1, 0.9, 3 * (n_states - 1)).reshape(3, n_states - 1)
    diag = SimpleNamespace(cumulative_swap_acceptance_rates=rates)
    counts = np.stack([np.arange(n_states), 2 * np.arange(n_states) + 1], axis=1)
    water_diag = SimpleNamespace(cumulative_proposals_by_state=lambda: counts) if water else None
    return pair_bar, trajs, diag, water_diag


# -- biphenyl_torsion_sampling_hrex ---------------------------------------------------


@pytest.fixture(scope="module")
def biphenyl():
    """JAX's get_biphenyl and the port's molecule of its SMILES at JAX's
    conformer, with the torsion indices; both force fields."""
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.ff import Forcefield as TF
    from timemachine_tpu.ff import Forcefield as JF
    from timemachine_tpu.testsystems.ligands import get_biphenyl

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, torsions = get_biphenyl()
    tm = mol_from_smiles("Fc1cccc(F)c1-c1ccccc1F")
    tm.set_conf(np.asarray(jm.get_conf()))
    return dict(jm=jm, tm=tm, torsions=torsions, jff=JF.load_default(), tff=TF.load_default())


@pytest.fixture
def biphenyl_modules(biphenyl, monkeypatch):
    from timemachine_torch.examples import biphenyl_torsion_sampling_hrex as tex

    jex = jax_example("biphenyl_torsion_sampling_hrex", monkeypatch)
    monkeypatch.setattr(jex, "get_biphenyl", lambda: (biphenyl["jm"], biphenyl["torsions"]))
    monkeypatch.setattr(tex, "get_biphenyl", lambda: (biphenyl["tm"], biphenyl["torsions"]))
    return jex, tex


@pytest.mark.parametrize("lamb", (0.0, 0.4, 1.0))
def test_biphenyl_make_state_is_jax(biphenyl, biphenyl_modules, lamb):
    jex, tex = biphenyl_modules
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = jex.make_state(biphenyl["jm"], biphenyl["jff"], lamb, 10.0, 2023)
        ts = tex.make_state(biphenyl["tm"], biphenyl["tff"], lamb, 10.0, 2023, device="cpu")
    assert [type(m).__name__ for m in ts.potentials] == [type(bp.potential).__name__ for bp in js.potentials]
    for m, bp in zip(ts.potentials, js.potentials):
        assert_close(m.params, bp.params)
    for k in ("x0", "v0", "box0", "ligand_idxs", "protein_idxs"):
        np.testing.assert_array_equal(getattr(ts, k), np.asarray(getattr(js, k)), err_msg=k)
    assert ts.lamb == js.lamb and ts.barostat is js.barostat is None
    for k in ("temperature", "dt", "friction", "seed"):
        assert getattr(ts.integrator, k) == getattr(js.integrator, k)
    np.testing.assert_array_equal(ts.integrator.masses, np.asarray(js.integrator.masses))
    assert ts.potentials[0].params.device.type == "cpu"


def test_biphenyl_passes_jax_arguments_and_prints_jax_lines(biphenyl, biphenyl_modules, monkeypatch, capsys):
    jex, tex = biphenyl_modules
    frames = np.stack([np.asarray(biphenyl["jm"].get_conf()) * (1 + 0.1 * k) for k in range(4)])
    boxes = np.stack([np.eye(3) * 10.0] * 4)
    calls = {}

    def recorder(tag):
        def run_sims_hrex(states, md_params, print_diagnostics_interval=None):
            calls[tag] = (states, md_params, print_diagnostics_interval)
            return fixed_hrex_result(len(states), frames, boxes, water=False)

        return run_sims_hrex

    argv = ["--n_states", "3", "--n_frames", "7", "--steps_per_frame", "11", "--seed", "2029"]
    monkeypatch.setattr(jex, "run_sims_hrex", recorder("jax"))
    monkeypatch.setattr(tex, "run_sims_hrex", recorder("port"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_jax_main(jex, argv, monkeypatch)
        j_out = capsys.readouterr().out
        tex.main([*argv, "--device", "cpu"])
        t_out = capsys.readouterr().out
    assert t_out == j_out and "torsion barrier crossed in physical state" in t_out
    assert_fields_equal(calls["port"][1], calls["jax"][1])
    assert calls["port"][2] == calls["jax"][2] == 50
    assert [s.lamb for s in calls["port"][0]] == [s.lamb for s in calls["jax"][0]]
    for ts, js in zip(calls["port"][0], calls["jax"][0]):
        assert_close(ts.potentials[2].params, js.potentials[2].params)


def test_biphenyl_runs_on_the_cpu_bitwise(biphenyl_modules, monkeypatch):
    """2 states, 20 equilibration steps (the script's 1,000 cut), 2 frames of 10."""
    from timemachine_torch.fe.free_energy import MDParams

    _, tex = biphenyl_modules

    monkeypatch.setattr(tex, "MDParams", lambda **kw: MDParams(**{**kw, "n_eq_steps": 20}))
    argv = ["--n_states", "2", "--n_frames", "2", "--steps_per_frame", "10", "--device", "cpu"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (bar_a, trajs_a, _), (bar_b, trajs_b, _) = tex.main(argv), tex.main(argv)
    np.testing.assert_array_equal(bar_a.dGs, bar_b.dGs)
    assert np.all(np.isfinite(bar_a.dGs))
    for a, b in zip(trajs_a, trajs_b):
        np.testing.assert_array_equal(np.asarray(a.frames), np.asarray(b.frames))
        assert np.all(np.isfinite(np.asarray(a.frames)))


# -- water_sampling_mc -------------------------------------------------------------------


def _context_recorder(calls, tag):
    def context(x0, v0, box, integrator, bps, movers=(), device=None):
        calls[tag] = SimpleNamespace(x0=x0, v0=v0, box=box, integrator=integrator, bps=bps, movers=movers)
        raise _Stop

    return context


def test_water_sampling_mc_builds_jax_context(monkeypatch, capsys):
    from timemachine_torch.examples import water_sampling_mc as tex

    jex = jax_example("water_sampling_mc", monkeypatch)
    calls = {}
    monkeypatch.setattr(jex, "Context", _context_recorder(calls, "jax"))
    monkeypatch.setattr(tex, "Context", _context_recorder(calls, "port"))
    argv = ["--box_width", "2.6", "--radius", "0.5", "--md_steps_per_batch", "30", "--mc_proposals_per_batch", "70",
            "--seed", "2030"]
    with pytest.raises(_Stop):
        run_jax_main(jex, argv, monkeypatch)
    j_out = capsys.readouterr().out
    with pytest.raises(_Stop):
        tex.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == j_out
    j, t = calls["jax"], calls["port"]
    for k in ("x0", "v0", "box"):
        np.testing.assert_array_equal(_np(getattr(t, k)), np.asarray(getattr(j, k)), err_msg=k)
    for k in ("temperature", "dt", "friction", "seed"):
        assert getattr(t.integrator, k) == getattr(j.integrator, k)
    np.testing.assert_array_equal(t.integrator.masses, np.asarray(j.integrator.masses))
    assert [type(m).__name__ for m in t.bps] == [type(bp.potential).__name__ for bp in j.bps]
    for m, bp in zip(t.bps, j.bps):
        assert_close(m.params, bp.params)
    (tm,), (jm,) = t.movers, j.movers
    for k in ("n_atoms", "temperature", "beta", "cutoff", "radius", "seed", "n_proposals", "interval"):
        assert getattr(tm, k) == getattr(jm, k), k
    np.testing.assert_array_equal(tm.ligand_idxs, np.asarray(jm.ligand_idxs))
    np.testing.assert_array_equal(tm.water_idxs, np.asarray(jm.water_idxs).reshape(-1, 3))
    assert_close(tm.params, jm.params)


def test_water_sampling_mc_prints_jax_lines(monkeypatch, capsys):
    """Both scripts' iteration lines from one fixed Context run: the same
    occupancy, counts and density text."""
    from timemachine_torch.examples import water_sampling_mc as tex

    jex = jax_example("water_sampling_mc", monkeypatch)
    rng = np.random.default_rng(5)

    def fixed_context(x0, v0, box, integrator, bps, movers=(), device=None):
        x = np.asarray(x0) + rng.normal(0.0, 0.01, np.shape(x0))
        state = SimpleNamespace(n_accepted=3, n_proposed=40)
        return SimpleNamespace(multiple_steps=lambda n: None, get_x_t=lambda: x, get_box=lambda: np.asarray(box) * 1.01,
                               _mover_states=[state])

    monkeypatch.setattr(jex, "Context", fixed_context)
    monkeypatch.setattr(tex, "Context", fixed_context)
    argv = ["--box_width", "2.6", "--n_iterations", "2"]
    run_jax_main(jex, argv, monkeypatch)
    j_out = capsys.readouterr().out
    rng = np.random.default_rng(5)
    tex.main([*argv, "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert t_out == j_out and t_out.count("| occupancy") == 2


def test_water_sampling_mc_runs_on_the_cpu_bitwise():
    """The 2.5 nm box (over twice the cutoff), 2 iterations of 10 steps with
    20 proposals each."""
    from timemachine_torch.examples import water_sampling_mc as tex

    argv = ["--box_width", "2.5", "--n_iterations", "2", "--md_steps_per_batch", "10", "--mc_proposals_per_batch", "20",
            "--device", "cpu"]
    (ctx_a, occ_a), (ctx_b, occ_b) = tex.main(argv), tex.main(argv)
    assert occ_a == occ_b
    np.testing.assert_array_equal(ctx_a.get_x_t(), ctx_b.get_x_t())
    np.testing.assert_array_equal(ctx_a.get_box(), ctx_b.get_box())
    assert np.all(np.isfinite(ctx_a.get_x_t()))
    assert int(ctx_a._mover_states[0].n_proposed) == 40
