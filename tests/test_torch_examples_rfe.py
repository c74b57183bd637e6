"""timemachine_torch/examples/relative_free_energy.py end to end on the CPU at a
cut depth (the third check of tests/test_torch_examples_rbfe.py): the
solvent leg of ethanol -> propane in a 2.35 nm water box (the leg's 4.0 nm
cut; 2.45 nm with its headroom, over twice the cutoff), the host's FIRE at
35 steps a window (fewer leave forces over MAX_FORCE_NORM) and 5 NPT steps,
BFGS capped at 3 iterations, 2 windows, 2 equilibration steps and 2 frames
of 2. Its ΔG and every frame are finite, and a rerun writes the same files
and frames bitwise. The rerun takes the first run's pre-equilibrated host
(half of a run here; md/minimizer.py's own tests hold it bitwise).
"""

import warnings

import numpy as np
import torch

from tests.test_torch_examples_rbfe import _files, sdf_path  # noqa: F401  (the module's SDF fixture)

torch.set_num_threads(1)  # the suite's workers share the host's cores


def test_relative_free_energy_solvent_runs_on_the_cpu_bitwise(sdf_path, tmp_path, monkeypatch):
    from timemachine_torch.examples import relative_free_energy as tex
    from timemachine_torch.fe import rbfe as trbfe
    from timemachine_torch.md import builders, fire, minimizer

    t_water, t_pre, hosts = builders.build_water_system, minimizer.pre_equilibrate_host, []

    def pre_equilibrate_once(*a, **k):
        if not hosts:
            hosts.append(t_pre(*a, minimizer_steps_per_window=35, equilibration_steps=5, **k))
        return tuple(np.copy(v) for v in hosts[0])

    monkeypatch.setattr(builders, "build_water_system", lambda width, *a, **k: t_water(2.35 if width == 4.0 else width, *a, **k))
    monkeypatch.setattr(minimizer, "pre_equilibrate_host", pre_equilibrate_once)
    monkeypatch.setattr(trbfe, "_default_minimization_config",
                        lambda: fire.ScipyMinimizationConfig(method="BFGS", options={"disp": False, "maxiter": 3}))
    argv = ["--n_frames", "2", "--ligands", str(sdf_path), "--mol_a_name", "ethanol", "--mol_b_name", "propane",
            "--protein", "unused.pdb", "--n_eq_steps", "2", "--steps_per_frame", "2", "--legs", "solvent",
            "--n_windows", "2", "--device", "cpu"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first = tex.main([*argv, "--output_dir", str(tmp_path / "a")])["solvent"]
        again = tex.main([*argv, "--output_dir", str(tmp_path / "b")])["solvent"]
    np.testing.assert_array_equal(first.final_result.dGs, again.final_result.dGs)
    assert np.all(np.isfinite(first.final_result.dGs))
    for fa, fb in zip(first.frames, again.frames):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
        assert np.all(np.isfinite(np.asarray(fa)))
    a, b = _files(tmp_path / "a"), _files(tmp_path / "b")
    assert list(a) == list(b) and {"solvent_traj_0.cif", "solvent_traj_1.cif"} <= set(a)
    for name in a:
        assert a[name].read_bytes() == b[name].read_bytes(), name
