"""The port's entry points timemachine_torch/examples/run_rbfe_legs.py and
relative_free_energy.py against the repository's JAX scripts in examples/,
imported by path, their module attributes patched only here, held the three
ways of tests/test_torch_examples.py. The ligands are ethanol and propane at
the RBFE cache's conformers, written to an SDF by the port's write_sdf.
1. Both packages read the SDF to the same molecules (atoms, bonds,
   conformers exactly) and map the same core.
2. With the leg drivers (run_vacuum, run_solvent, run_complex) replaced in
   both packages by a recorder that returns one fixed result, the port
   passes JAX's arguments (MDParams field by field, n_windows,
   min_overlap, the protein) and writes JAX's files: the same names, the
   same results.npz keys and values, the same CIF text and overlap plot,
   and prints JAX's lines. JAX's device pool is replaced by its serial
   client (the port's takes that itself on the CPU).
3. run_rbfe_legs runs end to end on the CPU at a cut depth: the vacuum leg
   (3 windows, 1 bisection frame, 10 equilibration steps, 2 frames of 10), finite, and bitwise on
   a rerun. relative_free_energy's run is tests/test_torch_examples_rfe.py's.
"""

import pickle
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_chem import EDGE, mol_pair
from tests.test_torch_examples import assert_fields_equal, jax_example, run_jax_main

torch.set_num_threads(1)  # the suite's workers share the host's cores

NAMES = ("ethanol", "propane")


@pytest.fixture(scope="module")
def sdf_path(tmp_path_factory):
    from timemachine_torch.chem.sdf import write_sdf

    path = tmp_path_factory.mktemp("ligands") / "pair.sdf"
    write_sdf([mol_pair(smi, name)[1] for smi, name in zip(EDGE, NAMES)], str(path))
    return path


def _fixed_leg_result(tag, calls, leg, mol_a, mol_b, core, n_hybrid):
    rng = np.random.default_rng(len(leg))
    frames = [list(rng.normal(size=(2, n_hybrid, 3))) for _ in range(3)]
    states = [SimpleNamespace(lamb=lamb) for lamb in (0.0, 0.5, 1.0)]
    final = SimpleNamespace(dGs=np.array([1.25, -0.5]), dG_errs=np.array([0.25, 0.125]),
                            overlaps=np.array([0.5, 0.75]), initial_states=states)
    trajs = [SimpleNamespace(frames=f, boxes=[np.eye(3) * 3.0] * len(f)) for f in frames]
    return SimpleNamespace(final_result=final, trajectories=trajs, frames=frames,
                           plots=SimpleNamespace(overlap_detail_png=b"png:" + leg.encode()))


def _leg_recorder(tag, calls, leg, host_config=None, n_hybrid=0):
    def run(mol_a, mol_b, core, ff, host_arg, md_params=None, n_windows=None, min_overlap=None, device=None):
        calls[tag, leg] = dict(names=(mol_a.name, mol_b.name), core=np.asarray(core), host=host_arg,
                               md_params=md_params, n_windows=n_windows, min_overlap=min_overlap)
        res = _fixed_leg_result(tag, calls, leg, mol_a, mol_b, core, n_hybrid)
        return res if leg == "vacuum" else (res, host_config)

    return run


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def test_sdf_reads_to_the_same_molecules_in_both_packages(sdf_path):
    from timemachine_torch.fe.utils import read_sdf_mols_by_name as t_read
    from timemachine_tpu.fe.utils import read_sdf_mols_by_name as j_read

    j, t = j_read(str(sdf_path)), t_read(str(sdf_path))
    assert list(t) == list(j) == list(NAMES)
    for name in NAMES:
        assert [a.atomic_num for a in t[name].atoms] == [a.atomic_num for a in j[name].atoms]
        assert [(b.src, b.dst, b.order) for b in t[name].bonds] == [(b.src, b.dst, b.order) for b in j[name].bonds]
        np.testing.assert_array_equal(t[name].get_conf(), np.asarray(j[name].get_conf()))


def test_run_rbfe_legs_passes_jax_arguments_and_writes_jax_files(sdf_path, tmp_path, monkeypatch, capsys):
    from timemachine_torch.examples import run_rbfe_legs as tex
    from timemachine_tpu.parallel.client import SerialClient

    jex = jax_example("run_rbfe_legs", monkeypatch)
    monkeypatch.setattr(jex, "DevicePoolClient", lambda n: SerialClient())
    monkeypatch.setattr(jex, "get_device_count", lambda: 1)
    calls = {}
    for tag, mod in (("jax", jex), ("port", tex)):
        for leg in ("vacuum", "solvent", "complex"):
            monkeypatch.setattr(mod, f"run_{leg}", _leg_recorder(tag, calls, leg, host_config={"host": leg}))
    common = ["--sdf_path", str(sdf_path), "--mol_a", "ethanol", "--mol_b", "propane", "--pdb_path", "host.pdb",
              "--n_eq_steps", "30", "--n_frames", "4", "--steps_per_frame", "7", "--n_windows", "5", "--seed", "2027",
              "--rest_max_temperature_scale", "2.5", "--water_sampling_padding", "0.3"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_jax_main(jex, [*common, "--output_dir", str(tmp_path / "jax")], monkeypatch)
        j_out = capsys.readouterr().out
        tex.main([*common, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
        t_out = capsys.readouterr().out
    assert t_out == j_out and t_out.count("ethanol -> propane (kJ/mol)") == 3
    for leg in ("vacuum", "solvent", "complex"):
        j, t = calls["jax", leg], calls["port", leg]
        assert t["names"] == j["names"] and (t["n_windows"], t["min_overlap"]) == (j["n_windows"], j["min_overlap"])
        np.testing.assert_array_equal(t["core"], j["core"])
        assert_fields_equal(t["md_params"], j["md_params"])
        assert t["host"] == j["host"]
    j_files, t_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert list(t_files) == list(j_files)
    for name in t_files:
        if name.endswith("results.npz") or name.endswith("_traj.npz"):
            with np.load(j_files[name]) as jz, np.load(t_files[name]) as tz:
                assert tz.files == jz.files
                for k in jz.files:
                    np.testing.assert_array_equal(tz[k], jz[k])
    assert pickle.loads(t_files["core.pkl"].read_bytes()).tolist() == pickle.loads(j_files["core.pkl"].read_bytes()).tolist()
    assert t_files["mols.sdf"].read_text() == j_files["mols.sdf"].read_text()


def test_run_rbfe_legs_vacuum_runs_on_the_cpu_bitwise(sdf_path, tmp_path, monkeypatch):
    from timemachine_torch.examples import run_rbfe_legs as tex
    from timemachine_torch.fe.free_energy import HREXParams

    # at JAX's --target_overlap the schedule is rebalanced, which raises in both packages (ROADMAP R8)
    monkeypatch.setattr(
        tex, "HREXParams", lambda **kw: HREXParams(**{**kw, "n_frames_bisection": 1, "optimize_target_overlap": None})
    )
    argv = ["--sdf_path", str(sdf_path), "--mol_a", "ethanol", "--mol_b", "propane", "--legs", "vacuum",
            "--n_eq_steps", "10", "--n_frames", "2", "--steps_per_frame", "10", "--n_windows", "3",
            "--device", "cpu"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first = tex.main([*argv, "--output_dir", str(tmp_path / "a")])
        again = tex.main([*argv, "--output_dir", str(tmp_path / "b")])
    assert first == again and np.all(np.isfinite(first))
    a, b = _files(tmp_path / "a"), _files(tmp_path / "b")
    assert list(a) == list(b)
    assert {"vacuum/results.npz", "vacuum/lambda0_traj.npz", "vacuum/simulation_result.pkl"} <= set(a)
    for name in ("vacuum/results.npz", "vacuum/lambda0_traj.npz", "vacuum/lambda1_traj.npz"):
        with np.load(a[name]) as za, np.load(b[name]) as zb:
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
                assert np.all(np.isfinite(za[k]))


def test_relative_free_energy_passes_jax_arguments_and_writes_jax_cif(sdf_path, tmp_path, monkeypatch, capsys):
    from timemachine_torch.examples import relative_free_energy as tex
    from timemachine_torch.fe.single_topology import AtomMapMixin
    from timemachine_torch.md.builders import build_water_system as t_water
    from timemachine_tpu.md.builders import build_water_system as j_water

    jex = jax_example("relative_free_energy", monkeypatch)
    hosts = {"jax": j_water(1.0), "port": t_water(1.0)}
    calls = {}
    # the frames: the host's atoms, then the hybrid ligand's
    ja, jb = (mol_pair(smi, name)[0] for smi, name in zip(EDGE, NAMES))
    from timemachine_tpu.constants import DEFAULT_ATOM_MAPPING_KWARGS
    from timemachine_tpu.fe.atom_mapping import get_cores

    core = np.asarray(get_cores(ja, jb, **DEFAULT_ATOM_MAPPING_KWARGS)[0])
    n_hybrid = hosts["port"].conf.shape[0] + AtomMapMixin(mol_pair(EDGE[0])[1], mol_pair(EDGE[1])[1], core).get_num_atoms()
    for tag, mod in (("jax", jex), ("port", tex)):
        for leg in ("solvent", "complex"):
            monkeypatch.setattr(mod, f"run_{leg}", _leg_recorder(tag, calls, leg, hosts[tag], n_hybrid=n_hybrid))
    common = ["--n_frames", "3", "--ligands", str(sdf_path), "--mol_a_name", "ethanol", "--mol_b_name", "propane",
              "--protein", "host.pdb", "--n_eq_steps", "40", "--steps_per_frame", "9", "--seed", "2028", "--use_hrex",
              "--use_water_sampling", "--n_windows", "4"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        monkeypatch.setattr("sys.argv", ["relative_free_energy.py", *common, "--output_dir", str(tmp_path / "jax")])
        jex.read_from_args()
        j_out = capsys.readouterr().out
        tex.main([*common, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
        t_out = capsys.readouterr().out
    assert t_out == j_out and "solvent dG: " in t_out and "complex dG: " in t_out
    for leg in ("solvent", "complex"):
        j, t = calls["jax", leg], calls["port", leg]
        assert t["names"] == j["names"] and t["n_windows"] == j["n_windows"] and t["host"] == j["host"]
        np.testing.assert_array_equal(t["core"], j["core"])
        np.testing.assert_array_equal(t["core"], core)
        assert_fields_equal(t["md_params"], j["md_params"])
    j_files, t_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert list(t_files) == list(j_files) and len([n for n in t_files if n.endswith(".cif")]) == 6
    for name in t_files:
        assert t_files[name].read_bytes() == j_files[name].read_bytes(), name


def test_relative_free_energy_hif2a_path_raises_file_not_found(monkeypatch):
    from timemachine_torch.examples import relative_free_energy as tex

    jex = jax_example("relative_free_energy", monkeypatch)
    with pytest.raises(FileNotFoundError):
        jex.hif2a_pair()
    with pytest.raises(FileNotFoundError):
        tex.main([])
