"""The port's last leaf modules against timemachine_tpu's, on the CPU:
fe/restraints.py (the core of tests/test_fe_misc.py's case exactly),
fe/standard_state.py (tests/test_standard_state.py's cases within 1e-12
relative), testsystems/gaussian1d.py (u_kln bitwise), testsystems/ligands.py
(torsions equal, conformers within LIGAND_TOL nm: each package relaxes its
embedding by its own FIRE, JAX's under jit with FMAs contracted, and the two
drift apart by 4.6e-10 nm on biphenyl's two rings and 8.2e-11 nm on
triphenyl's, measured on an x86-64 CPU; tests/test_torch_embed.py holds
the embedder on smaller molecules to 1e-10), fixed_point.py (bitwise),
fe/cif_writer.py and fe/dummy_draw.py (file and SVG text identical),
ff/compare_forcefields.py (the same verdict and lines on a panel of the
shipped force fields), ff/make_placeholder_ff.py (the serialization JAX's
writes, the shipped placeholder_ff.json), ff/params (the same files), and
testsystems/relative.py, utils.py and data.py, which raise the same
FileNotFoundError without the public data (ROADMAP R1).
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite's workers share the host's cores

REL_TOL = 1e-12
LIGAND_TOL = 1e-9  # nm


def _mol_pair(smiles, seed=7):
    """(JAX's mol embedded with seed, the port's mol of the same SMILES at JAX's conformer)."""
    from timemachine_torch.chem import mol_from_smiles as t_mol
    from timemachine_tpu.chem import mol_from_smiles as j_mol
    from timemachine_tpu.chem.embed import embed_mol

    j = j_mol(smiles, add_hs=True)
    embed_mol(j, seed=seed)
    t = t_mol(smiles, add_hs=True)
    assert [a.atomic_num for a in t.atoms] == [a.atomic_num for a in j.atoms]
    t.set_conf(j.get_conf())
    return j, t


def test_restraint_core_from_smarts_matches_jax():
    from timemachine_torch.fe.restraints import setup_relative_restraints_using_smarts as t_setup
    from timemachine_tpu.fe.restraints import setup_relative_restraints_using_smarts as j_setup

    ja, ta = _mol_pair("c1ccccc1CC")
    jb, tb = _mol_pair("c1ccccc1CO")
    for smarts in ("c1ccccc1", "c1ccccc1[CH2]"):
        t_core = t_setup(ta, tb, smarts)
        np.testing.assert_array_equal(t_core, j_setup(ja, jb, smarts))
        assert t_core.dtype == np.int32 and t_core.shape[1] == 2
    for setup, m in ((t_setup, ta), (j_setup, ja)):
        with pytest.raises(AssertionError):
            setup(m, m, "[#6].[#6]")


def test_standard_state_matches_jax():
    from timemachine_torch.fe import standard_state as ts
    from timemachine_tpu.fe import standard_state as js

    beta = 1.0 / 2.479
    for k in (100.0, 1000.0, 10000.0):
        for fn in ("integrate_radial_Z_exact",):
            assert getattr(ts, fn)(k, beta) == pytest.approx(getattr(js, fn)(k, beta), rel=REL_TOL)
        t = ts.integrate_radial_Z(lambda r: k * r * r, beta, r_max=np.inf)
        assert t == pytest.approx(js.integrate_radial_Z(lambda r: k * r * r, beta, r_max=np.inf), rel=REL_TOL)
    for k_r in (1e-9, 50.0, 500.0, 1e4):
        t = ts.integrate_rotation_Z(lambda th: ts.angle_u(th, k_r), beta)
        assert t == pytest.approx(js.integrate_rotation_Z(lambda th: js.angle_u(th, k_r), beta), rel=REL_TOL)
    for k_t, k_r in ((5000.0, 50.0), (50000.0, 500.0)):
        t = ts.release_orientational_restraints(k_t, k_r, beta)
        j = js.release_orientational_restraints(k_t, k_r, beta)
        np.testing.assert_allclose(t, j, rtol=REL_TOL, atol=0)
    assert ts.standard_state_correction(3.0, beta) == pytest.approx(js.standard_state_correction(3.0, beta), rel=REL_TOL)
    assert ts.STANDARD_VOLUME == js.STANDARD_VOLUME


def test_gaussian1d_is_bitwise_jax():
    from timemachine_torch.testsystems import gaussian1d as tg
    from timemachine_tpu.testsystems import gaussian1d as jg

    t_u, t_df = tg.make_gaussian_ukln(np.linspace(0.0, 1.0, 5), n_samples=300, seed=3, mu1=2.0)
    j_u, j_df = jg.make_gaussian_ukln(np.linspace(0.0, 1.0, 5), n_samples=300, seed=3, mu1=2.0)
    np.testing.assert_array_equal(t_u, j_u)
    np.testing.assert_array_equal(t_df, j_df)
    t_fns, j_fns = tg.make_gaussian_testsystem(), jg.make_gaussian_testsystem()
    np.testing.assert_array_equal(t_fns[1](0.3, 10, 4), j_fns[1](0.3, 10, 4))
    assert t_fns[2](0.0, 1.0) == j_fns[2](0.0, 1.0)


def test_ligands_match_jax():
    from timemachine_torch.testsystems import ligands as tl
    from timemachine_tpu.testsystems import ligands as jl

    for name in ("get_biphenyl", "get_triphenyl"):
        t_mol, t_tors = getattr(tl, name)()
        j_mol, j_tors = getattr(jl, name)()
        np.testing.assert_array_equal(t_tors, j_tors)
        np.testing.assert_allclose(t_mol.get_conf(), j_mol.get_conf(), rtol=0, atol=LIGAND_TOL)


def test_fixed_point_is_bitwise_jax():
    from timemachine_torch import fixed_point as tf
    from timemachine_tpu import fixed_point as jf

    values = np.array([0.0, 1.0, -1.0, 1e-11, -3.25, 123456.789, -2.0**26, np.pi])
    t_fixed, j_fixed = tf.float_to_fixed(values), jf.float_to_fixed(values)
    assert t_fixed.dtype == j_fixed.dtype == np.uint64
    np.testing.assert_array_equal(t_fixed, j_fixed)
    np.testing.assert_array_equal(tf.fixed_to_float(t_fixed), jf.fixed_to_float(j_fixed))
    assert tf.FIXED_EXPONENT == jf.FIXED_EXPONENT == 2**36


def test_cif_writer_text_equals_jax(tmp_path):
    from timemachine_torch.fe import cif_writer as tcw
    from timemachine_tpu.fe import cif_writer as jcw

    j_mol, t_mol = _mol_pair("c1ccccc1O")
    host = SimpleNamespace(residues=[SimpleNamespace(name="HOH", atomic_nums=[8, 1, 1]),
                                     SimpleNamespace(name="ALA", atomic_nums=[7, 1, 6, 6, 8])] * 2)
    n = 16 + t_mol.num_atoms
    frames = np.random.default_rng(2).uniform(0, 30, size=(3, n, 3))
    for mod, mol, name in ((tcw, t_mol, "port"), (jcw, j_mol, "jax")):
        with mod.CIFWriter([host, mol], str(tmp_path / f"{name}.cif")) as writer:
            for x in frames:
                writer.write_frame(x)
        with pytest.raises(ValueError):
            mod.CIFWriter([object()], str(tmp_path / "bad.cif"))
    assert (tmp_path / "port.cif").read_text() == (tmp_path / "jax.cif").read_text()
    with pytest.raises(AssertionError):
        with tcw.CIFWriter([t_mol], str(tmp_path / "short.cif")) as writer:
            writer.write_frame(np.zeros((t_mol.num_atoms + 1, 3)))
    atom_map = SimpleNamespace(mol_a=SimpleNamespace(num_atoms=3), mol_b=SimpleNamespace(num_atoms=2),
                               a_to_c=[0, 2, 3], b_to_c=[1, 3])
    frame = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(tcw.convert_single_topology_mols(frame, atom_map),
                                  jcw.convert_single_topology_mols(frame, atom_map))


@pytest.mark.parametrize("color_blind", [False, True])
def test_dummy_draw_svg_equals_jax(color_blind):
    from timemachine_torch.fe.dummy_draw import draw_dummy_core_ixns as t_draw
    from timemachine_tpu.fe.dummy_draw import draw_dummy_core_ixns as j_draw

    j_mol, t_mol = _mol_pair("c1ccccc1CC")
    bonds = [(5, 6), (4, 5, 6), (3, 4, 5, 6), (6, 7), (0, 1, 5, 4)]
    core, dummy = np.arange(6), [6, 7]
    t_svg = t_draw(t_mol, core, bonds, dummy, color_blind=color_blind)
    assert t_svg == j_draw(j_mol, core, bonds, dummy, color_blind=color_blind)
    assert t_svg.startswith("<svg") and t_svg.count("</text>") > len(bonds)


def _ff_panel():
    from timemachine_torch.ff.serialize import builtin_params_dir

    d = builtin_params_dir()
    return [(d / a, d / b) for a, b in (
        ("smirnoff_2_0_0_ccc.json", "smirnoff_2_0_0_ccc.json"),
        ("smirnoff_1_1_0_ccc.json", "smirnoff_2_0_0_ccc.json"),
        ("smirnoff_2_0_0_ccc.json", "smirnoff_2_0_0_am1bcc.json"),
        ("placeholder_ff.json", "smirnoff_1_1_0_sc.json"),
    )]


@pytest.mark.parametrize("pair", range(4))
def test_compare_forcefields_matches_jax(pair):
    from timemachine_torch.ff import compare_forcefields as tc
    from timemachine_tpu.ff import compare_forcefields as jc

    a, b = _ff_panel()[pair]
    t_lines, j_lines = [], []
    t_same = tc.compare_forcefields(tc._load(str(a)), tc._load(str(b)), out=t_lines.append)
    j_same = jc.compare_forcefields(jc._load(str(a)), jc._load(str(b)), out=j_lines.append)
    assert t_same == j_same == (pair == 0)
    assert t_lines == j_lines
    assert tc._load(a.stem) == jc._load(a.stem)  # a built-in name resolves to the shipped file


def test_compare_forcefields_main_exit_codes(monkeypatch, capsys):
    from timemachine_torch.ff import compare_forcefields as tc

    for args, code in ((["smirnoff_2_0_0_ccc", "smirnoff_2_0_0_ccc"], 0), (["smirnoff_1_1_0_ccc", "smirnoff_2_0_0_ccc"], 2),
                       (["no_such_ff", "smirnoff_2_0_0_ccc"], 1)):
        monkeypatch.setattr(sys, "argv", ["compare_forcefields", *args])
        with pytest.raises(SystemExit) as e:
            tc.main()
        assert e.value.code == code
    assert "identical" in capsys.readouterr().out


def test_placeholder_ff_serializes_as_jax(tmp_path):
    from timemachine_torch.ff import make_placeholder_ff as tm
    from timemachine_torch.ff.params import AMBER99SB_XML, PARAMS_DIR
    from timemachine_tpu.ff import make_placeholder_ff as jm
    from timemachine_tpu.ff.handlers import LennardJonesSolventHandler, SimpleChargeSolventHandler
    from timemachine_tpu.ff.serialize import serialize_handlers

    ff = jm.build_placeholder_ff()
    extra = [SimpleChargeSolventHandler(smirks=["[*:1]"], params=np.zeros(1), props=None),
             LennardJonesSolventHandler(smirks=["[*:1]"], params=np.array([[0.1, 1.0]]), props=None)]
    handlers = [ff.hb_handle, ff.ha_handle, ff.pt_handle, ff.it_handle, ff.q_handle, ff.q_handle_intra, ff.lj_handle,
                ff.lj_handle_intra, *extra]
    j_text = serialize_handlers(handlers, ff.protein_ff, ff.water_ff, fmt="json")
    assert tm.serialize_placeholder_ff() == j_text == (PARAMS_DIR / "placeholder_ff.json").read_text()
    tm.main(["--out", str(tmp_path / "placeholder.json")])
    assert (tmp_path / "placeholder.json").read_text() == j_text
    t_ff = tm.build_placeholder_ff()
    assert t_ff.protein_ff == ff.protein_ff and t_ff.water_ff == ff.water_ff
    np.testing.assert_array_equal(np.asarray(t_ff.hb_handle.params), np.asarray(ff.hb_handle.params))
    assert AMBER99SB_XML.read_bytes() == (PARAMS_DIR / "amber99sb.xml").read_bytes() and AMBER99SB_XML.exists()


def test_public_data_modules_raise_as_jax(monkeypatch):
    from timemachine_torch.testsystems import data as td
    from timemachine_torch.testsystems import relative as tr
    from timemachine_torch.testsystems import utils as tu
    from timemachine_tpu.testsystems import data as jd
    from timemachine_tpu.testsystems import relative as jr
    from timemachine_tpu.testsystems import utils as ju

    monkeypatch.delenv("TIMEMACHINE_TORCH_DATA", raising=False)
    monkeypatch.delenv("TIMEMACHINE_TPU_DATA", raising=False)
    try:
        jd.data_dir()
    except FileNotFoundError:
        pass
    else:
        pytest.skip("the public data directory is present: nothing to hold the absent case to")
    calls = [
        (tr.get_hif2a_ligand_pair_single_topology, jr.get_hif2a_ligand_pair_single_topology, ()),
        (tr.get_hif2a_ligand_pair, jr.get_hif2a_ligand_pair, (1, 4)),
        (tu.fetch_freesolv, ju.fetch_freesolv, (3,)),
        (td.path_to_data, jd.path_to_data, ("freesolv", "freesolv.sdf")),
    ]
    for t_fn, j_fn, args in calls:
        with pytest.raises(FileNotFoundError):
            j_fn(*args)
        with pytest.raises(FileNotFoundError):
            t_fn(*args)


def test_data_dir_follows_the_environment(tmp_path, monkeypatch):
    from timemachine_torch.testsystems import data as td

    (tmp_path / "freesolv").mkdir()
    (tmp_path / "freesolv" / "freesolv.sdf").write_text("")
    monkeypatch.delenv("TIMEMACHINE_TORCH_DATA", raising=False)
    monkeypatch.setenv("TIMEMACHINE_TPU_DATA", str(tmp_path))
    assert td.path_to_data("freesolv", "freesolv.sdf") == tmp_path / "freesolv" / "freesolv.sdf"
    monkeypatch.setenv("TIMEMACHINE_TORCH_DATA", str(tmp_path / "freesolv"))
    assert td.data_dir() == tmp_path / "freesolv"
    with pytest.raises(FileNotFoundError):
        td.path_to_data("no_such_file")
