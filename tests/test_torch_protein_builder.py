"""timemachine_torch/md/builders.py's protein and PDB builders against
timemachine_tpu/md/builders.py on the capped helix of
timemachine_torch/testsystems/peptide.py with ethanol and propane posed
beside it: the same solvated host (coordinates, box, water count, masses,
every index array, exclusions, groups and residue records exactly;
parameters within 1e-12), the same ILDN warning, the same host energy and
forces in float64 (1e-10 relative), the same shift of an uncentred PDB that
leaves the ligands where they were (ROADMAP R13), the host-config file and
permutation round trips, build_water_system_from_pdb, and the barostat's
move on a host whose protein is one large group (the port against JAX's move
fed the same uniforms, and the batched move against single moves).
"""

import warnings

import numpy as np
import pytest
import torch

from timemachine_torch.md import builders as tb
from timemachine_torch.testsystems import rbfe_solvent
from timemachine_torch.testsystems.peptide import capped_helix_pdb, pocket_offset
from timemachine_tpu.md import builders as jb

torch.set_num_threads(1)  # the suite's workers share the host's cores

TOL_PARAM = 1e-12
TOL_ENERGY_REL = 1e-10
TERMS = ("bond", "angle", "proper", "improper")
N_ALA = 4
BOX_MARGIN = 0.2


def _ligands(pdb_text, shift=None):
    """Ethanol and propane in both packages at the solvent cache's conformers
    (the JAX package's embedding at seed 7), posed 0.9 nm from the helix axis."""
    from timemachine_torch.chem import mol_from_smiles as t_smiles
    from timemachine_tpu.chem import mol_from_smiles as j_smiles

    meta = rbfe_solvent.metadata(rbfe_solvent.load_arrays())
    confs = (meta["conf_a"], meta["conf_b"])
    offset = pocket_offset(pdb_text, confs) if shift is None else shift
    out = []
    for from_smiles in (t_smiles, j_smiles):
        mols = [from_smiles(str(s), add_hs=True, name=str(n)) for s, n in zip(meta["smiles"], meta["names"])]
        for m, c in zip(mols, confs):
            m.set_conf(np.asarray(c) + offset)
        out.append(mols)
    return out


def _build_both(pdb_text, mols_t=None, mols_j=None, box_margin=BOX_MARGIN):
    out = []
    for build, mols in ((tb.build_protein_system, mols_t), (jb.build_protein_system, mols_j)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cfg = build(pdb_text, "amber99sbildn", "tip3p", mols=mols, box_margin=box_margin)
        out.append((cfg, [str(x.message) for x in w]))
    return out


@pytest.fixture(scope="module")
def helix():
    pdb = capped_helix_pdb(N_ALA)
    mols_t, mols_j = _ligands(pdb)
    (t, t_warn), (j, j_warn) = _build_both(pdb, mols_t, mols_j)
    return dict(pdb=pdb, port=t, jax=j, warnings=(t_warn, j_warn), mols=(mols_t, mols_j))


def test_coordinates_box_and_waters_equal(helix):
    t, j = helix["port"], helix["jax"]
    np.testing.assert_array_equal(t.conf, j.conf)
    np.testing.assert_array_equal(t.box, j.box)
    assert t.num_water_atoms == j.num_water_atoms and t.num_water_atoms % 3 == 0
    np.testing.assert_array_equal(t.masses, j.masses)
    n_p = t.conf.shape[0] - t.num_water_atoms
    assert n_p == 10 * N_ALA + 12


@pytest.mark.parametrize("term", TERMS)
def test_valence_terms_equal(helix, term):
    t, j = getattr(helix["port"].host_system, term), getattr(helix["jax"].host_system, term)
    a, b = np.asarray(t.potential.idxs), np.asarray(j.potential.idxs)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(t.params.numpy(), np.asarray(j.params), rtol=TOL_PARAM, atol=0)
    assert len(a) > 0


def test_nonbonded_term_equal(helix):
    t, j = helix["port"].host_system.nonbonded_all_pairs, helix["jax"].host_system.nonbonded_all_pairs
    np.testing.assert_array_equal(t.potential.exclusion_idxs, np.asarray(j.potential.exclusion_idxs))
    np.testing.assert_array_equal(t.potential.scale_factors, np.asarray(j.potential.scale_factors))
    assert (t.potential.num_atoms, t.potential.beta, t.potential.cutoff) == (
        j.potential.num_atoms, j.potential.beta, j.potential.cutoff
    )
    np.testing.assert_allclose(t.params.numpy(), np.asarray(j.params), rtol=TOL_PARAM, atol=0)
    n_p = helix["port"].conf.shape[0] - helix["port"].num_water_atoms
    q = t.params.numpy()[:, 0] / np.sqrt(tb.ONE_4PI_EPS0)
    assert abs(q[:n_p].sum()) < 1e-9 and abs(q[n_p:].sum()) < 1e-9  # the helix is neutral, as its graph says


def test_groups_and_residue_records_equal(helix):
    t, j = helix["port"].host_topology, helix["jax"].host_topology
    assert len(t.group_idxs) == len(j.group_idxs)
    for a, b in zip(t.group_idxs, j.group_idxs):
        np.testing.assert_array_equal(a, b)
    assert [(r.name, r.atomic_nums, r.bonds) for r in t.residues] == [(r.name, r.atomic_nums, r.bonds) for r in j.residues]
    sizes = sorted(len(g) for g in t.group_idxs)
    n_p = helix["port"].conf.shape[0] - helix["port"].num_water_atoms
    assert sizes[-1] == n_p and set(sizes[:-1]) == {3}  # the protein is one group, the waters 3-atom groups
    assert [r.name for r in t.residues][: N_ALA + 2] == ["ACE"] + ["ALA"] * N_ALA + ["NME"]


def test_the_port_records_bond_orders_and_charges(helix):
    """The port's record adds what env-BCC needs (ROADMAP R14): each
    protein residue's bond orders and the host's charges."""
    t = helix["port"]
    assert helix["jax"].host_topology.charges is None
    np.testing.assert_array_equal(t.host_topology.charges, t.host_system.nonbonded_all_pairs.params.numpy()[:, 0])
    ace = t.host_topology.residues[0]
    assert sorted(ace.bond_orders) == [1, 1, 1, 1, 2]  # CH3-C, 3 C-H, C=O
    assert t.host_topology.residues[-1].bond_orders is None  # a water


def test_ildn_warning_in_both(helix):
    for messages in helix["warnings"]:
        assert any("ILDN side-chain chi corrections" in m for m in messages)
        assert not any("NATIVE SMIRNOFF-host" in m for m in messages)


def test_host_energy_and_forces_match_jax(helix):
    """The host's float64 energy and forces through the port's potentials
    (the dense form, the CPU's) against JAX's value_and_grad of the same
    sum."""
    import jax

    from timemachine_torch.fe.system import HostSystem

    t, j = helix["port"], helix["jax"]
    sys_t = HostSystem.from_arrays(tb.host_config_arrays(t), device="cpu")
    x, box = torch.as_tensor(t.conf), torch.as_tensor(t.box)
    sys_t.nonbonded_all_pairs.configure(box, x, kernel="dense")
    u_t, f_t = 0.0, torch.zeros_like(x)
    for pot in sys_t.get_U_fns():
        u, f = pot.energy_force(x, box)
        u_t, f_t = u_t + float(u), f_t + f
    hs = j.host_system

    def total_u(xx):
        return sum(bp.potential(xx, bp.params, j.box) for bp in hs.get_U_fns())

    u_j, g_j = jax.value_and_grad(total_u)(j.conf)
    assert u_t == pytest.approx(float(u_j), rel=TOL_ENERGY_REL)
    diff = np.linalg.norm(f_t.numpy() + np.asarray(g_j)) / np.linalg.norm(np.asarray(g_j))
    assert diff < TOL_ENERGY_REL


def test_uncentred_pdb_shifts_the_protein_but_not_the_ligands():
    """ROADMAP R13, in both packages: a PDB 1 nm off the box centre, the
    ligands posed beside it, moves the protein by `shift` and carves the
    lattice around the ligands moved by `shift`, while the ligands
    themselves stay put: waters clash with the ligands where run_complex
    places them, 1 nm from their pocket."""
    from scipy.spatial import cKDTree

    from timemachine_torch.chem.pdb import parse_pdb, protein_mol_from_pdb

    centred = capped_helix_pdb(N_ALA)
    lines = []
    for line in centred.splitlines():
        if line.startswith("ATOM"):
            line = f"{line[:30]}{float(line[30:38]) + 10.0:8.3f}{line[38:]}"
        lines.append(line)
    moved = "\n".join(lines) + "\n"
    mols_t, mols_j = _ligands(moved)
    before = [m.get_conf().copy() for m in mols_t]
    (t, _), (j, _) = _build_both(moved, mols_t, mols_j, box_margin=0.0)
    np.testing.assert_array_equal(t.conf, j.conf)
    n_p = t.conf.shape[0] - t.num_water_atoms
    protein = protein_mol_from_pdb(parse_pdb(moved)).get_conf()
    shift = t.conf[:n_p] - protein
    np.testing.assert_allclose(shift, shift[0][None, :].repeat(n_p, 0), atol=1e-12)
    assert shift[0][0] == pytest.approx(-1.0, abs=2e-3) and np.abs(shift[0][1:]).max() < 2e-3
    for m, x in zip(mols_t, before):
        np.testing.assert_array_equal(m.get_conf(), x)
    lig = np.concatenate(before)
    side = np.diagonal(t.box)
    waters = cKDTree(np.mod(t.conf[n_p:], side), boxsize=side)  # minimum image
    assert waters.query(np.mod(lig + shift[0], side))[0].min() > 0.24  # the cavity is carved at the shifted pose
    assert waters.query(np.mod(lig, side))[0].min() < 0.24  # the unshifted ligands clash with the lattice


def test_centred_helix_has_a_zero_shift():
    """The generator's helix at box_margin 0: the builder moves it by less
    than the PDB's rounding."""
    from timemachine_torch.chem.pdb import parse_pdb, protein_mol_from_pdb

    pdb = capped_helix_pdb(N_ALA)
    cfg = tb.build_protein_system(pdb, "amber99sb", "tip3p")
    n_p = cfg.conf.shape[0] - cfg.num_water_atoms
    assert np.abs(cfg.conf[:n_p] - protein_mol_from_pdb(parse_pdb(pdb)).get_conf()).max() < 1e-3


def test_save_and_load_host_config_round_trip_with_jax(helix, tmp_path):
    t, j = helix["port"], helix["jax"]
    tb.save_host_config(t, str(tmp_path / "port.npz"))
    jb.save_host_config(j, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as zt, np.load(tmp_path / "jax.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zt.files:
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    for loaded, ref in ((tb.load_host_config(str(tmp_path / "jax.npz")), j), (jb.load_host_config(str(tmp_path / "port.npz")), t)):
        np.testing.assert_array_equal(loaded.conf, ref.conf)
        for term in TERMS:
            np.testing.assert_array_equal(np.asarray(getattr(loaded.host_system, term).potential.idxs),
                                          np.asarray(getattr(ref.host_system, term).potential.idxs))
    loaded = tb.load_host_config(str(tmp_path / "jax.npz"))
    assert loaded.host_topology.residues == []
    for a, b in zip(loaded.host_topology.group_idxs, j.host_topology.group_idxs):
        np.testing.assert_array_equal(a, b)
    assert tb.load_host_config(str(tmp_path / "missing.npz")) is None


def test_permute_host_config_atoms_matches_jax(helix):
    """Waters first, as the apo benchmark orders DHFR."""
    t, j = helix["port"], helix["jax"]
    n = t.conf.shape[0]
    n_p = n - t.num_water_atoms
    perm = np.concatenate([np.arange(n_p, n), np.arange(n_p)])
    pt, pj = tb.permute_host_config_atoms(t, perm), jb.permute_host_config_atoms(j, perm)
    np.testing.assert_array_equal(pt.conf, pj.conf)
    np.testing.assert_array_equal(pt.masses, pj.masses)
    for term in TERMS:
        np.testing.assert_array_equal(getattr(pt.host_system, term).potential.idxs, getattr(pj.host_system, term).potential.idxs)
        np.testing.assert_array_equal(getattr(pt.host_system, term).params.numpy(), np.asarray(getattr(pj.host_system, term).params))
    nt, nj = pt.host_system.nonbonded_all_pairs, pj.host_system.nonbonded_all_pairs
    np.testing.assert_array_equal(nt.potential.exclusion_idxs, nj.potential.exclusion_idxs)
    np.testing.assert_array_equal(nt.params.numpy(), np.asarray(nj.params))
    for a, b in zip(pt.host_topology.group_idxs, pj.host_topology.group_idxs):
        np.testing.assert_array_equal(a, b)
    # the charges stay in the old atom order nowhere: the permuted record has none, as JAX's, and env-BCC refuses it
    assert t.host_topology.charges is not None
    assert pt.host_topology.charges is None and pj.host_topology.charges is None
    from timemachine_torch.ff.envbcc import EnvironmentBCCHandler

    with pytest.raises(ValueError, match="host's charges"):
        EnvironmentBCCHandler(["[#6:1]-[#1:2]"], [0.01], "amber99sbildn", "tip3p", pt.host_topology).parameterize([0.01])


def _water_pdb(cfg) -> str:
    lines = [f"CRYST1{10 * cfg.box[0, 0]:9.3f}{10 * cfg.box[1, 1]:9.3f}{10 * cfg.box[2, 2]:9.3f}  90.00  90.00  90.00 P 1           1"]
    for w in range(cfg.conf.shape[0] // 3):
        for k, (name, el) in enumerate((("O", "O"), ("H1", "H"), ("H2", "H"))):
            x, y, z = 10 * cfg.conf[3 * w + k]
            lines.append(f"HETATM{3 * w + k + 1:5d}  {name:<3} HOH W{w + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           {el}")
    return "\n".join(lines) + "\nEND\n"


def test_build_water_system_from_pdb_matches_jax():
    text = _water_pdb(tb.build_water_system(1.6))
    t, j = tb.build_water_system_from_pdb(text), jb.build_water_system_from_pdb(text)
    np.testing.assert_array_equal(t.conf, j.conf)
    np.testing.assert_array_equal(t.box, j.box)
    assert t.num_water_atoms == j.num_water_atoms == t.conf.shape[0]
    np.testing.assert_array_equal(t.masses, j.masses)
    np.testing.assert_array_equal(t.host_system.nonbonded_all_pairs.params.numpy(), np.asarray(j.host_system.nonbonded_all_pairs.params))
    for term in ("bond", "angle"):
        np.testing.assert_array_equal(getattr(t.host_system, term).potential.idxs, getattr(j.host_system, term).potential.idxs)


def test_barostat_with_one_large_group_matches_jax(helix):
    """The port's move against JAX's on the helix host (one protein group
    of 52 atoms among the 3-atom waters), fed the uniforms JAX draws: the
    same acceptances, coordinates and box (f64, 1e-12); the protein moves
    rigidly by its centroid's displacement."""
    import jax
    import jax.numpy as jnp

    from timemachine_torch.md.barostat import MonteCarloBarostat
    from timemachine_tpu.md import barostat as jbaro

    cfg = helix["port"]
    n = cfg.conf.shape[0]
    groups = cfg.host_topology.group_idxs
    protein = max(groups, key=len)
    kw = dict(num_atoms=n, pressure=1.013, temperature=300.0, group_idxs=groups, interval=25)
    j_move = jbaro.MonteCarloBarostat(**kw).make_move_fn(lambda x, box: 0.4 * jnp.sum(x**2))
    baro = MonteCarloBarostat(**kw)
    t_move = baro.make_move_with_uniforms(lambda x, box: 0.4 * torch.sum(x**2), device="cpu")
    j_state, t_state = jbaro.MonteCarloBarostat(**kw).init_state(), baro.init_state("cpu", torch.float64)
    jx, jbox = jnp.asarray(cfg.conf), jnp.asarray(cfg.box)
    tx, tbox = torch.as_tensor(cfg.conf), torch.as_tensor(cfg.box)
    accepted = 0
    for i in range(20):
        key = jax.random.fold_in(jax.random.key(19), i)
        k1, k2 = jax.random.split(key)
        u_dv, u_acc = (float(jax.random.uniform(k, dtype=jnp.float64)) for k in (k1, k2))
        x_before = tx
        j_state, jx, _, jbox = j_move(j_state, jx, jx, jbox, key)
        t_state, tx, _, tbox = t_move(t_state, tx, tx, tbox, u_dv, u_acc)
        assert int(t_state.total_accepted) == int(j_state.total_accepted)
        if int(t_state.total_accepted) > accepted:
            d = (tx - x_before).numpy()[protein]
            np.testing.assert_allclose(d, d[:1].repeat(len(protein), 0), atol=1e-12)  # rigid
        accepted = int(t_state.total_accepted)
    assert 0 < accepted < 20
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=1e-12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)


def test_batched_barostat_with_one_large_group_matches_single_moves(helix):
    """BatchedContext's barostat form: K = 3 replicas of the helix host,
    each at its own coordinates and box, moved at once, equal to three
    single moves fed the same uniforms."""
    from timemachine_torch.md.barostat import MonteCarloBarostat

    cfg = helix["port"]
    n = cfg.conf.shape[0]
    baro = MonteCarloBarostat(n, 1.013, 300.0, cfg.host_topology.group_idxs, 25)
    move = baro.make_move_with_uniforms(lambda x, box: 0.4 * torch.sum(x**2, dim=(-2, -1)), device="cpu")
    rng = np.random.default_rng(2024)
    xs = torch.as_tensor(cfg.conf[None] + rng.normal(0, 0.01, (3, n, 3)))
    boxes = torch.as_tensor(cfg.box[None] * np.array([1.0, 1.01, 0.99])[:, None, None])
    state = baro.init_state("cpu", torch.float64, shape=(3,))
    singles = [baro.init_state("cpu", torch.float64) for _ in range(3)]
    xs_single, boxes_single = list(xs), list(boxes)
    for step in range(12):
        u = torch.as_tensor(rng.uniform(size=(3, 2)))
        state, xs, _, boxes = move(state, xs, xs, boxes, u[:, 0], u[:, 1])
        for k in range(3):
            singles[k], xs_single[k], _, boxes_single[k] = move(singles[k], xs_single[k], xs_single[k], boxes_single[k], u[k, 0], u[k, 1])
    for k in range(3):
        assert int(state.total_accepted[k]) == int(singles[k].total_accepted)
        torch.testing.assert_close(xs[k], xs_single[k], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(boxes[k], boxes_single[k], rtol=1e-12, atol=1e-12)
    assert 0 < int(state.total_accepted.sum()) < 36
