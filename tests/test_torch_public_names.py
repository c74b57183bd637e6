"""The last public names of the JAX package at its paths in the port, each
held against JAX's function on the same inputs (numpy, from a seed) in
float64 on the CPU: plain math to 1e-12 relative, the ligand-environment
prefactor energies to 1e-10 over 3 frames of a 30-atom ligand in a 500-atom
environment with and without a box, index and string results exactly (the
SVG and HTML byte for byte on ethanol -> propane's core and on biphenyl),
minimize_scipy's BFGS minimum to 1e-8 nm, simulate_system and
integrators.sample_velocities fed JAX's own draws to 1e-10 nm and 1e-15,
warnings and exceptions with JAX's types and texts.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_chem import EDGE, mol_pair
from timemachine_torch import constants as tconst
from timemachine_torch import graph_utils as tgu
from timemachine_torch import potentials as tpot
from timemachine_torch import utils as tutils
from timemachine_torch.fe import system as tsys
from timemachine_torch.fe import utils as tfu
from timemachine_torch.md import utils as tmdu
from timemachine_torch.ops import nonbonded as tnb
from timemachine_torch.ops import pbc as tpbc
from timemachine_tpu import constants as jconst
from timemachine_tpu import graph_utils as jgu
from timemachine_tpu import potentials as jpot
from timemachine_tpu import utils as jutils
from timemachine_tpu.fe import system as jsys
from timemachine_tpu.fe import utils as jfu
from timemachine_tpu.md import utils as jmdu
from timemachine_tpu.ops import nonbonded as jnb
from timemachine_tpu.ops import pbc as jpbc

torch.set_num_threads(1)  # the suite's workers share the host's cores

REL = 1e-12
PREFACTOR_REL = 1e-10
BIPHENYL = "Fc1cccc(F)c1-c1ccccc1F"  # testsystems/ligands.py get_biphenyl's


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel=REL):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref[np.isfinite(ref)]).max(initial=0.0), np.finfo(np.float64).tiny)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert np.all(np.abs(got[fin] - ref[fin]) <= rel * scale)


@pytest.fixture(scope="module")
def edge():
    (ja, ta), (jb, tb) = mol_pair(EDGE[0], "ethanol"), mol_pair(EDGE[1], "propane")
    from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
    from timemachine_tpu.fe.atom_mapping import get_cores

    core = np.asarray(get_cores(ja, jb, **DEFAULT_ATOM_MAPPING_KWARGS)[0])
    return (ja, jb), (ta, tb), core


@pytest.fixture(scope="module")
def biphenyl():
    """Both packages' molecule of get_biphenyl's SMILES, without hydrogens
    as get_biphenyl builds it, at one conformer made from a seed (the
    drawings read only its coordinates)."""
    from timemachine_torch.chem import mol_from_smiles as t_smiles
    from timemachine_tpu.chem import mol_from_smiles as j_smiles

    jm, tm = j_smiles(BIPHENYL), t_smiles(BIPHENYL)
    conf = np.random.default_rng(15).uniform(-0.5, 0.5, (jm.num_atoms, 3))
    jm.set_conf(conf)
    tm.set_conf(conf.copy())
    return jm, tm


# -- constants.py ----------------------------------------------------------------


@pytest.mark.parametrize(
    "name",
    ["VIBRATIONAL_CONSTANT", "DEFAULT_KT", "BAR_TO_KJ_PER_NM3", "KCAL_TO_DEFAULT_KT", "DEFAULT_DT",
     "DEFAULT_FRICTION", "DEFAULT_BAROSTAT_INTERVAL", "DEFAULT_HMR_SCALE"],
)
def test_constants_equal_jax(name):
    assert getattr(tconst, name) == getattr(jconst, name)
    assert type(getattr(tconst, name)) is type(getattr(jconst, name))


# -- potentials.py ---------------------------------------------------------------


def _vacuum_terms(pkg_topology, ff, mol):
    bt = pkg_topology.BaseTopology(mol, ff)
    hb_p, hb = bt.parameterize_harmonic_bond(ff.hb_handle.params)
    ha_p, ha = bt.parameterize_harmonic_angle(ff.ha_handle.params)
    pt_p, pt = bt.parameterize_proper_torsion(ff.pt_handle.params)
    return [hb.bind(hb_p), ha.bind(ha_p), pt.bind(pt_p)]


@pytest.fixture(scope="module")
def ethanol_terms(edge):
    from timemachine_torch.fe import topology as ttop
    from timemachine_torch.ff import Forcefield as TF
    from timemachine_tpu.fe import topology as jtop
    from timemachine_tpu.ff import Forcefield as JF

    (ja, _), (ta, _), _ = edge
    return _vacuum_terms(jtop, JF.load_default(), ja), _vacuum_terms(ttop, TF.load_default(), ta), ja.get_conf()


def test_builder_classes_are_the_potentials_names():
    from timemachine_torch.fe import terms

    for name in ("BoundPotential", "Potential", "SummedPotential", "make_summed_potential"):
        assert getattr(tpot, name) is getattr(terms, name)
    assert isinstance(terms.HarmonicBond(np.zeros((0, 2), np.int32)), tpot.Potential)
    bp = terms.HarmonicBond(np.zeros((0, 2), np.int32)).bind(np.zeros((0, 2)))
    assert isinstance(bp, tpot.BoundPotential)
    assert tpot.Conf is torch.Tensor and tpot.Params is torch.Tensor


def test_sum_potential_energies_and_lookups_match_jax(ethanol_terms):
    jbps, tbps, x = ethanol_terms
    from timemachine_torch.fe import terms
    from timemachine_tpu.potentials import HarmonicAngle as JHA

    ju = float(jpot.sum_potential_energies(jbps, jnp.asarray(x), None))
    tu = float(tpot.sum_potential_energies(tbps, _t(x), None))
    assert abs(tu - ju) <= REL * abs(ju)
    assert tpot.get_bound_potential_by_type(tbps, terms.HarmonicAngle) is tbps[1]
    assert jpot.get_bound_potential_by_type(jbps, JHA) is jbps[1]
    assert tpot.get_potential_by_type([bp.potential for bp in tbps], terms.PeriodicTorsion) is tbps[2].potential
    for lookup, pots in ((tpot.get_bound_potential_by_type, tbps), (tpot.get_potential_by_type, [])):
        with pytest.raises(ValueError) as t_err:
            lookup(pots, terms.ChiralAtomRestraint)
        with pytest.raises(ValueError) as j_err:
            getattr(jpot, lookup.__name__)([], jpot.ChiralAtomRestraint)
        assert str(t_err.value).split(":")[0] == str(j_err.value).split(":")[0]
    shapes = [tuple(np.shape(bp.params)) for bp in tbps]
    flat = np.concatenate([np.ravel(_np(bp.params)) for bp in tbps])
    for got, ref in zip(tpot.unflatten_params(_t(flat), shapes), jpot.unflatten_params(jnp.asarray(flat), shapes)):
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


# -- graph_utils.py, utils.py, md/utils.py -----------------------------------------


def test_graph_helpers_match_jax(edge, biphenyl):
    (ja, _), (ta, _), _ = edge
    for jm, tm in ((ja, ta), biphenyl):
        adj_j, adj_t = jgu.mol_adjacency(jm), tgu.mol_adjacency(tm)
        assert adj_t == adj_j
        bonds = [(b.src, b.dst) for b in jm.bonds]
        assert tgu.adjacency_from_bonds(jm.num_atoms, bonds) == jgu.adjacency_from_bonds(jm.num_atoms, bonds)
        for n in (2, 3, 4):
            assert tgu.simple_paths(adj_t, n) == jgu.simple_paths(adj_j, n)
            assert tgu.simple_paths_from(adj_t, 0, n) == jgu.simple_paths_from(adj_j, 0, n)
        assert tgu.connected_component(adj_t, 1) == jgu.connected_component(adj_j, 1)


def test_small_utilities_match_jax():
    rng = np.random.default_rng(2021)
    xs = list(rng.normal(size=(5, 3)))
    args = (lambda x: x**2, lambda a, b: a * 0.5 + b)
    np.testing.assert_array_equal(tutils.pairwise_transform_and_combine(xs, *args),
                                  jutils.pairwise_transform_and_combine(xs, *args))
    box = np.diag(rng.uniform(2.0, 4.0, 3))
    assert tmdu.compute_box_volume(box) == jmdu.compute_box_volume(box)
    np.testing.assert_array_equal(tmdu.compute_box_center(box), jmdu.compute_box_center(box))
    with pytest.raises(AssertionError):
        jmdu.compute_box_center(box + 0.1)
    with pytest.raises(AssertionError):
        tmdu.compute_box_center(box + 0.1)
    coords = rng.normal(size=(9, 3))
    groups = [np.arange(0, 3), np.arange(3, 9)]
    for got, ref in zip(tmdu.compute_intramolecular_distances(coords, groups),
                        jmdu.compute_intramolecular_distances(coords, groups)):
        _close(got, ref)


def test_barostat_package_exports_jax_lists():
    import timemachine_torch.md.barostat as tbaro
    import timemachine_torch.md.barostat.moves as tmoves
    import timemachine_torch.md.barostat.utils as tbu
    import timemachine_tpu.md.barostat.moves as jmoves
    import timemachine_tpu.md.barostat.utils as jbu
    from timemachine_torch.md.moves import NPTMove

    assert tmoves.__all__ == jmoves.__all__ and tbu.__all__ == jbu.__all__
    assert tmoves.MonteCarloBarostat is tbaro.MonteCarloBarostat and tmoves.NPTMove is NPTMove
    assert tbu.compute_box_volume is tmdu.compute_box_volume and tbu.get_group_indices is tmdu.get_group_indices


# -- ops/pbc.py and ops/nonbonded.py -----------------------------------------------


@pytest.mark.parametrize("with_box", (False, True))
@pytest.mark.parametrize("with_w", (False, True))
def test_pairwise_distance_matrix_matches_jax(with_box, with_w):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 2.0, (40, 3))
    x[5] = x[4]  # a coincident pair
    box = np.diag([2.0, 2.1, 2.2]) if with_box else None
    w = rng.uniform(-0.3, 0.3, 40) if with_w else None
    ref = jpbc.pairwise_distance_matrix(jnp.asarray(x), None if box is None else jnp.asarray(box),
                                        None if w is None else jnp.asarray(w))
    got = tpbc.pairwise_distance_matrix(_t(x), None if box is None else _t(box), None if w is None else _t(w))
    _close(got, ref)


@pytest.mark.parametrize("cutoff", (np.inf, 0.8))
def test_distances_from_point_and_index_helpers_match_jax(cutoff):
    rng = np.random.default_rng(8)
    x = rng.uniform(0.0, 2.0, (50, 3))
    box = np.eye(3) * 2.0
    _close(tpbc.distances_from_point(_t(x[0]), _t(x), _t(box), cutoff),
           jpbc.distances_from_point(jnp.asarray(x[0]), jnp.asarray(x), jnp.asarray(box), cutoff))
    np.testing.assert_array_equal(tpbc.all_pairs_idxs(7), jpbc.all_pairs_idxs(7))
    np.testing.assert_array_equal(tpbc.interaction_group_idxs([3, 1], [0, 2, 5]),
                                  jpbc.interaction_group_idxs([3, 1], [0, 2, 5]))


def test_nonbonded_host_helpers_match_jax():
    rng = np.random.default_rng(9)
    d = rng.uniform(0.1, 1.2, 100)
    q = rng.normal(size=100)
    _close(tnb.direct_space_pme(_t(d), _t(q), 2.0), jnb.direct_space_pme(jnp.asarray(d), jnp.asarray(q), 2.0))
    exc = np.array([[0, 1], [1, 2], [2, 5], [4, 5]], dtype=np.int32)
    scales = rng.uniform(0.0, 1.0, (4, 2))
    for got, ref in zip(tnb.exclusions_to_rescale_masks(exc, scales, 6), jnb.exclusions_to_rescale_masks(exc, scales, 6)):
        np.testing.assert_array_equal(got, ref)
    for update in (False, True):
        for got, ref in zip(tnb.filter_exclusions([5, 1, 2], exc, scales, update),
                            jnb.filter_exclusions([5, 1, 2], exc, scales, update)):
            np.testing.assert_array_equal(got, ref)
            assert got.dtype == ref.dtype
    tnb.validate_interaction_group_idxs(6, [0, 1], [2, 3])
    for a, b in (([0, 1], [1, 2]), ([0, 6], [2]), ([0, 0], [2])):
        with pytest.raises(AssertionError):
            jnb.validate_interaction_group_idxs(6, a, b)
        with pytest.raises(AssertionError):
            tnb.validate_interaction_group_idxs(6, a, b)


@pytest.mark.parametrize("cutoff,beta", [(1.0, 2.0), (0.5, 2.0), (1.2, 1.0)])
def test_validate_coulomb_cutoff_warns_as_jax(cutoff, beta):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jnb.validate_coulomb_cutoff(cutoff, beta)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tnb.validate_coulomb_cutoff(cutoff, beta)
    # the text is JAX's; its erfc value agrees to REL (XLA's erfc and the port's differ in the last bits)
    assert [w.category for w in tw] == [w.category for w in jw]
    for t, j in zip(tw, jw):
        t_head, t_rest = str(t.message).split(" = ", 1)
        j_head, j_rest = str(j.message).split(" = ", 1)
        assert t_head == j_head and t_rest.split(" ", 1)[1] == j_rest.split(" ", 1)[1]
        assert abs(float(t_rest.split(" ")[0]) - float(j_rest.split(" ")[0])) <= REL * float(j_rest.split(" ")[0])


@pytest.fixture(scope="module")
def snapshot():
    rng = np.random.default_rng(2024)
    frames, n_lig, n_env = 3, 30, 500
    x_lig = rng.uniform(0.0, 3.0, (frames, n_lig, 3))
    x_env = rng.uniform(0.0, 3.0, (frames, n_env, 3))
    boxes = np.stack([np.diag(rng.uniform(3.0, 3.2, 3)) for _ in range(frames)])
    env = dict(q=rng.normal(size=n_env), sig=rng.uniform(0.05, 0.2, n_env), eps=rng.uniform(0.1, 1.0, n_env))
    lig = dict(q=rng.normal(size=n_lig), sig=rng.uniform(0.05, 0.2, n_lig), eps=rng.uniform(0.1, 1.0, n_lig))
    return x_lig, x_env, boxes, env, lig


@pytest.mark.parametrize("with_box", (False, True))
@pytest.mark.parametrize("cutoff", (np.inf, 1.2))
def test_prefactor_energies_match_jax(snapshot, with_box, cutoff):
    """JAX's functions frame by frame against the port's over the frames at once."""
    x_lig, x_env, boxes, env, lig = snapshot
    jbox = [None if not with_box else jnp.asarray(b) for b in boxes]
    tbox = _t(boxes) if with_box else None
    jq = np.stack([np.asarray(jnb.coulomb_prefactors_on_snapshot(jnp.asarray(x_lig[f]), jnp.asarray(x_env[f]),
                                                                 jnp.asarray(env["q"]), jbox[f], 2.0, cutoff))
                   for f in range(len(boxes))])
    tq = tnb.coulomb_prefactors_on_snapshot(_t(x_lig), _t(x_env), _t(env["q"]), tbox, 2.0, cutoff)
    _close(tq, jq, PREFACTOR_REL)
    j_uq = np.array([float(jnb.coulomb_interaction_group_energy(jnp.asarray(lig["q"]), jnp.asarray(p))) for p in jq])
    _close(tnb.coulomb_interaction_group_energy(_t(lig["q"]), tq), j_uq, PREFACTOR_REL)
    jl = np.stack([np.asarray(jnb.lj_prefactors_on_snapshot(jnp.asarray(x_lig[f]), jnp.asarray(x_env[f]),
                                                            jnp.asarray(env["sig"]), jnp.asarray(env["eps"]), jbox[f],
                                                            cutoff))
                   for f in range(len(boxes))])
    tl = tnb.lj_prefactors_on_snapshot(_t(x_lig), _t(x_env), _t(env["sig"]), _t(env["eps"]), tbox, cutoff)
    _close(tl, jl, PREFACTOR_REL)
    j_ulj = np.array([float(jnb.lj_interaction_group_energy(jnp.asarray(lig["sig"]), jnp.asarray(lig["eps"]),
                                                            jnp.asarray(p))) for p in jl])
    t_ulj = tnb.lj_interaction_group_energy(_t(lig["sig"]), _t(lig["eps"]), tl)
    for got, ref in zip(_np(t_ulj), j_ulj):
        assert abs(got - ref) <= PREFACTOR_REL * abs(ref)


def test_lj_basis_of_one_atom_and_environment_match_jax(snapshot):
    _, _, _, env, lig = snapshot
    _close(tnb.basis_expand_lj_atom(_t(lig["sig"][0]), _t(lig["eps"][0])),
           jnb.basis_expand_lj_atom(jnp.asarray(lig["sig"][0]), jnp.asarray(lig["eps"][0])))
    r = np.random.default_rng(3).uniform(0.3, 1.5, len(env["sig"]))
    _close(tnb.basis_expand_lj_env(_t(env["sig"]), _t(env["eps"]), _t(r)),
           jnb.basis_expand_lj_env(jnp.asarray(env["sig"]), jnp.asarray(env["eps"]), jnp.asarray(r)))


# -- integrators.py and fe/system.py ------------------------------------------------


def test_sample_velocities_given_jax_draws_matches_jax(monkeypatch):
    from timemachine_torch import integrators as tint
    from timemachine_tpu import integrators as jint

    masses = np.random.default_rng(4).uniform(1.0, 30.0, 17)
    key = jax.random.key(5)
    ref = np.asarray(jint.sample_velocities(masses, 300.0, key))
    draws = np.asarray(jax.random.normal(key, (17, 3), dtype=jnp.float64))
    monkeypatch.setattr(tint, "_standard_normals", lambda generator, shape, dtype: _t(draws).to(dtype))
    got = tint.sample_velocities(masses, 300.0, torch.Generator().manual_seed(0))
    assert np.abs(_np(got) - ref).max() <= 1e-15 * np.abs(ref).max()


def test_sample_velocities_draws_from_the_generator():
    from timemachine_torch import integrators as tint

    masses = np.full(5, 12.0)
    a = tint.sample_velocities(masses, 300.0, torch.Generator().manual_seed(3))
    b = tint.sample_velocities(masses, 300.0, torch.Generator().manual_seed(3))
    c = tint.sample_velocities(masses, 300.0, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and a.dtype == torch.float64


def _chain():
    """A bent four-atom chain of harmonic bonds: U in jnp and in torch."""
    idx = np.array([[0, 1], [1, 2], [2, 3]])
    kb, b0 = 400.0, 0.15

    def uj(x):
        d = jnp.linalg.norm(x[idx[:, 0]] - x[idx[:, 1]], axis=-1)
        return jnp.sum(0.5 * kb * (d - b0) ** 2)

    def ut(x):
        d = torch.linalg.norm(x[idx[:, 0]] - x[idx[:, 1]], dim=-1)
        return torch.sum(0.5 * kb * (d - b0) ** 2)

    return uj, ut, np.random.default_rng(0).normal(size=(4, 3)) * 0.3


def test_minimize_scipy_matches_jax():
    uj, ut, x0 = _chain()
    ref = np.asarray(jsys.minimize_scipy(uj, x0))
    got = tsys.minimize_scipy(ut, x0, device="cpu")
    assert got.shape == x0.shape and np.abs(got - ref).max() <= 1e-8
    traj_j = jsys.minimize_scipy(uj, x0, return_traj=True)
    traj_t = tsys.minimize_scipy(ut, x0, return_traj=True, device="cpu")
    assert len(traj_t) == len(traj_j)
    assert np.abs(traj_t[-1] - np.asarray(traj_j[-1])).max() <= 1e-8


def test_minimize_scipy_on_bonded_terms_matches_jax(ethanol_terms):
    jbps, tbps, x = ethanol_terms
    mods = _modules(tbps, len(x))
    ref = np.asarray(jsys.minimize_scipy(lambda y: sum(bp(y, None) for bp in jbps[:2]), x))
    got = tsys.minimize_scipy(lambda y: sum(m.energy(y, None) for m in mods[:2]), x, device="cpu")
    assert np.abs(got - ref).max() <= 1e-8


def _modules(tbps, n):
    from timemachine_torch.convert import modules_from_bound_potentials

    return modules_from_bound_potentials(tbps, n, "cpu")


def test_simulate_system_given_jax_draws_matches_jax(monkeypatch):
    uj, ut, x0 = _chain()
    workers, steps, samples = 2, 5, 16
    ref = jsys.simulate_system(uj, x0, num_samples=samples, steps_per_batch=steps, num_workers=workers)
    # JAX's draws: per walker key, a split per batch, one key per step
    per_walker = []
    for key in jax.random.split(jax.random.key(2023), workers):
        seq = []
        for _ in range(samples // workers + (samples // workers) // 10 + 1):
            key, sub = jax.random.split(key)
            seq.extend(np.asarray(jax.random.normal(k, x0.shape)) for k in jax.random.split(sub, steps))
        per_walker.append(seq)
    draws = iter([_t(np.stack(step)) for step in zip(*per_walker)])
    monkeypatch.setattr(tsys, "_walker_noise", lambda generator, shape, dtype: next(draws).to(dtype))
    got = tsys.simulate_system(ut, x0, num_samples=samples, steps_per_batch=steps, num_workers=workers, device="cpu")
    assert got.shape == ref.shape == (samples, 4, 3)
    assert np.abs(got - np.asarray(ref)).max() <= 1e-10


def test_abstract_system_is_the_systems_base(ethanol_terms):
    from timemachine_torch.fe.system import GuestSystem, HostGuestSystem, HostSystem

    for cls in (HostSystem, GuestSystem, HostGuestSystem):
        assert issubclass(cls, tsys.AbstractSystem) and issubclass(getattr(jsys, cls.__name__), jsys.AbstractSystem)


# -- fe/utils.py, fe/model_utils.py, md/builders.py -----------------------------------


def test_fe_utils_math_matches_jax(edge):
    rng = np.random.default_rng(11)
    us = rng.normal(size=(20, 5)) * 1e4
    np.testing.assert_array_equal(tfu.sanitize_energies(us, 2), jfu.sanitize_energies(us, 2))
    u_knk = rng.normal(size=(4, 10, 4))
    np.testing.assert_array_equal(tfu.extract_delta_Us_from_U_knk(u_knk), jfu.extract_delta_Us_from_U_knk(u_knk))
    for v in (0.01, 3.0, 250.0):
        for temp in (None, 310.0):
            assert tfu.convert_uM_to_kJ_per_mole(v, temp) == jfu.convert_uM_to_kJ_per_mole(v, temp)
            assert tfu.convert_uIC50_to_kJ_per_mole(v, temp) == jfu.convert_uIC50_to_kJ_per_mole(v, temp)
    (ja, _), (ta, _), _ = edge
    rot = jfu.generate_good_rotations(ja, ja, num_rotations=1)[0]
    _close(tfu.rotate_mol(ta, rot).get_conf(), jfu.rotate_mol(ja, rot).get_conf())


def test_drawings_are_jax_strings_on_the_edge(edge):
    (ja, jb), (ta, tb), core = edge
    assert tfu.get_atom_map_colors(core) == jfu.get_atom_map_colors(core)
    assert tfu.generate_bond_idxs_and_colors(ta, tb, core) == jfu.generate_bond_idxs_and_colors(ja, jb, core)
    assert tfu.plot_atom_mapping(ta, tb, core) == jfu.plot_atom_mapping(ja, jb, core)
    assert tfu.plot_atom_mapping_grid(ta, tb, core) == jfu.plot_atom_mapping_grid(ja, jb, core)
    assert tfu.view_atom_mapping_3d(ta, tb, core) == jfu.view_atom_mapping_3d(ja, jb, core)
    assert tfu.draw_mol_idx(ta, core[:, 0].tolist()) == jfu.draw_mol_idx(ja, core[:, 0].tolist())


def test_drawings_are_jax_strings_on_biphenyl(biphenyl):
    jm, tm = biphenyl
    core = np.stack([np.arange(jm.num_atoms)] * 2, axis=1)
    assert tfu.draw_mol(tm) == jfu.draw_mol(jm)
    assert tfu.draw_mol(tm, [0, 1], {2: (0.1, 0.5, 0.9)}, [0], {1: (1.0, 0.0, 0.0)}) == jfu.draw_mol(
        jm, [0, 1], {2: (0.1, 0.5, 0.9)}, [0], {1: (1.0, 0.0, 0.0)}
    )
    assert tfu.plot_atom_mapping(tm, tm, core) == jfu.plot_atom_mapping(jm, jm, core)
    assert tfu.view_atom_mapping_3d(tm, tm, core) == jfu.view_atom_mapping_3d(jm, jm, core)


def test_view_rest_region_is_jax_html(edge):
    from timemachine_torch.fe.rest.single_topology import SingleTopologyREST as TST
    from timemachine_torch.ff import Forcefield as TF
    from timemachine_tpu.fe.rest.single_topology import SingleTopologyREST as JST
    from timemachine_tpu.ff import Forcefield as JF

    (ja, jb), (ta, tb), core = edge
    jst, tst = JST(ja, jb, core, JF.load_default(), 3.0), TST(ta, tb, core, TF.load_default(), 3.0)
    assert tfu.view_rest_region_3d(tst) == jfu.view_rest_region_3d(jst)


def test_verify_chiral_validity_of_core_passes_as_jax(edge):
    from timemachine_torch.fe.model_utils import verify_chiral_validity_of_core as t_verify
    from timemachine_tpu.fe.model_utils import verify_chiral_validity_of_core as j_verify

    (ja, jb), (ta, tb), core = edge
    assert t_verify(ta, tb, core, None) is None and j_verify(ja, jb, core, None) is None
    identity = np.stack([np.arange(ja.num_atoms)] * 2, axis=1)
    assert t_verify(ta, ta, identity, None) is None and j_verify(ja, ja, identity, None) is None


def test_verify_chiral_validity_of_core_raises_as_jax():
    """Ethanol onto its mirror image: every tetrahedral center's restraint
    flips, and both packages raise the same text."""
    from timemachine_torch.fe.model_utils import verify_chiral_validity_of_core as t_verify
    from timemachine_tpu.fe.model_utils import verify_chiral_validity_of_core as j_verify

    ja, ta = mol_pair("CCO")
    jm, tm = mol_pair("CCO")
    mirror = np.asarray(ja.get_conf()) * np.array([-1.0, 1.0, 1.0])
    jm.set_conf(mirror)
    tm.set_conf(mirror)
    identity = np.stack([np.arange(ja.num_atoms)] * 2, axis=1)
    with pytest.raises(ValueError) as j_err:
        j_verify(ja, jm, identity, None)
    with pytest.raises(ValueError) as t_err:
        t_verify(ta, tm, identity, None)
    assert str(t_err.value) == str(j_err.value)


def test_strip_units_and_aliases_match_jax():
    from timemachine_torch.fe import energy_decomposition as ted
    from timemachine_torch.fe import free_energy as tfe
    from timemachine_torch.fe import interaction_group_traj as tigt
    from timemachine_torch.fe import mle as tmle
    from timemachine_torch.fe import reweighting as trw
    from timemachine_torch.md import builders as tb
    from timemachine_torch.parallel import client as tclient
    from timemachine_tpu.fe import energy_decomposition as jed
    from timemachine_tpu.fe import free_energy as jfe
    from timemachine_tpu.fe import interaction_group_traj as jigt
    from timemachine_tpu.fe import reweighting as jrw
    from timemachine_tpu.md import builders as jb

    x = [[0.1, 0.2, 0.3]]
    np.testing.assert_array_equal(tb.strip_units(x), jb.strip_units(x))
    assert tclient.CUDAPoolClient is tclient.DevicePoolClient
    assert tfe.InterpolationFxnName is jfe.InterpolationFxnName is str
    assert tigt.Position is jigt.Position is np.ndarray
    for name in ("Samples", "Params", "BatchedReducedPotentialFxn"):
        assert getattr(trw, name) is getattr(jrw, name)
    assert ted.Frames.__name__ == jed.Frames.__name__ == "Frames"
    assert tmle.NxDiGraph is tgu.Graph
