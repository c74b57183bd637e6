"""REST of the port (timemachine_torch/fe/rest/: bond.py, interpolation.py,
queries.py, single_topology.py; md/enhanced.py's rotatable-bond SMARTS;
fe/rbfe.py DEFAULT_REST_PARAMS and AlchemicalEdge.create(rest_params=);
testsystems/rbfe_solvent.py build_rbfe_solvent(rest_params=)) against
timemachine_tpu.

The edges: ethanol -> propane (the RBFE cache's conformers), toluene ->
phenol and methylcyclohexane -> cyclohexanol (embedded once by the JAX
package at seed 7, tests/test_torch_chem.py), each core from the port's
pure-Python mapper, given to both packages.

Tolerances (stated per test): the schedules to 1e-15 relative (measured 0:
the same numpy operations); the region's seeds, the region, the softenable
bonds and target_proper_idxs equal as sets or lists; every term's
parameters within 1e-12 of each column's largest |value| (the port's
log-linear ramps run torch's exp, as tests/test_torch_single_topology.py
states); the end states and REST's scaled entries bitwise.
"""

import warnings
from dataclasses import asdict

import numpy as np
import pytest
import torch

from tests.test_torch_chem import EDGE, RING_EDGE, mol_pair
from tests.test_torch_single_topology import GUEST_TERMS, SMALL_BOX, _assert_arrays, _assert_rel
from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
from timemachine_torch.convert import host_guest_arrays
from timemachine_torch.fe import free_energy as tfe
from timemachine_torch.fe import rbfe as trbfe
from timemachine_torch.fe.atom_mapping import get_cores
from timemachine_torch.fe.rest import bond as tbond
from timemachine_torch.fe.rest import interpolation as tinterp
from timemachine_torch.fe.rest.queries import get_aliphatic_ring_bonds, get_rotatable_bonds
from timemachine_torch.fe.rest.single_topology import SingleTopologyREST as TREST
from timemachine_torch.fe.single_topology import SingleTopology as TST
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.md.builders import build_water_system as t_build_water_system
from timemachine_tpu.fe.rest import bond as jbond
from timemachine_tpu.fe.rest import interpolation as jinterp

torch.set_num_threads(1)  # the suite's workers share the host's cores

LAMBDAS = (0.0, 0.25, 0.5, 0.75, 1.0)
PANEL = ("C1CCCCC1", "c1ccccc1", "CCCC", "CCO", "CCC", "Oc1ccccc1", "Cc1ccccc1", "CC1CCCCC1", "OC1CCCCC1")
CYCLO_EDGE = ("CC1CCCCC1", "OC1CCCCC1")


# -- schedules, bonds, queries --------------------------------------------------------------


@pytest.mark.parametrize("name", ["linear", "quadratic", "exponential"])
@pytest.mark.parametrize("src, dst", [(1.0, 3.0), (2.5, 0.4), (1.0, 1.0)])
def test_schedules_match_jax(name, src, dst):
    """get_interpolation_fxn and its Symmetric fold on 101 λ points against
    JAX's to 1e-15 relative; the endpoints exact; Symmetric's dst is the
    inner schedule's src in both (JAX's quirk)."""
    lam = np.linspace(0.0, 1.0, 101)
    t, j = tinterp.get_interpolation_fxn(name, src, dst), jinterp.get_interpolation_fxn(name, src, dst)
    for f, g in ((t, j), (tinterp.Symmetric(t), jinterp.Symmetric(j))):
        a, b = np.asarray(f(lam)), np.asarray(g(lam))
        assert np.abs(a - b).max() <= 1e-15 * np.abs(b).max()
        assert (f.src, f.dst) == (g.src, g.dst)
    assert t(0.0) == src and t(1.0) == dst and tinterp.Symmetric(t)(0.5) == dst
    assert tinterp.Symmetric(t).dst == src
    ctor = {"linear": "Linear", "quadratic": "Quadratic", "exponential": "Exponential"}[name]
    assert np.array_equal(getattr(tinterp, ctor)(src, dst)(lam), getattr(jinterp, ctor)(src, dst)(lam))


@pytest.mark.parametrize("name, src, dst", [("quadratic", 0.0, 1.0), ("exponential", -1.0, 2.0), ("exponential", 1.0, 0.0),
                                            ("cubic", 1.0, 2.0)])
def test_schedule_errors_match_jax(name, src, dst):
    """Non-positive endpoints of the quadratic and exponential schedules, and
    an unknown name, raise ValueError in both packages."""
    for mod in (tinterp, jinterp):
        with pytest.raises(ValueError):
            mod.get_interpolation_fxn(name, src, dst)


def test_ixn_canonicalization_matches_jax():
    """mkbond, mkangle and mkproper of numpy-made tuples in both orders give
    JAX's canonical tuples; equal in either order; a non-canonical Ixn
    raises in both; translate relabels as JAX's."""
    rng = np.random.default_rng(4)
    for arity, (t_mk, j_mk) in ((2, (tbond.mkbond, jbond.mkbond)), (3, (tbond.mkangle, jbond.mkangle)),
                                (4, (tbond.mkproper, jbond.mkproper))):
        for _ in range(20):
            idxs = rng.choice(30, arity, replace=False).tolist()
            t, j = t_mk(*idxs), j_mk(*idxs)
            assert t.idxs == j.idxs and t == t_mk(*idxs[::-1]) and t.idxs[0] < t.idxs[-1]
            table = rng.permutation(60)
            assert t.translate(table).idxs == j.translate(table).idxs
    for mod in (tbond, jbond):
        with pytest.raises(ValueError):
            mod.Ixn((3, 1))


@pytest.mark.parametrize("add_hs", [False, True])
@pytest.mark.parametrize("smiles", PANEL)
def test_queries_match_jax(smiles, add_hs):
    """get_aliphatic_ring_bonds, get_rotatable_bonds and
    identify_rotatable_bonds give JAX's sets on a SMILES panel, with and
    without explicit hydrogens (and JAX's own counts on cyclohexane, benzene
    and butane without them: 6, 0 and 1)."""
    from timemachine_torch.chem import mol_from_smiles as t_mol
    from timemachine_torch.md.enhanced import ROTATABLE_BOND_SMARTS, identify_rotatable_bonds
    from timemachine_tpu.chem import mol_from_smiles as j_mol
    from timemachine_tpu.fe.rest import queries as jq
    from timemachine_tpu.md import enhanced as jenh

    j, t = j_mol(smiles, add_hs=add_hs), t_mol(smiles, add_hs=add_hs)
    assert {b.idxs for b in get_aliphatic_ring_bonds(t)} == {b.idxs for b in jq.get_aliphatic_ring_bonds(j)}
    assert {b.idxs for b in get_rotatable_bonds(t)} == {b.idxs for b in jq.get_rotatable_bonds(j)}
    assert identify_rotatable_bonds(t) == jenh.identify_rotatable_bonds(j)
    assert ROTATABLE_BOND_SMARTS == jenh.ROTATABLE_BOND_SMARTS
    if not add_hs and smiles in ("C1CCCCC1", "c1ccccc1"):
        assert len(get_aliphatic_ring_bonds(t)) == {"C1CCCCC1": 6, "c1ccccc1": 0}[smiles]
    if not add_hs and smiles == "CCCC":
        assert len(get_rotatable_bonds(t)) == 1


# -- SingleTopologyREST -----------------------------------------------------------------------


@pytest.fixture(scope="module", params=[EDGE, RING_EDGE, CYCLO_EDGE],
                ids=["ethanol-propane", "toluene-phenol", "methylcyclohexane-cyclohexanol"])
def edge(request):
    from timemachine_tpu.fe.rest.single_topology import SingleTopologyREST as JREST
    from timemachine_tpu.ff import Forcefield as JF

    (ja, ta), (jb, tb) = mol_pair(request.param[0], "a"), mol_pair(request.param[1], "b")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        core = np.asarray(get_cores(ta, tb, **DEFAULT_ATOM_MAPPING_KWARGS)[0])
        tf = TF.load_default()
        return dict(
            j=JREST(ja, jb, core, JF.load_default(), 3.0), t=TREST(ta, tb, core, tf, 3.0), plain=TST(ta, tb, core, tf),
            jmols=(ja, jb), tmols=(ta, tb),
        )


def test_region_matches_jax(edge):
    """The perturbed-atom seeds, the region, the softenable bonds, the
    propers and target_proper_idxs (and target_propers) equal JAX's; the
    region holds every dummy atom."""
    j, t = edge["j"], edge["t"]
    assert t._perturbed_atom_idxs == j._perturbed_atom_idxs == t.base_rest_region_atom_idxs
    assert t.rest_region_atom_idxs == j.rest_region_atom_idxs
    assert {b.idxs for b in t._softenable_bonds} == {b.idxs for b in j._softenable_bonds}
    assert t.propers == j.propers
    assert t.target_proper_idxs == j.target_proper_idxs and len(t.target_proper_idxs) > 0
    assert {k: v.idxs for k, v in t.target_propers.items()} == {k: v.idxs for k, v in j.target_propers.items()}
    assert t.get_dummy_atoms_a() | t.get_dummy_atoms_b() <= t.rest_region_atom_idxs
    assert t.split_combined_idxs(sorted(t.rest_region_atom_idxs)) == j.split_combined_idxs(sorted(j.rest_region_atom_idxs))


@pytest.mark.parametrize("lamb", LAMBDAS)
def test_intermediate_state_matches_jax(edge, lamb):
    """setup_intermediate_state: every term's index arrays equal and its
    parameters within 1e-12 of each column's largest |value| of JAX's; the
    energy scale factor equal; REST's entries the plain SingleTopology's
    times the factor, bitwise, every other entry bitwise the plain one's."""
    j, t, plain = edge["j"], edge["t"], edge["plain"]
    assert t.get_energy_scale_factor(lamb) == j.get_energy_scale_factor(lamb)
    js, ts, ps = j.setup_intermediate_state(lamb), t.setup_intermediate_state(lamb), plain.setup_intermediate_state(lamb)
    for term in GUEST_TERMS:
        np.testing.assert_array_equal(getattr(ts, term).potential.idxs, np.asarray(getattr(js, term).potential.idxs))
        _assert_rel(getattr(ts, term).params, getattr(js, term).params)
    scale = t.get_energy_scale_factor(lamb)
    for term, rows, cols in (("proper", t.target_proper_idxs, [0]),
                             ("nonbonded_pair_list", t.hot_pair_rows(ts.nonbonded_pair_list.potential.idxs), [0, 2])):
        got, base = getattr(ts, term).params.detach(), getattr(ps, term).params.detach()
        mask = torch.zeros_like(base, dtype=torch.bool)
        mask[torch.as_tensor(np.asarray(rows, dtype=np.int64))[:, None], torch.as_tensor(cols)] = True
        assert torch.equal(got[mask], base[mask] * scale) and torch.equal(got[~mask], base[~mask])
    for term in ("bond", "angle", "improper", "chiral_atom"):
        assert torch.equal(getattr(ts, term).params, getattr(ps, term).params)


@pytest.fixture(scope="module")
def water_boxes(edge):
    from timemachine_tpu.md.builders import build_water_system as j_build_water_system

    return (
        j_build_water_system(SMALL_BOX, "tip3p", mols=list(edge["jmols"])),
        t_build_water_system(SMALL_BOX, "tip3p", mols=list(edge["tmols"])),
    )


@pytest.mark.parametrize("lamb", (0.0, 0.5, 1.0))
def test_combine_with_host_matches_jax(edge, water_boxes, lamb):
    """combine_with_host in a build_water_system(2.6) box: every array
    equal, parameters within 1e-12 of each column's largest |value| of
    JAX's; the interaction group's hot rows the plain one's times the factor
    (charge and sqrt(epsilon)) bitwise; at the end states every array
    bitwise the plain SingleTopology's."""
    j, t = water_boxes
    js = edge["j"].combine_with_host(j.host_system, lamb, j.num_water_atoms, edge["j"].ff, j.host_topology)
    ts = edge["t"].combine_with_host(t.host_system, lamb, t.num_water_atoms, edge["t"].ff, t.host_topology)
    ps = edge["plain"].combine_with_host(t.host_system, lamb, t.num_water_atoms, edge["t"].ff, t.host_topology)
    _assert_arrays(ts.arrays(), host_guest_arrays(js))
    hot = np.array(sorted(edge["t"].rest_region_atom_idxs)) + t.host_system.nonbonded_all_pairs.potential.num_atoms
    got, base = ts.nonbonded_ixn_group.params.detach(), ps.nonbonded_ixn_group.params.detach()
    scale = edge["t"].get_energy_scale_factor(lamb)
    assert torch.equal(got[hot][:, [0, 2]], base[hot][:, [0, 2]] * scale)
    if lamb in (0.0, 1.0):
        a, b = ts.arrays(), ps.arrays()
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_edge_create_and_default_rest_params_match_jax(edge):
    """AlchemicalEdge.create(rest_params=) builds a SingleTopologyREST with
    the parameters' scale and schedule (no host); DEFAULT_REST_PARAMS equals
    JAX's field by field."""
    from timemachine_tpu.fe import rbfe as jrbfe

    assert asdict(trbfe.DEFAULT_REST_PARAMS) == asdict(jrbfe.DEFAULT_REST_PARAMS)
    rest = tfe.RESTParams(2.0, "linear")
    e = trbfe.AlchemicalEdge.create(*edge["tmols"], edge["t"].core, edge["t"].ff, None, "vacuum", 2023,
                                    rest_params=rest, device="cpu")
    assert isinstance(e.st, TREST) and e.st.max_temperature_scale == 2.0
    assert e.st.get_energy_scale_factor(0.5) == 0.5 and e.st.rest_region_atom_idxs == edge["t"].rest_region_atom_idxs
    assert type(trbfe.AlchemicalEdge.create(*edge["tmols"], edge["t"].core, edge["t"].ff, None, "v", 1, device="cpu").st) is TST
    assert tfe.HREXParams(rest_params=tfe.RESTParams(3.0)).rest_params.max_temperature_scale == 3.0


def test_run_vacuum_with_rest_is_finite_and_valid():
    """run_vacuum on ethanol -> propane with REST (3 windows, 2 bisection
    frames, 4 HREX frames of 10 steps after 20): a finite, valid result; its
    λ = 0.5 state's propers scaled by 1/3 against the same edge without REST."""
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.testsystems import rbfe_solvent

    meta = rbfe_solvent.metadata(rbfe_solvent.load_arrays())
    mols = [mol_from_smiles(s, add_hs=True, name=n) for s, n in zip(("CCO", "CCC"), ("ethanol", "propane"))]
    for m, c in zip(mols, (meta["conf_a"], meta["conf_b"])):
        m.set_conf(np.asarray(c))
    md = tfe.MDParams(n_frames=4, n_eq_steps=20, steps_per_frame=10, seed=2026,
                      hrex_params=tfe.HREXParams(n_frames_bisection=2, rest_params=tfe.RESTParams(3.0)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = trbfe.run_vacuum(*mols, np.asarray(meta["core"]), TF.load_default(), None, md_params=md, n_windows=3,
                               device="cpu")
    assert isinstance(res, tfe.HREXSimulationResult)
    assert [s.lamb for s in res.final_result.initial_states] == [0.0, 0.5, 1.0]
    assert len(res.final_result.dGs) == 2 and np.isfinite(res.final_result.dGs).all()
    assert np.isfinite(res.final_result.dG_errs).all()
    assert all(len(t.frames) == 4 and np.isfinite(t.frames[-1]).all() for t in res.trajectories)
    assert all(sorted(p) == [0, 1, 2] for p in res.hrex_diagnostics.replica_idx_by_state_by_iter)


def test_build_rbfe_solvent_with_rest():
    """build_rbfe_solvent(rest_params=RESTParams(3.0)) of the cache's windows
    0, 5, 6 and 11 against the plain builder's on the CPU (float64): windows
    0 and 11 bitwise in every term; REST's entries (22 propers' k, 54 pair-list
    and 14 interaction-group entries a window) the plain ones times the
    scale factor to 1e-12 relative (measured 0), every other entry, index
    array and buffer bitwise; x0 and box0 the cache's."""
    from timemachine_torch.testsystems import rbfe_solvent

    rec = {}
    ws = [0, 5, 6, 11]
    rest = rbfe_solvent.build_rbfe_solvent(device="cpu", windows=ws, record=rec, rest_params=tfe.RESTParams(3.0))
    plain = rbfe_solvent.build_rbfe_solvent(device="cpu", windows=ws)
    st = rec["single_topology"]
    assert isinstance(st, TREST)
    d = rbfe_solvent.rest_differences(rest, plain, st)
    assert d["bitwise"] == [0, 3] and d["others_bitwise"] and d["scaled_rel"] <= 1e-12
    assert d["n_scaled"]["proper"] > 0 and d["n_scaled"]["nonbonded_pair_list"] > 0 and d["n_scaled"]["nonbonded_ixn_group"] > 0
    cache = rbfe_solvent.load_arrays()
    for w, s in zip(ws, rest):
        win = rbfe_solvent.window_arrays(cache, w)
        assert np.array_equal(s.x0, win["x0"]) and np.array_equal(s.box0, win["box0"])
