"""The port's single topology (timemachine_torch/fe/single_topology.py and
what it runs: dummy groups, alignment, interpolation, the topology's
parameterization) and water box against timemachine_tpu's.

On ethanol -> propane and toluene -> phenol (tests/test_torch_chem.py's
conformers; the core from the JAX package's get_cores) at λ in {0, 0.15,
0.5, 0.85, 1}: each term of setup_intermediate_state has equal index arrays
and parameters within 1e-12 relative to each column's largest |value| (the
log-linear force-constant ramps run torch's exp and log, which may differ
from XLA's by an ulp); combine_masses and combine_confs are equal. The water
box of build_water_system is bitwise the JAX package's, and combine_with_host
and setup_initial_state in it give the JAX package's arrays, masses, groups,
velocities and seeds.
"""

import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_chem import EDGE, RING_EDGE, mol_pair
from timemachine_torch.convert import host_guest_arrays, host_system_arrays
from timemachine_torch.fe import rbfe as t_rbfe
from timemachine_torch.fe.single_topology import SingleTopology as TST
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.md.builders import build_water_system as t_build_water_system
from timemachine_tpu.constants import DEFAULT_ATOM_MAPPING_KWARGS
from timemachine_tpu.fe import rbfe as j_rbfe
from timemachine_tpu.fe.atom_mapping import get_cores
from timemachine_tpu.fe.single_topology import SingleTopology as JST
from timemachine_tpu.ff import Forcefield as JF
from timemachine_tpu.md.builders import build_water_system as j_build_water_system

torch.set_num_threads(1)  # the suite's workers share the host's cores

LAMBDAS = (0.0, 0.15, 0.5, 0.85, 1.0)
REL = 1e-12
GUEST_TERMS = ("bond", "angle", "proper", "improper", "chiral_atom", "chiral_bond", "nonbonded_pair_list")
SMALL_BOX = 2.6  # nm, the smallest water box that holds twice the 1.2 nm cutoff


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_rel(got, ref, tol=REL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if ref.size:
        scale = np.maximum(np.abs(ref).reshape(len(ref), -1).max(0), np.finfo(np.float64).tiny)
        assert (np.abs(got - ref).reshape(len(ref), -1) / scale).max() <= tol


def _assert_arrays(got: dict, ref: dict, tol=REL):
    assert got.keys() == ref.keys()
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        if k.endswith("params") and r.ndim:
            _assert_rel(g, r, tol)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.fixture(scope="module", params=[EDGE, RING_EDGE], ids=["ethanol-propane", "toluene-phenol"])
def edge(request):
    (ja, ta), (jb, tb) = mol_pair(request.param[0], "a"), mol_pair(request.param[1], "b")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        core = np.asarray(get_cores(ja, jb, **DEFAULT_ATOM_MAPPING_KWARGS)[0])
        jf, tf = JF.load_default(), TF.load_default()
        return dict(j=JST(ja, jb, core, jf), t=TST(ta, tb, core, tf), jmols=(ja, jb), tmols=(ta, tb), core=core)


def test_atom_map_bookkeeping_matches_jax(edge):
    j, t = edge["j"], edge["t"]
    for k in ("a_to_c", "b_to_c", "c_flags"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    assert t.anchored_dummy_groups_ab == j.anchored_dummy_groups_ab
    assert t.anchored_dummy_groups_ba == j.anchored_dummy_groups_ba


@pytest.mark.parametrize("lamb", LAMBDAS)
def test_intermediate_state_matches_jax(edge, lamb):
    js, ts = edge["j"].setup_intermediate_state(lamb), edge["t"].setup_intermediate_state(lamb)
    for term in GUEST_TERMS:
        jb, tb = getattr(js, term), getattr(ts, term)
        np.testing.assert_array_equal(tb.potential.idxs, np.asarray(jb.potential.idxs), err_msg=term)
        _assert_rel(tb.params, jb.params)


def test_masses_and_conformers_match_jax(edge):
    j, t = edge["j"], edge["t"]
    for hmr in (False, True):
        np.testing.assert_array_equal(np.asarray(t.combine_masses(use_hmr=hmr)), np.asarray(j.combine_masses(use_hmr=hmr)))
    xa, xb = (m.get_conf() for m in edge["tmols"])
    for lamb in LAMBDAS:
        np.testing.assert_array_equal(t.combine_confs(xa, xb, lamb), j.combine_confs(xa, xb, lamb))


@pytest.fixture(scope="module")
def water_boxes(edge):
    return (
        j_build_water_system(SMALL_BOX, "tip3p", mols=list(edge["jmols"])),
        t_build_water_system(SMALL_BOX, "tip3p", mols=list(edge["tmols"])),
    )


def test_water_box_is_bitwise_jax(water_boxes):
    j, t = water_boxes
    for k in ("conf", "box", "masses"):
        np.testing.assert_array_equal(getattr(t, k), np.asarray(getattr(j, k)))
    assert t.num_water_atoms == j.num_water_atoms
    assert len(t.host_topology.group_idxs) == len(j.host_topology.group_idxs)
    for g, h in zip(t.host_topology.group_idxs, j.host_topology.group_idxs):
        np.testing.assert_array_equal(g, h)
    ta, ja = host_system_arrays(t.host_system), host_system_arrays(j.host_system)
    assert ta.keys() == ja.keys()
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


@pytest.mark.parametrize("lamb", (0.0, 0.5, 1.0))
def test_combine_with_host_matches_jax(edge, water_boxes, lamb):
    j, t = water_boxes
    js = edge["j"].combine_with_host(j.host_system, lamb, j.num_water_atoms, edge["j"].ff, j.host_topology)
    ts = edge["t"].combine_with_host(t.host_system, lamb, t.num_water_atoms, edge["t"].ff, t.host_topology)
    _assert_arrays(ts.arrays(), host_guest_arrays(js))


@pytest.mark.parametrize("lamb", (0.0, 0.4, 1.0))
def test_setup_initial_state_matches_jax(edge, water_boxes, lamb):
    """Masses, barostat groups and seed, velocities, interacting atoms and
    the ligand/protein indices equal; the integrator seed hashes the
    parameters' bytes, so it is equal where those are bitwise (ROADMAP P18),
    which the end states are."""
    j, t = water_boxes
    jhost = j_rbfe.Host(j.host_system, j.masses, j.conf, j.box, j.num_water_atoms, j.host_topology)
    thost = t_rbfe.Host(t.host_system, t.masses, t.conf, t.box, t.num_water_atoms, t.host_topology)
    js = j_rbfe.setup_initial_state(edge["j"], lamb, jhost, 300.0, 2023)
    ts = t_rbfe.setup_initial_state(edge["t"], lamb, thost, 300.0, 2023, device="cpu")
    np.testing.assert_array_equal(ts.integrator.masses, np.asarray(js.integrator.masses))
    np.testing.assert_array_equal(ts.x0, np.asarray(js.x0))
    np.testing.assert_array_equal(ts.v0, np.asarray(js.v0))
    np.testing.assert_array_equal(ts.box0, np.asarray(js.box0))
    for k in ("ligand_idxs", "protein_idxs", "interacting_atoms"):
        np.testing.assert_array_equal(getattr(ts, k), np.asarray(getattr(js, k)))
    assert ts.barostat.seed == js.barostat.seed and ts.barostat.interval == js.barostat.interval
    assert len(ts.barostat.group_idxs) == len(js.barostat.group_idxs)
    for g, h in zip(ts.barostat.group_idxs, js.barostat.group_idxs):
        np.testing.assert_array_equal(g, np.asarray(h))
    assert (ts.integrator.temperature, ts.integrator.dt, ts.integrator.friction) == (
        js.integrator.temperature, js.integrator.dt, js.integrator.friction,
    )
    if lamb in (0.0, 1.0):
        assert ts.integrator.seed == js.integrator.seed


@pytest.mark.parametrize("lamb", (0.0, 0.4, 1.0))
def test_vacuum_initial_state_matches_jax(edge, lamb):
    """setup_initial_state without a host: the guest terms (as the port's
    GuestSystem), HMR masses, the 10 nm box, velocities and seeds."""
    js = j_rbfe.setup_initial_state(edge["j"], lamb, None, 300.0, 2023)
    ts = t_rbfe.setup_initial_state(edge["t"], lamb, None, 300.0, 2023, device="cpu")
    assert ts.barostat is None and js.barostat is None
    for k in ("x0", "v0", "box0", "ligand_idxs", "protein_idxs", "interacting_atoms"):
        np.testing.assert_array_equal(getattr(ts, k), np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_array_equal(ts.integrator.masses, np.asarray(js.integrator.masses))
    assert len(ts.potentials) == len(js.potentials) == 6
    for tp, jp in zip(ts.potentials, js.potentials):
        np.testing.assert_array_equal(tp.idxs.numpy(), np.asarray(jp.potential.idxs))
        _assert_rel(tp.params, jp.params)
    if lamb in (0.0, 1.0):
        assert ts.integrator.seed == js.integrator.seed
