"""The port's state builder rebuilds the committed cache of the solvent
leg's 12 ethanol -> propane windows (timemachine_torch/testsystems/cache/
rbfe_solvent_ethanol_propane.npz, the JAX package's states) from the inputs
the cache records, with no JAX: build_rbfe_solvent(device="cpu").

Held: the core; every window's index arrays, masses, barostat groups,
interacting atoms, velocities and barostat seeds equal; every parameter
within 1e-12 relative to its column's largest |value|. The intermediate
windows' force constants are log-linear ramps, whose exp and log differ from
XLA's in the last bit for some arguments, and the integrator seed hashes the
parameters' bytes (ROADMAP P18): the counts of bitwise windows and of equal
integrator seeds are asserted, so that a change shows. The ligands' base
charges are AM1ELF10 from the port's SCF, never the Gasteiger fallback: a
GasteigerFallbackWarning fails the build.

These assertions hold only on a host whose numpy LAPACK rounds as the
cache writer's did: numpy 2.0.2's OpenBLAS 0.3.27 with its Cooperlake or
SkylakeX kernels. The AM1 SCF stops at |dE| < 1e-7, so the BLAS's last
bits move the charges. With the kernel family forced by OPENBLAS_CORETYPE
on one such x86 host, Haswell or Zen kernels move the ligand charges by
9.3e-12 e, 1.4e-10 of the pair list's charge column, and leave no window
bitwise nor any integrator seed equal; Sandybridge, Nehalem or Prescott
kernels move them by up to 3.2e-7 e. An H100 host with numpy 2.3.5 and
the same SkylakeX kernels moves them by 9.9e-12 e.
`python -m timemachine_torch.probes.am1_host --coretypes Haswell,Zen`
prints the host's OpenBLAS and these differences.
"""

import copy
import warnings

import numpy as np
import pytest
import torch

from timemachine_torch.constants import ONE_4PI_EPS0
from timemachine_torch.ff.handlers import AM1ELF10_CHARGE_CACHE, GASTEIGER_CHARGE_CACHE, GasteigerFallbackWarning
from timemachine_torch.testsystems import rbfe_solvent

torch.set_num_threads(1)  # the suite's workers share the host's cores

REL = 1e-12
N_WINDOWS = 12
BITWISE_WINDOWS = (0, 11)  # the end states; every intermediate window differs in the last bits


@pytest.fixture(scope="module")
def built():
    record = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", GasteigerFallbackWarning)
        states = rbfe_solvent.build_rbfe_solvent(device="cpu", record=record)
    a = rbfe_solvent.load_arrays()
    return dict(states=states, record=record, a=a, refs=rbfe_solvent.load_rbfe_solvent(device="cpu"))


def _arrays(built, w):
    """The window's terms as numpy arrays, built again from the recorded
    SingleTopology and Host (setup_initial_state's combine_with_host)."""
    st, host = built["record"]["single_topology"], built["record"]["host"]
    lamb = float(built["a"]["lamb"][w])
    return st.combine_with_host(host.system, lamb, host.num_water_atoms, st.ff, host.host_topology).arrays()


def test_core_and_stages(built):
    rec = built["record"]
    np.testing.assert_array_equal(rec["core"], rbfe_solvent.metadata(built["a"])["core"])
    assert len(built["states"]) == N_WINDOWS
    sec = rec["seconds"]
    assert set(sec) == {"parse", "am1_ethanol", "am1_propane", "mapping", "single_topology", "water_box", "windows"}
    assert len(sec["windows"]) == N_WINDOWS


def test_base_charges_are_am1(built):
    st = built["record"]["single_topology"]
    for mol in (st.mol_a, st.mol_b):
        assert AM1ELF10_CHARGE_CACHE in mol.props and GASTEIGER_CHARGE_CACHE not in mol.props, mol.name


@pytest.mark.parametrize("w", range(N_WINDOWS))
def test_window_arrays_match_the_cache(built, w):
    got, ref = _arrays(built, w), rbfe_solvent.window_arrays(built["a"], w)
    for k, g in got.items():
        r = ref[k]
        assert np.shape(g) == np.shape(r), k
        if k.endswith("params") and np.ndim(r):
            if np.size(r):
                scale = np.maximum(np.abs(r).reshape(len(r), -1).max(0), np.finfo(np.float64).tiny)
                assert (np.abs(g - r).reshape(len(r), -1) / scale).max() <= REL, k
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
            if k.endswith("idxs"):
                assert np.asarray(g).dtype == np.asarray(r).dtype, k


@pytest.mark.parametrize("w", range(N_WINDOWS))
def test_window_state_matches_the_cache(built, w):
    s, r = built["states"][w], built["refs"][w]
    for name, d in rbfe_solvent.term_differences(s, r).items():
        assert d["indices_equal"] and d["max_rel"] <= REL, name
    np.testing.assert_array_equal(s.integrator.masses, r.integrator.masses)
    np.testing.assert_array_equal(s.v0, r.v0)
    np.testing.assert_array_equal(s.interacting_atoms, r.interacting_atoms)
    np.testing.assert_array_equal(s.ligand_idxs, r.ligand_idxs)
    np.testing.assert_array_equal(s.protein_idxs, r.protein_idxs)
    np.testing.assert_array_equal(s.x0, r.x0)
    np.testing.assert_array_equal(s.box0, r.box0)
    assert s.lamb == r.lamb
    assert (s.integrator.temperature, s.integrator.dt, s.integrator.friction) == (
        r.integrator.temperature, r.integrator.dt, r.integrator.friction,
    )
    b, c = s.barostat, r.barostat
    assert (b.seed, b.interval, b.pressure, b.temperature, b.num_atoms) == (c.seed, c.interval, c.pressure, c.temperature, c.num_atoms)
    assert (b.adaptive_scaling_enabled, b.initial_volume_scale_factor) == (c.adaptive_scaling_enabled, c.initial_volume_scale_factor)
    assert len(b.group_idxs) == len(c.group_idxs)
    assert all(np.array_equal(g, h) for g, h in zip(b.group_idxs, c.group_idxs))


def test_bitwise_windows_and_equal_integrator_seeds(built):
    """Windows whose parameters are all bitwise the cache's, and windows
    whose integrator seed is the cache's: the same two, the end states."""
    bitwise = [
        w for w, (s, r) in enumerate(zip(built["states"], built["refs"]))
        if all(d["bitwise"] for d in rbfe_solvent.term_differences(s, r).values())
    ]
    seeds = [w for w, (s, r) in enumerate(zip(built["states"], built["refs"])) if s.integrator.seed == r.integrator.seed]
    assert tuple(bitwise) == BITWISE_WINDOWS
    assert tuple(seeds) == BITWISE_WINDOWS


def test_build_differences_reads_the_charge_columns_in_e(built):
    """build_differences over the 12 windows gives the same record as the
    tests above, and a ligand charge moved by 1e-9 e in one window reads as
    1e-9 e in the interaction group's column, with no other column moved."""
    d = rbfe_solvent.build_differences(built["states"], built["refs"])
    assert d["indices_equal"] and max(d["other_rel"], d["q_rel"], d["qq_rel"]) <= REL
    assert (tuple(d["bitwise"]), tuple(d["seeds"])) == (BITWISE_WINDOWS, BITWISE_WINDOWS)
    w, dq = 6, 1e-9
    moved = copy.deepcopy(built["states"][w])
    params = moved.potentials[rbfe_solvent.TERMS.index("nonbonded_ixn_group")].params
    params[int(moved.ligand_idxs[0]), 0] += dq * ONE_4PI_EPS0**0.5
    d = rbfe_solvent.build_differences([moved], [built["refs"][w]])
    assert d["q_e"] == pytest.approx(dq, rel=1e-6)
    assert d["other_rel"] <= REL and d["qq_e"] <= REL and d["bitwise"] == []
