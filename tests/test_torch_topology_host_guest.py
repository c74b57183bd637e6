"""The port's DualTopology and HostGuestTopology (timemachine_torch/fe/topology.py)
against timemachine_tpu/fe/topology.py, on the ethanol -> propane edge (the
RBFE cache's conformers) and a build_water_system(2.5) host around both.

Every index array, exclusion list and scale factor is equal, and every
parameter within PARAM_TOL of JAX's (absolute, in the parameters' units),
for each term: the valence terms, the nonbonded term at two λ, the pair
list, and HostGuestTopology's SummedPotential split into the host term
(atom subset), the interaction group and the guests' pair list. The host
with the guests inserted as md/minimizer.py builds it (host_guest_modules)
gives the JAX package's energy within the P11 gap of the host term.
"""

import numpy as np
import pytest
import torch

from timemachine_torch.chem import mol_from_smiles as t_mol_from_smiles
from timemachine_torch.fe import topology as tt
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.md import builders as tb
from timemachine_torch.md import minimizer as tm
from timemachine_torch.testsystems import rbfe_solvent

torch.set_num_threads(1)  # the suite's workers share the host's cores

PARAM_TOL = 1e-12
LAMBDAS = (0.0, 0.25)
SMILES, NAMES = ("CCO", "CCC"), ("ethanol", "propane")
# the host term runs JAX's dense exact-erfc form in both packages on the
# CPU: relative gap of the total energy of the unrelaxed water box with the
# guests inserted (measured 1.3e-16 at λ 0 and 1.8e-16 at λ 0.25; 9.0e-5
# and 4.9e-4 while the port ran the rowscan polynomial, ROADMAP P11)
ENERGY_REL = 1e-10


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


@pytest.fixture(scope="module")
def edge():
    """Both packages' molecules, force fields and water-box host configs."""
    _jax()
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.ff import Forcefield as JF
    from timemachine_tpu.md.builders import build_water_system

    meta = rbfe_solvent.metadata(rbfe_solvent.load_arrays())
    confs = (meta["conf_a"], meta["conf_b"])
    j_mols = [j_mol_from_smiles(s, add_hs=True, name=n) for s, n in zip(SMILES, NAMES)]
    t_mols = [t_mol_from_smiles(s, add_hs=True, name=n) for s, n in zip(SMILES, NAMES)]
    for mols in (j_mols, t_mols):
        for m, c in zip(mols, confs):
            m.set_conf(np.asarray(c))
    jff, tff = JF.load_default(), TF.load_default()
    return dict(
        j_mols=j_mols, t_mols=t_mols, jff=jff, tff=tff,
        j_host=build_water_system(2.5, jff.water_ff, mols=j_mols),
        t_host=tb.build_water_system(2.5, tff.water_ff, mols=t_mols),
    )


def _guests(edge, which):
    from timemachine_tpu.fe import topology as jt

    if which == "base":
        return jt.BaseTopology(edge["j_mols"][0], edge["jff"]), tt.BaseTopology(edge["t_mols"][0], edge["tff"])
    return (
        jt.DualTopology(edge["j_mols"][0], edge["j_mols"][1], edge["jff"]),
        tt.DualTopology(edge["t_mols"][0], edge["t_mols"][1], edge["tff"]),
    )


def _host_guest(edge, which):
    from timemachine_tpu.fe import topology as jt

    jg, tg = _guests(edge, which)
    jh, th = edge["j_host"], edge["t_host"]
    return (
        jt.HostGuestTopology(jh.host_system.get_U_fns(), jg, jh.num_water_atoms, edge["jff"], jh.host_topology),
        tt.HostGuestTopology(th.host_system.get_U_fns(), tg, th.num_water_atoms, edge["tff"], th.host_topology),
    )


def _assert_params(t, j):
    t, j = np.asarray(t.detach() if isinstance(t, torch.Tensor) else t), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=PARAM_TOL)


def _assert_potential(tp, jp):
    """Equal type name and every array and scalar field but parameters."""
    assert type(tp).__name__ == type(jp).__name__
    for name in ("idxs", "exclusion_idxs", "scale_factors", "atom_idxs", "row_atom_idxs", "col_atom_idxs", "num_atoms", "beta", "cutoff"):
        if hasattr(jp, name):
            a, b = getattr(tp, name), getattr(jp, name)
            if b is None:
                assert a is None, name
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


BONDED = ("parameterize_harmonic_bond", "parameterize_harmonic_angle", "parameterize_proper_torsion", "parameterize_improper_torsion")
HANDLES = {"parameterize_harmonic_bond": "hb_handle", "parameterize_harmonic_angle": "ha_handle",
           "parameterize_proper_torsion": "pt_handle", "parameterize_improper_torsion": "it_handle"}


@pytest.mark.parametrize("method", BONDED)
@pytest.mark.parametrize("topo", ["dual", "host_base", "host_dual"])
def test_bonded_terms_match_jax(edge, topo, method):
    j, t = _guests(edge, "dual") if topo == "dual" else _host_guest(edge, topo[5:])
    handle = HANDLES[method]
    jp, jpot = getattr(j, method)(getattr(edge["jff"], handle).params)
    tp, tpot = getattr(t, method)(getattr(edge["tff"], handle).params)
    _assert_potential(tpot, jpot)
    _assert_params(tp, jp)


@pytest.mark.parametrize("lamb", LAMBDAS)
@pytest.mark.parametrize("intramol", [True, False])
def test_dual_topology_nonbonded_matches_jax(edge, lamb, intramol):
    j, t = _guests(edge, "dual")
    jf, tf = edge["jff"], edge["tff"]
    args = lambda ff: (ff.q_handle.params, ff.q_handle_intra.params, ff.lj_handle.params, ff.lj_handle_intra.params)  # noqa: E731
    jp, jpot = j.parameterize_nonbonded(*args(jf), lamb, intramol_params=intramol)
    tp, tpot = t.parameterize_nonbonded(*args(tf), lamb, intramol_params=intramol)
    _assert_potential(tpot, jpot)
    _assert_params(tp, jp)
    jp, jpot = j.parameterize_nonbonded_pairlist(*args(jf), intramol_params=intramol)
    tp, tpot = t.parameterize_nonbonded_pairlist(*args(tf), intramol_params=intramol)
    _assert_potential(tpot, jpot)
    _assert_params(tp, jp)
    assert t.get_num_atoms() == j.get_num_atoms()
    for a, b in zip(t.get_component_idxs(), j.get_component_idxs(), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lamb", LAMBDAS)
@pytest.mark.parametrize("guest", ["base", "dual"])
def test_host_guest_nonbonded_matches_jax(edge, guest, lamb):
    j, t = _host_guest(edge, guest)
    jf, tf = edge["jff"], edge["tff"]
    args = lambda ff: (ff.q_handle.params, ff.q_handle_intra.params, ff.lj_handle.params, ff.lj_handle_intra.params)  # noqa: E731
    jp, jpot = j.parameterize_nonbonded(*args(jf), lamb)
    tp, tpot = t.parameterize_nonbonded(*args(tf), lamb)
    _assert_params(tp, jp)
    assert len(tpot.potentials) == len(jpot.potentials) == 3
    for tsub, jsub, tsp, jsp in zip(tpot.potentials, jpot.potentials, tpot.unflatten_params(tp), jpot.unflatten_params(jp), strict=True):
        _assert_potential(tsub, jsub)
        _assert_params(tsp, jsp)
    for name in ("get_lig_idxs", "get_env_idxs", "get_water_idxs", "get_other_idxs", "get_num_atoms"):
        np.testing.assert_array_equal(getattr(t, name)(), getattr(j, name)())


@pytest.mark.parametrize("lamb", LAMBDAS)
def test_host_guest_modules_energy_matches_jax(edge, lamb):
    """minimizer's host_guest_modules on the CPU: the total energy of the
    host with both guests at λ against the JAX package's bound potentials
    (the host term's P11 gap), the exact terms' sum within 1e-10 relative."""
    from timemachine_tpu.fe import topology as jt
    from timemachine_tpu.md import minimizer as jm

    jh, th = edge["j_host"], edge["t_host"]
    j = jt.HostGuestTopology(jh.host_system.get_U_fns(), _guests(edge, "dual")[0], jh.num_water_atoms, edge["jff"], jh.host_topology)
    jpots, jparams = jm.parameterize_system(j, edge["jff"], lamb)
    x = np.concatenate([jh.conf] + [m.get_conf() for m in edge["j_mols"]])
    u_j = [float(p(x, q, jh.box)) for p, q in zip(jpots, jparams)]
    modules, _ = tm.host_guest_modules(edge["t_mols"], th, edge["tff"], lamb, device="cpu")
    xt, boxt = torch.as_tensor(x), torch.as_tensor(th.box)
    tm.configure_nonbonded(modules, xt, boxt, site="context")
    u_t = [float(m.energy(xt, boxt)) for m in modules]
    host = [i for i, m in enumerate(modules) if type(m).__name__ == "Nonbonded"]
    exact_t = sum(u for i, u in enumerate(u_t) if i not in host)
    # JAX's last term is the SummedPotential; its exact parts are the ixn group and the pair list
    jsum = jpots[4]
    parts = jsum.unflatten_params(jparams[4])
    u_j_parts = [float(p(x, q, jh.box)) for p, q in zip(jsum.potentials, parts)]
    exact_j = sum(u_j[:4]) + sum(u_j_parts[1:])
    assert abs(exact_t - exact_j) <= 1e-10 * abs(exact_j)
    assert abs(sum(u_t) - sum(u_j)) <= ENERGY_REL * abs(sum(u_j))
