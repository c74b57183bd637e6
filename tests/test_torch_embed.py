"""The port's conformer embedding (timemachine_torch/chem/embed.py) against
timemachine_tpu/chem/embed.py.

Both place atoms by BFS from numpy's default_rng(seed) draws and relax them
by FIRE on the same embedding energy, the JAX package's under jit (which may
contract its arithmetic into FMAs), the port's eagerly in torch float64. On
ethanol, propane (seed 7, the RBFE cache's embedding) and phenol the two
packages' conformers agree within CONF_TOL nm (measured on an x86-64
CPU: 1.4e-16 and 2.4e-16 nm for ethanol and propane, 2.3e-12 nm for phenol,
whose ring takes more FIRE steps to settle), and the port's ethanol and propane within CONF_TOL of the
conformers the cache records (JAX's embedding with seed 7). The embedding's
idealized terms (bond lengths, angles, contact floors) are equal to JAX's.
"""

import numpy as np
import pytest
import torch

from timemachine_torch.chem import embed as te
from timemachine_torch.chem import mol_from_smiles
from timemachine_torch.testsystems import rbfe_solvent

torch.set_num_threads(1)  # the suite's workers share the host's cores

CONF_TOL = 1e-10  # nm
SEED = 7
PANEL = ["CCO", "CCC", "Oc1ccccc1"]
CACHE_KEYS = {"CCO": "conf_a", "CCC": "conf_b"}


def _jax_embed(smiles):
    import jax

    jax.config.update("jax_enable_x64", True)
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.chem.embed import embed_mol

    return embed_mol(j_mol_from_smiles(smiles, add_hs=True), seed=SEED).get_conf()


@pytest.fixture(scope="module")
def conformers():
    """{smiles: (port's conformer, JAX's conformer)}, each embedded once."""
    out = {}
    for smiles in PANEL:
        t = te.embed_mol(mol_from_smiles(smiles, add_hs=True), seed=SEED).get_conf()
        out[smiles] = (t, np.asarray(_jax_embed(smiles)))
    return out


@pytest.mark.parametrize("smiles", PANEL)
def test_embed_mol_matches_jax(conformers, smiles):
    t, j = conformers[smiles]
    assert t.shape == j.shape and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("smiles", sorted(CACHE_KEYS))
def test_embed_mol_matches_the_cached_conformers(conformers, smiles):
    meta = rbfe_solvent.metadata(rbfe_solvent.load_arrays())
    np.testing.assert_allclose(conformers[smiles][0], meta[CACHE_KEYS[smiles]], rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("smiles", PANEL)
def test_embedded_conformer_has_no_clash(conformers, smiles):
    """Every nonbonded pair outside 1-2 and 1-3 sits at or beyond its
    contact floor, so the first attempt was kept."""
    mol = mol_from_smiles(smiles, add_hs=True)
    pairs, floor = te._embed_terms(mol)[4:]
    x = conformers[smiles][0]
    assert np.min(np.linalg.norm(x[pairs[:, 0]] - x[pairs[:, 1]], axis=1) - floor) >= 0.0


@pytest.mark.parametrize("smiles", PANEL)
def test_ideal_terms_match_jax(smiles):
    from timemachine_tpu.chem import embed as je
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles

    t, j = mol_from_smiles(smiles, add_hs=True), j_mol_from_smiles(smiles, add_hs=True)
    bonds = [(b.src, b.dst) for b in t.bonds]
    assert bonds == [(b.src, b.dst) for b in j.bonds]
    assert [te._ideal_bond_length(t, a, b) for a, b in bonds] == [je._ideal_bond_length(j, a, b) for a, b in bonds]
    assert [te._ideal_angle(t, a) for a in range(t.num_atoms)] == [je._ideal_angle(j, a) for a in range(j.num_atoms)]
    z = [a.atomic_num for a in t.atoms]
    assert [te._contact_floor(a, b) for a in z for b in z] == [je._contact_floor(a, b) for a in z for b in z]


def test_retries_keep_the_least_clashing_attempt_as_jax():
    """With too few relaxation steps to clear the contact floors, every
    attempt clashes: both packages try max_tries seeds and keep the same
    least-clashing one."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.chem.embed import embed_mol

    kw = dict(seed=SEED, n_steps=4, max_tries=3)
    t = te.embed_mol(mol_from_smiles("Oc1ccccc1", add_hs=True), **kw).get_conf()
    j = np.asarray(embed_mol(j_mol_from_smiles("Oc1ccccc1", add_hs=True), **kw).get_conf())
    mol = mol_from_smiles("Oc1ccccc1", add_hs=True)
    pairs, floor = te._embed_terms(mol)[4:]
    assert np.min(np.linalg.norm(t[pairs[:, 0]] - t[pairs[:, 1]], axis=1) - floor) < 0.0
    np.testing.assert_allclose(t, j, rtol=0, atol=CONF_TOL)
