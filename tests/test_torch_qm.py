"""The port's AM1 (timemachine_torch/qm) against timemachine_tpu/qm: AM1,
AM1ELF10-style symmetrized and AM1BCC charges within 1e-10 e on ethanol,
propane, toluene, phenol and acetate, each at one conformer handed to both
packages (tests/test_torch_chem.py conformer: the RBFE cache's for the edge,
the JAX package's embedding at seed 7 for the others); a degenerate
conformer embedded by each package's embed_mol, the charges within the same
1e-10 e."""

import numpy as np
import pytest
import torch

from tests.test_torch_chem import QM_PANEL, mol_pair
from timemachine_torch.chem import embed as tembed
from timemachine_torch.qm import charges as tq
from timemachine_torch.qm import scf as tscf
from timemachine_tpu.qm import charges as jq
from timemachine_tpu.qm import scf as jscf

torch.set_num_threads(1)  # the suite's workers share the host's cores

TOL = 1e-10  # e; LAPACK's eigensolver may differ in the last bits between machines


@pytest.mark.parametrize("smiles", QM_PANEL)
def test_am1_scf_matches_jax(smiles):
    j, t = mol_pair(smiles)
    ang = t.get_conf() * 10.0
    rj = jscf.am1(list(j.atomic_nums), ang, int(j.total_charge()))
    rt = tscf.am1(list(t.atomic_nums), ang, int(t.total_charge()))
    np.testing.assert_allclose(rt.charges, rj.charges, rtol=0, atol=TOL)
    assert abs(rt.charges.sum() - t.total_charge()) < 1e-8


@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("smiles", QM_PANEL)
def test_am1_mol_charges_match_jax(smiles, symmetrize):
    j, t = mol_pair(smiles)
    np.testing.assert_allclose(
        tq.am1_mol_charges(t, symmetrize=symmetrize), jq.am1_mol_charges(j, symmetrize=symmetrize), rtol=0, atol=TOL
    )


@pytest.mark.parametrize("smiles", QM_PANEL)
def test_am1bcc_mol_charges_match_jax(smiles):
    j, t = mol_pair(smiles)
    np.testing.assert_allclose(tq.am1bcc_mol_charges(t), np.asarray(jq.am1bcc_mol_charges(j)), rtol=0, atol=TOL)


def test_degenerate_conformer_raises_without_embedding(monkeypatch):
    """Where embedding leaves the conformer degenerate (embed_mol patched to
    return the molecule as it is), am1_mol_charges raises ValueError, as
    JAX's does; the handlers then fall back or, strict, fail."""
    _, t = mol_pair("CCO")
    t.set_conf(np.zeros((t.num_atoms, 3)))
    monkeypatch.setattr(tembed, "embed_mol", lambda mol, *args, **kwargs: mol)
    with pytest.raises(ValueError, match="degenerate"):
        tq.am1_mol_charges(t)


@pytest.mark.parametrize("smiles", ["CCO", "CCC"])
def test_degenerate_conformer_is_embedded_as_in_jax(smiles):
    """A degenerate conformer (every atom at the origin) is embedded with
    embed_mol's default seed in both packages, leaving the molecule's own
    conformer as it was, and the charges at the embedded conformer agree
    within TOL."""
    j, t = mol_pair(smiles)
    for m in (j, t):
        m.set_conf(np.zeros((m.num_atoms, 3)))
    np.testing.assert_allclose(tq.am1_mol_charges(t), jq.am1_mol_charges(j), rtol=0, atol=TOL)
    assert not t.get_conf().any()
