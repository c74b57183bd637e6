"""timemachine_torch/ff/amber_xml.py against timemachine_tpu/ff/amber_xml.py:
the shipped amber99sb.xml parses to the same force field, field by field;
assign_protein_parameters gives the same index arrays (exactly, in the same
row order) and parameters (1e-12 relative) on di-glycine with the JAX
tests' hand-built MINI_XML and on the capped helix with amber99sb; and the
protein builder falls back to the SMIRNOFF host with the same warnings in
both packages where the Amber templates do not match.
"""

import warnings

import numpy as np
import pytest
import torch

from tests.test_amber_xml import MINI_XML, digly_pdb
from timemachine_torch.chem import pdb as tpdb
from timemachine_torch.ff import amber_xml as tax
from timemachine_torch.testsystems.peptide import capped_helix_pdb
from timemachine_tpu.chem import pdb as jpdb
from timemachine_tpu.ff import amber_xml as jax_
from timemachine_tpu.ff.params import AMBER99SB_XML

torch.set_num_threads(1)  # the suite's workers share the host's cores

TOL_REL = 1e-12
INDEX_FIELDS = ("bond_idxs", "angle_idxs", "proper_idxs", "improper_idxs", "exclusion_idxs")
PARAM_FIELDS = ("charges", "lj", "masses", "bond_params", "angle_params", "proper_params", "improper_params", "exclusion_scales")


@pytest.fixture(scope="module")
def amber99sb():
    return tax.AmberForceField.parse(str(tax.AMBER99SB_XML)), jax_.AmberForceField.parse(str(AMBER99SB_XML))


@pytest.fixture(scope="module")
def mini_xml(tmp_path_factory):
    path = tmp_path_factory.mktemp("mini") / "mini.xml"
    path.write_text(MINI_XML)
    return str(path)


def test_the_port_names_the_shipped_xml():
    assert tax.AMBER99SB_XML.resolve() == AMBER99SB_XML.resolve()


@pytest.mark.parametrize(
    "field",
    ["type_element", "type_class", "type_mass", "bond_params", "angle_params", "propers", "impropers",
     "coulomb14scale", "lj14scale", "type_charge", "type_lj", "charge_from_residue"],
)
def test_parse_amber99sb_matches_jax(amber99sb, field):
    t, j = amber99sb
    assert getattr(t, field) == getattr(j, field)
    assert type(getattr(t, field)) is type(getattr(j, field))


def test_parse_amber99sb_templates_match_jax(amber99sb):
    t, j = amber99sb
    assert list(t.residues) == list(j.residues)
    assert len(t.residues) == 74
    for name, tpl in t.residues.items():
        ref = j.residues[name]
        assert (tpl.name, tpl.atom_names, tpl.atom_types, tpl.atom_charges, tpl.bonds, tpl.external) == (
            ref.name, ref.atom_names, ref.atom_types, ref.atom_charges, ref.bonds, ref.external
        )


def test_parse_mini_xml_matches_jax(mini_xml):
    t, j = tax.AmberForceField.parse(mini_xml), jax_.AmberForceField.parse(mini_xml)
    assert t.impropers == j.impropers and t.propers == j.propers and t.charge_from_residue is True
    assert {k: vars(v) for k, v in t.residues.items()} == {k: vars(v) for k, v in j.residues.items()}


def _assign(pdb_text, ff_path):
    ts = tpdb.parse_pdb(pdb_text)
    t = tax.assign_protein_parameters(ts, tpdb.protein_mol_from_pdb(ts), tax.AmberForceField.parse(ff_path))
    js = jpdb.parse_pdb(pdb_text)
    j = jax_.assign_protein_parameters(js, jpdb.protein_mol_from_pdb(js), jax_.AmberForceField.parse(ff_path))
    return t, j


CASES = {
    "digly mini": (digly_pdb, lambda mini: mini),
    "helix3 amber99sb": (lambda: capped_helix_pdb(3), lambda mini: str(AMBER99SB_XML)),
    "helix4 amber99sb": (lambda: capped_helix_pdb(4), lambda mini: str(AMBER99SB_XML)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_assign_protein_parameters_matches_jax(case, mini_xml):
    pdb_fn, xml_fn = CASES[case]
    t, j = _assign(pdb_fn(), xml_fn(mini_xml))
    assert t.atom_types == j.atom_types
    for name in INDEX_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in PARAM_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=TOL_REL, atol=0, err_msg=name)
    assert len(t.improper_idxs) > 0 and len(t.proper_idxs) > 0


def test_helix_assignment_is_neutral_with_amber_masses():
    t, _ = _assign(capped_helix_pdb(4), str(AMBER99SB_XML))
    assert abs(t.charges.sum()) < 1e-12
    assert np.all(t.masses > 0)
    # 1-4 pairs scaled by (1 - coulomb14scale, 1 - lj14scale), the XML's 0.8333333333 and 0.5; 1-2 and 1-3 full
    ff = tax.AmberForceField.parse(str(tax.AMBER99SB_XML))
    assert (ff.coulomb14scale, ff.lj14scale) == (0.8333333333, 0.5)
    assert {tuple(s) for s in t.exclusion_scales.tolist()} == {(1.0, 1.0), (1.0 - ff.coulomb14scale, 1.0 - ff.lj14scale)}


def test_unmatched_template_raises_in_both(mini_xml):
    """MINI_XML has no ALA: the helix cannot be assigned."""
    for pdb, ax in ((tpdb, tax), (jpdb, jax_)):
        s = pdb.parse_pdb(capped_helix_pdb(1))
        with pytest.raises(ax.AmberAssignmentError, match="no template matches"):
            ax.assign_protein_parameters(s, pdb.protein_mol_from_pdb(s), ax.AmberForceField.parse(mini_xml))


def test_builder_falls_back_to_smirnoff_with_jax_warnings(mini_xml, monkeypatch):
    """With the default Amber set replaced by MINI_XML (no ALA) the builder
    of each package warns that the assignment failed and that it uses the
    SMIRNOFF host; both then give the same host."""
    import timemachine_tpu.ff.params as jparams
    from timemachine_torch.md.builders import build_protein_system as t_build
    from timemachine_tpu.md.builders import build_protein_system as j_build

    monkeypatch.setattr(tax, "AMBER99SB_XML", mini_xml)
    monkeypatch.setattr(jparams, "AMBER99SB_XML", mini_xml)
    monkeypatch.delenv("TM_AMBER_XML", raising=False)  # JAX's builder reads these two; the port's does not
    monkeypatch.delenv("TM_FORCE_SMIRNOFF_HOST", raising=False)
    messages, cfgs = [], []
    for build in (t_build, j_build):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cfgs.append(build(capped_helix_pdb(1), "amber99sb", "tip3p"))
        messages.append([str(x.message) for x in w if "Amber template assignment failed" in str(x.message)
                         or "NATIVE SMIRNOFF-host" in str(x.message)])
    assert len(messages[0]) == len(messages[1]) == 2
    assert messages[0][0] == messages[1][0]  # the assignment's failure, word for word
    # the fallback's own warning, up to its advice (JAX's names its environment override, which the port has not)
    fallback = ("using NATIVE SMIRNOFF-host parameterization (framework SMIRKS typing + standard base-charge "
                "policy). This is not Amber-parity physics")
    assert all(fallback in m[1] for m in messages)
    t, j = cfgs
    for term in ("bond", "angle", "proper", "improper"):
        np.testing.assert_array_equal(getattr(t.host_system, term).potential.idxs, getattr(j.host_system, term).potential.idxs)
        np.testing.assert_allclose(getattr(t.host_system, term).params.numpy(), np.asarray(getattr(j.host_system, term).params),
                                   rtol=TOL_REL, atol=0)
    np.testing.assert_allclose(t.host_system.nonbonded_all_pairs.params.numpy(),
                               np.asarray(j.host_system.nonbonded_all_pairs.params), rtol=TOL_REL, atol=0)
    np.testing.assert_array_equal(t.masses, j.masses)


@pytest.mark.parametrize("pdb_text", ["digly", "helix"])
def test_builder_takes_a_path_like_protein_ff(pdb_text, mini_xml):
    """protein_ff naming an XML file selects that XML: digly, which MINI_XML
    covers, builds the same host in both packages; the helix, which it does
    not cover, raises AmberAssignmentError in both (no SMIRNOFF fallback for
    an XML the caller named)."""
    from timemachine_torch.md.builders import build_protein_system as t_build
    from timemachine_tpu.md.builders import build_protein_system as j_build

    text = digly_pdb() if pdb_text == "digly" else capped_helix_pdb(1)
    if pdb_text == "helix":
        with pytest.raises(tax.AmberAssignmentError):
            t_build(text, mini_xml, "tip3p")
        with pytest.raises(jax_.AmberAssignmentError):
            j_build(text, mini_xml, "tip3p")
        return
    t, j = t_build(text, mini_xml, "tip3p"), j_build(text, mini_xml, "tip3p")
    for term in ("bond", "angle", "proper", "improper"):
        np.testing.assert_array_equal(getattr(t.host_system, term).potential.idxs, getattr(j.host_system, term).potential.idxs)
        np.testing.assert_allclose(getattr(t.host_system, term).params.numpy(), np.asarray(getattr(j.host_system, term).params),
                                   rtol=TOL_REL, atol=0)
    np.testing.assert_allclose(t.host_system.nonbonded_all_pairs.params.numpy(),
                               np.asarray(j.host_system.nonbonded_all_pairs.params), rtol=TOL_REL, atol=0)
    np.testing.assert_array_equal(t.conf, j.conf)
