"""timemachine_torch/chem/pdb.py against timemachine_tpu/chem/pdb.py: the
same PDB text parses to the same structure and perceives to the same
protein graph (atoms, bonds with orders, formal charges, coordinates), and
the same broken valence raises PDBChemistryError in both. Also the capped
helix of timemachine_torch/testsystems/peptide.py: L residues, neutral, its
geometry and build_protein_system's zero shift.

The inputs are the JAX package's own test peptides: di-glycine
(tests/test_amber_xml.py digly_pdb) and the broken serine of
tests/test_protein_builder.py (copied).
"""

import numpy as np
import pytest
import torch

from timemachine_torch.chem import pdb as tpdb
from tests.test_amber_xml import _pdb_line, digly_pdb
from timemachine_torch.testsystems.peptide import capped_helix_pdb, capped_helix_residues, helix_axis
from timemachine_tpu.chem import pdb as jpdb

torch.set_num_threads(1)  # the suite's workers share the host's cores


BROKEN_SERINE_LIKE = "\n".join(
    [
        "ATOM      1  N   GLY A   1       0.000   0.000   0.000  1.00  0.00           N",
        "ATOM      2  CA  GLY A   1       1.450   0.000   0.000  1.00  0.00           C",
        "ATOM      3  C   GLY A   1       2.000   1.400   0.000  1.00  0.00           C",
        "ATOM      4  O   GLY A   1       1.300   2.400   0.000  1.00  0.00           O",
    ]
)

WATER_BOX_PDB = "\n".join(
    [
        "CRYST1   18.000   19.000   20.000  90.00  90.00  90.00 P 1           1",
        "HETATM    1  O   HOH W   1       1.000   1.000   1.000  1.00  0.00           O",
        "HETATM    2  H1  HOH W   1       1.957   1.000   1.000  1.00  0.00           H",
        "HETATM    3  H2  HOH W   1       0.760   1.927   1.000  1.00  0.00           H",
        "HETATM    4 NA    NA I   2       5.000   5.000   5.000  1.00  0.00          NA",
    ]
)

PDB_TEXTS = {
    "digly": digly_pdb,
    "helix1": lambda: capped_helix_pdb(1),
    "helix3": lambda: capped_helix_pdb(3),
    "helix4": lambda: capped_helix_pdb(4),
}

# the wwPDB Chemical Component Dictionary's ideal L-alanine (ALA), Angstrom: N, CA, C, CB
L_ALA_IDEAL = np.array([[-0.966, 0.493, 1.500], [0.257, 0.418, 0.692], [-0.094, 0.017, -0.716], [1.204, -0.620, 1.296]])


def _chiral_volume(n, ca, c, cb) -> float:
    return float(np.dot(n - ca, np.cross(c - ca, cb - ca)))


def _structure_fields(s):
    def res(r):
        return (r.name, r.chain, r.resseq, list(r.atom_names), list(r.elements), np.asarray(r.coords).tolist())

    return [res(r) for r in s.residues], [res(r) for r in s.waters], [res(r) for r in s.ions]


@pytest.mark.parametrize("name", sorted(PDB_TEXTS))
def test_parse_pdb_matches_jax(name):
    text = PDB_TEXTS[name]()
    t, j = tpdb.parse_pdb(text), jpdb.parse_pdb(text)
    assert _structure_fields(t) == _structure_fields(j)
    assert t.box is None and j.box is None


def test_parse_pdb_reads_a_path_and_cryst1_like_jax(tmp_path):
    path = tmp_path / "water.pdb"
    path.write_text(WATER_BOX_PDB + "\n")
    t, j = tpdb.parse_pdb(str(path)), jpdb.parse_pdb(str(path))
    assert _structure_fields(t) == _structure_fields(j)
    np.testing.assert_array_equal(t.box, j.box)
    np.testing.assert_array_equal(t.box, np.diag([1.8, 1.9, 2.0]))
    assert [r.elements for r in t.ions] == [["Na"]]


@pytest.mark.parametrize("name", sorted(PDB_TEXTS))
def test_protein_mol_matches_jax(name):
    text = PDB_TEXTS[name]()
    t = tpdb.protein_mol_from_pdb(tpdb.parse_pdb(text))
    j = jpdb.protein_mol_from_pdb(jpdb.parse_pdb(text))
    np.testing.assert_array_equal(t.atomic_nums, j.atomic_nums)
    np.testing.assert_array_equal(t.formal_charges, j.formal_charges)
    assert [(b.src, b.dst, b.order) for b in t.bonds] == [(b.src, b.dst, b.order) for b in j.bonds]
    np.testing.assert_array_equal(t.coords, j.coords)
    assert t.total_charge() == j.total_charge()
    assert t.total_charge() == 0  # digly: its NH3+ and COO- cancel


def test_digly_termini_are_charged_in_both():
    t = tpdb.protein_mol_from_pdb(tpdb.parse_pdb(digly_pdb()))
    assert t.formal_charges[0] == 1 and t.formal_charges[16] == -1


def test_broken_valence_raises_in_both():
    with pytest.raises(tpdb.PDBChemistryError):
        tpdb.protein_mol_from_pdb(tpdb.parse_pdb(BROKEN_SERINE_LIKE))
    with pytest.raises(jpdb.PDBChemistryError):
        jpdb.protein_mol_from_pdb(jpdb.parse_pdb(BROKEN_SERINE_LIKE))


def test_far_hydrogen_raises_in_both():
    lines = digly_pdb().splitlines()
    lines[1] = _pdb_line(2, "H1", "GLY", "A", 1, -2.5, 0.8, 0.0, "H")  # 2.6 A from N
    text = "\n".join(lines)
    for pdb in (tpdb, jpdb):
        with pytest.raises(pdb.PDBChemistryError, match="from the nearest heavy atom"):
            pdb.protein_mol_from_pdb(pdb.parse_pdb(text))


@pytest.mark.parametrize("n_ala", [1, 3, 24])
def test_helix_residues_are_l(n_ala):
    """Every CA's chiral volume (N - CA) . ((C - CA) x (CB - CA)) has the
    sign of the CCD's ideal L-alanine."""
    assert _chiral_volume(*L_ALA_IDEAL) > 0
    s = tpdb.parse_pdb(capped_helix_pdb(n_ala))
    alas = [r for r in s.residues if r.name == "ALA"]
    assert len(alas) == n_ala
    for r in alas:
        xyz = {nm: np.asarray(x) for nm, x in zip(r.atom_names, r.coords)}
        assert _chiral_volume(xyz["N"], xyz["CA"], xyz["C"], xyz["CB"]) > 0


def test_helix_geometry():
    """Bond lengths and the backbone dihedrals of the ideal helix (before
    the file's 3-decimal rounding), every H at 1.01-1.09 A of its parent,
    the axis along z and the bounding box centred at half build_protein_system's box,
    max(extent + 1 nm, 2.55 nm)."""

    def dihedral(a, b, c, d):
        b0, b1, b2 = a - b, (c - b) / np.linalg.norm(c - b), d - c
        v, w = b0 - np.dot(b0, b1) * b1, b2 - np.dot(b2, b1) * b1
        return np.degrees(np.arctan2(np.dot(np.cross(b1, v), w), np.dot(v, w)))

    res = capped_helix_residues(6)
    bb = [{nm: x for nm, _, x in atoms} for name, atoms in res if name == "ALA"]
    for i in range(1, len(bb) - 1):
        assert dihedral(bb[i - 1]["C"], bb[i]["N"], bb[i]["CA"], bb[i]["C"]) == pytest.approx(-57.0, abs=1e-9)
        assert dihedral(bb[i]["N"], bb[i]["CA"], bb[i]["C"], bb[i + 1]["N"]) == pytest.approx(-47.0, abs=1e-9)
        assert abs(dihedral(bb[i]["CA"], bb[i]["C"], bb[i + 1]["N"], bb[i + 1]["CA"])) == pytest.approx(180.0, abs=1e-9)
        assert np.linalg.norm(bb[i]["CA"] - bb[i]["N"]) == pytest.approx(1.458)

    s = tpdb.parse_pdb(capped_helix_pdb(6))
    mol = tpdb.protein_mol_from_pdb(s)
    x = mol.coords
    for b in mol.bonds:
        if mol.atoms[b.dst].atomic_num == 1:
            assert 1.005 <= np.linalg.norm(x[b.src] - x[b.dst]) <= 1.095
    ca = np.array([r.coords[r.atom_names.index("CA")] for r in s.residues if r.name == "ALA"])
    assert abs(helix_axis(ca)[2]) > 1 - 1e-4
    lo, hi = x.min(axis=0), x.max(axis=0)
    np.testing.assert_allclose((lo + hi) / 2, max(np.max(hi - lo) + 10.0, 25.5) / 2, atol=1e-3)
    assert capped_helix_pdb(6) == capped_helix_pdb(6)
