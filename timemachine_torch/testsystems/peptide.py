"""A capped poly-alanine alpha-helix as PDB text: the complex leg's protein
host where no receptor PDB ships with the repository.

`capped_helix_pdb(n_ala)` writes ACE-(ALA)n-NME with every hydrogen, built
from ideal internal coordinates: an ideal right-handed alpha-helix (phi
-57, psi -47, omega 180 degrees) with the standard backbone bond lengths
(N-CA 1.458, CA-C 1.525, C-N 1.329, C=O 1.231 Angstrom) and angles (N-CA-C
111.2, CA-C-N 116.2, C-N-CA 121.7, CA-C-O 120.5 degrees). Residues are L
(N, C and CB around CA as in L-alanine). Hydrogens sit at trigonal (amide
H) or tetrahedral (HA, the methyls) positions 1.01 (N-H) or 1.09 (C-H)
Angstrom from their parent, under the PDB v3 / Amber names the residue
templates expect (H, HA, HB1-3; ACE HH31-33; NME H, HH31-33).

The helix axis lies along z, and the solute's bounding box is centred at
box_width / 2 with box_width = max(max(extent) + 1.0 nm, 2 cutoff + 0.15
nm), the cubic box md/builders.py's build_protein_system gives it without
a margin, so that its shift of the solute is zero to rounding. The text is
a pure function of `n_ala`. `pocket_offset` poses ligands beside the helix.
"""

from __future__ import annotations

import numpy as np

from timemachine_torch.constants import DEFAULT_NB_CUTOFF

N_CA, CA_C, C_N, C_O, N_H, C_H, CA_CB = 1.458, 1.525, 1.329, 1.231, 1.01, 1.09, 1.53
ANG_N_CA_C, ANG_CA_C_N, ANG_C_N_CA, ANG_CA_C_O = 111.2, 116.2, 121.7, 120.5
PHI, PSI, OMEGA = -57.0, -47.0, 180.0
TETRAHEDRAL = 109.5
PADDING_NM = 1.0  # md/builders.py's solvent padding
MIN_BOX_NM = 2 * DEFAULT_NB_CUTOFF + 0.15  # md/builders.py's smallest protein box


def _place(a, b, c, bond: float, angle: float, torsion: float) -> np.ndarray:
    """The atom d with |cd| = bond, angle(b, c, d) = angle and dihedral
    (a, b, c, d) = torsion (degrees; the natural extension reference frame)."""
    angle, torsion = np.radians(angle), np.radians(torsion)
    bc = (c - b) / np.linalg.norm(c - b)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d = np.array([-bond * np.cos(angle), bond * np.sin(angle) * np.cos(torsion), bond * np.sin(angle) * np.sin(torsion)])
    return c + d[0] * bc + d[1] * m + d[2] * n


def _unit(v):
    return v / np.linalg.norm(v)


def _trigonal_h(center, n1, n2, bond: float) -> np.ndarray:
    """An H in the plane of center's two neighbours, opposite their bisector."""
    return center + bond * _unit(_unit(center - n1) + _unit(center - n2))


def _tetrahedral_h(center, n1, n2, n3, bond: float) -> np.ndarray:
    """The fourth tetrahedral position of a centre with three neighbours."""
    return center - bond * _unit(_unit(n1 - center) + _unit(n2 - center) + _unit(n3 - center))


def _methyl(a, b, c, torsion0: float) -> list:
    """Three staggered methyl hydrogens on c, the first at dihedral torsion0 from (a, b, c)."""
    return [_place(a, b, c, C_H, TETRAHEDRAL, torsion0 + k) for k in (0.0, 120.0, 240.0)]


def capped_helix_residues(n_ala: int) -> list:
    """[(residue name, [(atom name, element, xyz in Angstrom), ...]), ...]
    in file order, before the axis is aligned and the box centred."""
    if n_ala < 1:
        raise ValueError("n_ala must be at least 1")
    # backbone: a virtual N0, ACE's CH3 (as CA0) and C (C0), then N, CA, C of each ALA, then NME's N and CH3
    n0 = np.array([0.0, 0.0, 0.0])
    ca0 = np.array([N_CA, 0.0, 0.0])
    c0 = ca0 + CA_C * np.array([-np.cos(np.radians(ANG_N_CA_C)), np.sin(np.radians(ANG_N_CA_C)), 0.0])
    ns, cas, cs = [n0], [ca0], [c0]
    for i in range(1, n_ala + 2):
        ns.append(_place(ns[i - 1], cas[i - 1], cs[i - 1], C_N, ANG_CA_C_N, PSI))
        cas.append(_place(cas[i - 1], cs[i - 1], ns[i], N_CA, ANG_C_N_CA, OMEGA))
        if i <= n_ala:
            cs.append(_place(cs[i - 1], ns[i], cas[i], CA_C, ANG_N_CA_C, PHI))
    o = [_place(ns[i], cas[i], cs[i], C_O, ANG_CA_C_O, PSI + 180.0) for i in range(n_ala + 1)]

    h31, h32, h33 = _methyl(ns[1], cs[0], cas[0], 60.0)
    residues = [("ACE", [
        ("HH31", "H", h31), ("CH3", "C", cas[0]), ("HH32", "H", h32), ("HH33", "H", h33),
        ("C", "C", cs[0]), ("O", "O", o[0]),
    ])]
    for i in range(1, n_ala + 1):
        n, ca, c = ns[i], cas[i], cs[i]
        cb = _place(c, n, ca, CA_CB, TETRAHEDRAL, -122.69)  # L: dihedral (C, N, CA, CB) = -122.69
        hb = _methyl(n, ca, cb, 60.0)
        residues.append(("ALA", [
            ("N", "N", n), ("H", "H", _trigonal_h(n, cs[i - 1], ca, N_H)),
            ("CA", "C", ca), ("HA", "H", _tetrahedral_h(ca, n, c, cb, C_H)),
            ("CB", "C", cb), ("HB1", "H", hb[0]), ("HB2", "H", hb[1]), ("HB3", "H", hb[2]),
            ("C", "C", c), ("O", "O", o[i]),
        ]))
    n, ch3 = ns[n_ala + 1], cas[n_ala + 1]
    hh = _methyl(cs[n_ala], n, ch3, 60.0)
    residues.append(("NME", [
        ("N", "N", n), ("H", "H", _trigonal_h(n, cs[n_ala], ch3, N_H)),
        ("CH3", "C", ch3), ("HH31", "H", hh[0]), ("HH32", "H", hh[1]), ("HH33", "H", hh[2]),
    ]))
    return residues


def helix_axis(ca_xyz: np.ndarray) -> np.ndarray:
    """Unit direction of the helix axis: the largest principal axis of the
    CA positions, pointing from the first residue to the last."""
    centred = ca_xyz - ca_xyz.mean(axis=0)
    axis = np.linalg.svd(centred, full_matrices=False)[2][0]
    return axis if np.dot(axis, ca_xyz[-1] - ca_xyz[0]) > 0 else -axis


def _rotation_onto_z(u: np.ndarray) -> np.ndarray:
    """The rotation matrix taking unit vector u onto +z (Rodrigues)."""
    z = np.array([0.0, 0.0, 1.0])
    v, c = np.cross(u, z), float(np.dot(u, z))
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    k = np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])
    return np.eye(3) + k + k @ k / (1.0 + c)


def capped_helix_pdb(n_ala: int) -> str:
    """PDB text of ACE-(ALA)n-NME, helix axis along z, the bounding box
    centred at box_width / 2 with box_width build_protein_system's cubic box."""
    residues = capped_helix_residues(n_ala)
    xyz = np.array([x for _, atoms in residues for _, _, x in atoms])
    ca = np.array([x for name, atoms in residues if name == "ALA" for a, _, x in atoms if a == "CA"])
    xyz = xyz @ _rotation_onto_z(helix_axis(ca)).T
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    box_width = max(float(np.max(hi - lo)) + 10.0 * PADDING_NM, 10.0 * MIN_BOX_NM)  # Angstrom
    xyz += box_width / 2.0 - (lo + hi) / 2.0

    lines = ["REMARK   capped poly-alanine alpha-helix, ideal internal coordinates"]
    serial = 0
    for resseq, (resname, atoms) in enumerate(residues, start=1):
        for name, element, _ in atoms:
            x, y, z = xyz[serial]
            serial += 1
            padded = name if len(name) == 4 else f" {name:<3}"
            lines.append(
                f"ATOM  {serial:5d} {padded:<4} {resname:>3} A{resseq:4d}    {x:8.3f}{y:8.3f}{z:8.3f}"
                f"  1.00  0.00          {element:>2}"
            )
    lines += ["TER", "END"]
    return "\n".join(lines) + "\n"


def pocket_offset(pdb_text: str, confs, distance_nm: float = 0.9) -> np.ndarray:
    """The translation (nm) that puts the centroid of the conformers `confs`
    (nm) `distance_nm` from the helix axis of `pdb_text` at its mid-length,
    on the axis' +x side: the ligands' pose beside the helix."""
    from timemachine_torch.chem.pdb import parse_pdb

    ca = np.array([r.coords[r.atom_names.index("CA")] for r in parse_pdb(pdb_text).residues if r.name == "ALA"]) / 10.0
    axis = helix_axis(ca)
    centre = ca.mean(axis=0)
    side = np.cross([0.0, 1.0, 0.0], axis)
    side /= np.linalg.norm(side)
    mid = centre + axis * np.dot((ca.max(axis=0) + ca.min(axis=0)) / 2 - centre, axis)
    return mid + distance_nm * side - np.concatenate([np.asarray(c) for c in confs]).mean(axis=0)
