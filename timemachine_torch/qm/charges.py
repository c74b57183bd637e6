"""AM1-family base charges for Mol objects, computed natively (the port's
copy of timemachine_tpu/qm/charges.py; where the conformer is degenerate,
both embed one with chem/embed.py's embed_mol).

Replaces the reference's OpenEye charge backend
(`timemachine/ff/handlers/nonbonded.py:343-520`, `oe_assign_charges`) with
the in-repo AM1 SCF (`timemachine_torch.qm.scf`). Differences vs OpenEye,
stated explicitly:

* Geometry: charges are computed at the molecule's input conformer (SDF /
  embedded coordinates) rather than at an AM1-optimized geometry.
* "ELF10": OpenEye averages charges over up to 10 electrostatically-least-
  interacting conformers. Here the per-conformer spread is approximated by
  averaging over topological symmetry classes (Weisfeiler-Lehman orbits),
  which captures the dominant effect (equivalent methyl/ring positions
  symmetrized) without a conformer ensemble.
* AM1BCC: OpenEye applies the Jakalian et al. (2002) BCC table. Natively we
  apply the shipped AM1CCC correction set (smirnoff_1_1_0_ccc) on top of
  AM1ELF10 — the CCC set was trained to reproduce AM1BCC charges (see the
  reference's `AM1CCCHandler` docstring), so this is an in-distribution
  surrogate with published provenance.

All functions return charges in electron units; callers scale by
sqrt(ONE_4PI_EPS0) (the reference convention) at the handler layer.
"""

import numpy as np

from timemachine_torch.qm.scf import am1


def _degenerate(conf_nm: np.ndarray) -> bool:
    """True when coordinates cannot support a QM calculation: any two
    atoms closer than 0.04 nm (0.4 Angstrom, far under any bond length)."""
    n = len(conf_nm)
    if n < 2:
        return False
    d = np.linalg.norm(conf_nm[:, None, :] - conf_nm[None, :, :], axis=-1)
    d[np.diag_indices(n)] = np.inf
    return bool(d.min() < 0.04)


def topological_symmetry_classes(mol) -> np.ndarray:
    """Weisfeiler-Lehman orbit labels: atoms with identical labels are
    topologically equivalent (same element/charge/degree environment to
    all depths). Used to symmetrize conformer-dependent AM1 charges."""
    n = mol.num_atoms
    z = mol.atomic_nums
    fc = mol.formal_charges
    labels = [hash((int(z[i]), int(fc[i]), mol.degree(i))) for i in range(n)]
    for _ in range(n):
        new = [
            hash((labels[i], tuple(sorted(labels[j] for j in mol.neighbors(i)))))
            for i in range(n)
        ]
        if len(set(new)) == len(set(labels)):
            labels = new
            break
        labels = new
    uniq = {lab: k for k, lab in enumerate(dict.fromkeys(labels))}
    return np.array([uniq[lab] for lab in labels], dtype=np.int32)


def symmetrize_charges(mol, q: np.ndarray) -> np.ndarray:
    """Average charges over topological symmetry classes. Exactly preserves
    the net charge (projection onto the class-constant subspace)."""
    classes = topological_symmetry_classes(mol)
    out = np.array(q, dtype=np.float64)
    for c in np.unique(classes):
        sel = classes == c
        out[sel] = out[sel].mean()
    return out


def am1_mol_charges(mol, symmetrize: bool = True) -> np.ndarray:
    """AM1 Coulson charges (e units) at the molecule's conformer.

    Raises ValueError for unsupported elements / open-shell species and
    SCFConvergenceError when the SCF stalls — callers treat both as
    "native backend unavailable for this molecule"."""
    conf_nm = np.asarray(mol.get_conf(), dtype=np.float64)
    if _degenerate(conf_nm):
        # no real 3D conformer on the molecule: embed one, mirroring the
        # reference backend which generates conformers (omega) before AM1
        from timemachine_torch.chem import embed

        conf_nm = np.asarray(embed.embed_mol(mol.copy()).get_conf(), dtype=np.float64)
        if _degenerate(conf_nm):
            raise ValueError("conformer embedding produced degenerate coordinates")
    coords_ang = conf_nm * 10.0
    res = am1(list(mol.atomic_nums), coords_ang, int(mol.total_charge()))
    q = res.charges
    if symmetrize:
        q = symmetrize_charges(mol, q)
    return q


def am1bcc_mol_charges(mol) -> np.ndarray:
    """AM1BCC-equivalent charges (e units): AM1ELF10-style base + the
    shipped AM1CCC correction set (trained against AM1BCC; see module
    docstring). Net charge is preserved exactly by construction."""
    from timemachine_torch import constants
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.ff.handlers import (
        apply_bond_charge_corrections,
        compute_or_load_bond_smirks_matches,
    )

    q = am1_mol_charges(mol, symmetrize=True)
    ff = Forcefield.load_from_file("smirnoff_1_1_0_ccc")
    ccc = ff.q_handle
    bond_idxs, type_idxs = compute_or_load_bond_smirks_matches(mol, ccc.smirks)
    deltas = np.asarray(ccc.params)[type_idxs] / np.sqrt(constants.ONE_4PI_EPS0)
    return np.asarray(apply_bond_charge_corrections(q, bond_idxs, deltas))
