"""Gasteiger-Marsili PEOE partial charges (native fallback base-charge model).

The port's copy of timemachine_tpu/ff/gasteiger.py.

Used only when a molecule carries no cached AM1-family charges and no QM
backend is available (the reference gates its AM1 path on OpenEye the same
way). Reference: Gasteiger & Marsili, Tetrahedron 36 (1980) 3219: iterative
partial equalization of orbital electronegativity with damping (1/2)^k.
"""

from __future__ import annotations

import numpy as np

from timemachine_torch.chem.mol import Mol

# (a, b, c) electronegativity polynomial coefficients chi(q) = a + b q + c q^2
# per element+hybridization, from the original PEOE parameterization.
_PARAMS = {
    ("H", None): (7.17, 6.24, -0.56),
    ("C", 3): (7.98, 9.18, 1.88),
    ("C", 2): (8.79, 9.32, 1.51),
    ("C", 1): (10.39, 9.45, 0.73),
    ("N", 3): (11.54, 10.82, 1.36),
    ("N", 2): (12.87, 11.15, 0.85),
    ("N", 1): (15.68, 11.70, -0.27),
    ("O", 3): (14.18, 12.92, 1.39),
    ("O", 2): (17.07, 13.79, 0.47),
    ("F", None): (14.66, 13.85, 2.31),
    ("Cl", None): (11.00, 9.69, 1.35),
    ("Br", None): (10.08, 8.47, 1.16),
    ("I", None): (9.90, 7.96, 0.96),
    ("S", None): (10.14, 9.13, 1.38),
    ("P", None): (8.90, 8.24, 0.96),
    ("Si", None): (8.90, 8.24, 0.96),
}

_SYM = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F", 14: "Si", 15: "P", 16: "S", 17: "Cl", 35: "Br", 53: "I"}


def _hybridization(mol: Mol, i: int) -> int:
    orders = [mol.bonds[bi].order for _, bi in mol._adjacency()[i]]
    if 3 in orders or orders.count(2) >= 2:
        return 1  # sp
    if 2 in orders or 4 in orders or mol.is_aromatic_atom(i, "mdl"):
        return 2  # sp2
    return 3  # sp3


def gasteiger_charges(mol: Mol, n_iter: int = 8) -> np.ndarray:
    n = mol.num_atoms
    coeffs = np.zeros((n, 3))
    chi_plus = np.zeros(n)
    for i, a in enumerate(mol.atoms):
        sym = _SYM.get(a.atomic_num)
        if sym is None:
            coeffs[i] = (10.0, 9.0, 1.0)  # generic
        else:
            key = (sym, _hybridization(mol, i)) if (sym, _hybridization(mol, i)) in _PARAMS else (sym, None)
            coeffs[i] = _PARAMS.get(key, _PARAMS.get((sym, None), (10.0, 9.0, 1.0)))
        a_, b_, c_ = coeffs[i]
        chi_plus[i] = 20.02 if a.atomic_num == 1 else a_ + b_ + c_

    q = mol.formal_charges.astype(np.float64).copy()
    pairs = [(b.src, b.dst) for b in mol.bonds]
    for k in range(1, n_iter + 1):
        damp = 0.5**k
        chi = coeffs[:, 0] + coeffs[:, 1] * q + coeffs[:, 2] * q * q
        dq = np.zeros(n)
        for i, j in pairs:
            if chi[j] > chi[i]:
                t = (chi[j] - chi[i]) / chi_plus[i] * damp
                dq[i] += t
                dq[j] -= t
            else:
                t = (chi[i] - chi[j]) / chi_plus[j] * damp
                dq[i] -= t
                dq[j] += t
        q = q + dq
    return q
