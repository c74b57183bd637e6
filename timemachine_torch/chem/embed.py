"""3D conformer embedding (the port of timemachine_tpu/chem/embed.py): a
physically reasonable starting geometry for minimization and MD, not a
conformer ensemble.

BFS placement with idealized bond lengths, then a staged relaxation (bonds,
hybridization angles and a soft nonbonded floor) under FIRE with per-atom
force clipping, retried over seeds until no nonbonded pair sits inside its
contact floor. It runs on the host in torch float64; the relaxation's force
is autograd of the embedding energy, as JAX's is jax.grad of it. The BFS
placement draws from numpy's default_rng(seed), as JAX's does, so both
packages start from the same coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.chem.mol import Mol
from timemachine_torch.md.fire import FireMinimizationConfig, fire_minimize
from timemachine_torch.ops.bonded import stable_angle

# covalent radii (nm) for common elements
_COV_RADII = {1: 0.031, 5: 0.085, 6: 0.076, 7: 0.071, 8: 0.066, 9: 0.057, 14: 0.111,
              15: 0.107, 16: 0.105, 17: 0.102, 35: 0.120, 53: 0.139}


def _ideal_bond_length(mol: Mol, i: int, j: int) -> float:
    r = _COV_RADII.get(mol.atoms[i].atomic_num, 0.1) + _COV_RADII.get(mol.atoms[j].atomic_num, 0.1)
    b = mol.get_bond(i, j)
    if b is not None and b.order == 2:
        r *= 0.92
    elif b is not None and b.order == 3:
        r *= 0.86
    return r


def _ideal_angle(mol: Mol, j: int) -> float:
    """Idealized angle at center j from hybridization."""
    orders = [mol.bonds[bi].order for _, bi in mol._adjacency()[j]]
    deg = mol.total_connectivity(j)
    if 3 in orders or deg == 2 and 2 in orders and orders.count(2) >= 2:
        return np.pi
    if 2 in orders or 4 in orders or deg == 3 and mol.atoms[j].atomic_num == 6:
        return 2 * np.pi / 3
    return np.deg2rad(109.47)


def embed_mol(mol: Mol, seed: int = 2024, n_steps: int = 4000, max_tries: int = 6) -> Mol:
    """Assign 3D coordinates (nm, stored on mol's conformer). Returns mol.

    Retries with fresh random placements until the relaxed geometry has no
    steric clash (a nonbonded pair closer than its contact floor); keeps
    the least-clashing attempt if none fully succeeds."""
    best = None  # (min margin over floor, coords)
    for attempt in range(max_tries):
        coords, min_margin = _embed_once(mol, seed + 7919 * attempt, n_steps)
        if best is None or min_margin > best[0]:
            best = (min_margin, coords)
        if min_margin >= 0.0:
            break
    mol.set_conf(best[1])
    return mol


def _contact_floor(anum_i: int, anum_j: int) -> float:
    """Minimum acceptable nonbonded separation (nm): below this, real LJ is
    catastrophically repulsive. H pairs may sit closer than heavy pairs."""
    n_h = (anum_i == 1) + (anum_j == 1)
    return (0.16, 0.19, 0.24)[2 - n_h]


def _bfs_placement(mol: Mol, rng) -> np.ndarray:
    """Coordinates placed component by component, each neighbour one ideal
    bond length from its parent in a random direction."""
    n = mol.num_atoms
    coords = np.zeros((n, 3))
    placed = np.zeros(n, dtype=bool)
    for root in range(n):
        if placed[root]:
            continue
        coords[root] = rng.normal(0, 0.05, 3) + (placed.sum() * 0.5)
        placed[root] = True
        queue = [root]
        while queue:
            cur = queue.pop(0)
            for nb in mol.neighbors(cur):
                if placed[nb]:
                    continue
                direction = rng.normal(size=3)
                direction /= np.linalg.norm(direction)
                coords[nb] = coords[cur] + direction * _ideal_bond_length(mol, cur, nb)
                placed[nb] = True
                queue.append(nb)
    return coords


def _embed_terms(mol: Mol):
    """(bond_idxs, bond_r0, angle_idxs, angle_t0, pairs, pair_floor): the
    idealized bonds and angles, and the pairs outside 1-2 and 1-3 with their
    contact floors."""
    n = mol.num_atoms
    bond_idxs = np.array([[b.src, b.dst] for b in mol.bonds], dtype=np.int32).reshape(-1, 2)
    bond_r0 = np.array([_ideal_bond_length(mol, i, j) for i, j in bond_idxs])
    angle_rows, angle_t0 = [], []
    for j in range(n):
        nbs = mol.neighbors(j)
        for a in range(len(nbs)):
            for b in range(a + 1, len(nbs)):
                angle_rows.append((nbs[a], j, nbs[b]))
                angle_t0.append(_ideal_angle(mol, j))
    angle_idxs = np.array(angle_rows, dtype=np.int32).reshape(-1, 3)
    angle_t0 = np.array(angle_t0)

    excl = {(min(i, j), max(i, j)) for i, j in bond_idxs}
    excl |= {(min(a, b), max(a, b)) for a, _, b in angle_idxs}
    pairs = np.array([(i, j) for i in range(n) for j in range(i + 1, n) if (i, j) not in excl], dtype=np.int32)
    pairs = pairs.reshape(-1, 2)
    anums = np.array([a.atomic_num for a in mol.atoms])
    pair_floor = np.array([_contact_floor(anums[i], anums[j]) for i, j in pairs]) if len(pairs) else np.zeros(0)
    return bond_idxs, bond_r0, angle_idxs, angle_t0, pairs, pair_floor


def _make_force(terms, k_rep: float):
    """-dU/dx of the embedding energy at repulsion stiffness k_rep, NaN
    components zeroed and each atom's force clipped to norm 1e4."""
    bond_idxs, bond_r0, angle_idxs, angle_t0, pairs, pair_floor = terms
    f64 = torch.float64
    b_i, b_j = (torch.as_tensor(bond_idxs[:, c], dtype=torch.int64) for c in (0, 1))
    r0 = torch.as_tensor(bond_r0, dtype=f64)
    a_idx = [torch.as_tensor(angle_idxs[:, c], dtype=torch.int64) for c in range(3)]
    t0 = torch.as_tensor(angle_t0, dtype=f64)
    eps = torch.full((len(angle_idxs),), 1e-4, dtype=f64)
    p_i, p_j = (torch.as_tensor(pairs[:, c], dtype=torch.int64) for c in (0, 1))
    floor = torch.as_tensor(pair_floor, dtype=f64)

    def u_embed(x):
        # harmonic bonds at k = 1e5 (JAX's harmonic_bond with its d == 0 guard)
        dx = x[b_i] - x[b_j]
        d2 = torch.sum(dx * dx, dim=-1)
        d = torch.where(d2 > 0, torch.sqrt(torch.where(d2 > 0, d2, 1.0)), 0.0)
        u = torch.sum(0.5 * 1e5 * (d - r0) ** 2)
        if len(angle_idxs):
            theta = stable_angle(x[a_idx[0]], x[a_idx[1]], x[a_idx[2]], eps)
            u = u + torch.sum(0.5 * 200.0 * (theta - t0) ** 2)
        if len(pairs):
            dp = x[p_i] - x[p_j]
            dist = torch.sqrt(torch.clamp(torch.sum(dp * dp, dim=1), min=1e-8))
            # half-harmonic floor at the per-pair contact distance
            viol = torch.clamp(floor - dist, min=0.0)
            u = u + torch.sum(0.5 * k_rep * viol**2)
        return u

    def force(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(u_embed(xg), xg)
        g = torch.where(torch.isnan(g), 0.0, g)
        norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
        return -g * torch.clamp(1e4 / torch.clamp(norm, min=1e-12), max=1.0)

    return force


def _embed_once(mol: Mol, seed: int, n_steps: int) -> tuple[np.ndarray, float]:
    coords = _bfs_placement(mol, np.random.default_rng(seed))
    terms = _embed_terms(mol)
    pairs, pair_floor = terms[4], terms[5]

    # stage 1: gentle repulsion lets ring topology settle without tearing
    # bonds; stage 2: a firm floor expels residual interlocks
    x = torch.as_tensor(coords, dtype=torch.float64)
    x = fire_minimize(x, _make_force(terms, 2e2), FireMinimizationConfig(n_steps // 2, dt_max=2e-3))
    x = fire_minimize(x, _make_force(terms, 2e4), FireMinimizationConfig(n_steps, dt_max=2e-3))

    x = x.numpy()
    if len(pairs):
        d = np.linalg.norm(x[pairs[:, 0]] - x[pairs[:, 1]], axis=1)
        min_margin = float(np.min(d - pair_floor))
    else:
        min_margin = np.inf
    return x, min_margin
