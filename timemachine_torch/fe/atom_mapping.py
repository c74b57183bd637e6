"""Atom mapping: enumerate alchemical cores that maximize mapped edges.

Capability target: reference timemachine/fe/atom_mapping.py — distance-gated
candidate predicates (ring/chain cutoffs over the pre-aligned conformers), the
McGregor branch-and-bound MCS search (fe/mcgregor.py here), chirality and
planar-torsion admissibility filters, and a joint ranking of the surviving
cores by (core bonds broken, valence mismatch, mean-square displacement).

Internally organized around a frozen `_SearchConfig` (the knobs appear once)
and fully vectorized candidate/ranking passes; the search itself runs in the
native C++ module (fe/mcgregor_native.py, built at first use with g++), with
the pure-Python mcgregor module as the executable spec and fallback.

The port's copy of timemachine_tpu/fe/atom_mapping.py.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np

from timemachine_torch.fe import mcgregor
from timemachine_torch.fe.chiral_utils import (
    ChiralRestrIdxSet,
    enumerate_planar_torsions,
    has_chiral_atom_flips,
    setup_find_flipped_planar_torsions,
)
from timemachine_torch.fe.utils import get_romol_conf  # noqa: F401  (re-export parity)


class AtomMappingError(Exception):
    pass


@dataclass(frozen=True)
class _SearchConfig:
    """Every knob of the MCS search, bundled so the plumbing names them once."""

    ring_cutoff: float
    chain_cutoff: float
    max_visits: int
    max_connected_components: Optional[int]
    min_connected_component_size: int
    max_cores: int
    enforce_core_core: bool
    ring_matches_ring_only: bool
    enforce_chiral: bool
    disallow_planar_torsion_flips: bool
    min_threshold: int


def get_cores_and_diagnostics(
    mol_a,
    mol_b,
    ring_cutoff,
    chain_cutoff,
    max_visits,
    max_connected_components: Optional[int],
    min_connected_component_size: int,
    max_cores,
    enforce_core_core,
    ring_matches_ring_only,
    enforce_chiral,
    disallow_planar_torsion_flips,
    min_threshold,
    initial_mapping,
):
    """Cores plus the search's MCSDiagnostics (ref atom_mapping.py:49-92).

    The search requires |A| <= |B|; when A is larger the roles are swapped and
    every resulting core (and the seed mapping) has its columns flipped back.
    """
    if max_cores <= 0:
        raise ValueError("max_cores must be positive")
    cfg = _SearchConfig(
        ring_cutoff,
        chain_cutoff,
        max_visits,
        max_connected_components,
        min_connected_component_size,
        max_cores,
        enforce_core_core,
        ring_matches_ring_only,
        enforce_chiral,
        disallow_planar_torsion_flips,
        min_threshold,
    )
    seed = np.zeros((0, 2)) if initial_mapping is None else np.asarray(initial_mapping).reshape(-1, 2)

    if mol_a.num_atoms <= mol_b.num_atoms:
        return _search(cfg, mol_a, mol_b, seed)
    cores, diag = _search(cfg, mol_b, mol_a, seed[:, ::-1])
    return [c[:, ::-1] for c in cores], diag


def get_cores(
    mol_a,
    mol_b,
    ring_cutoff,
    chain_cutoff,
    max_visits,
    max_connected_components: Optional[int],
    min_connected_component_size: int,
    max_cores,
    enforce_core_core,
    ring_matches_ring_only,
    enforce_chiral,
    disallow_planar_torsion_flips,
    min_threshold,
    initial_mapping,
):
    """Cores sorted by (core bonds broken, valence changes, alignment msd)
    (ref atom_mapping.py:94-194). Raises mcgregor.NoMappingError if none."""
    cores, _ = get_cores_and_diagnostics(
        mol_a,
        mol_b,
        ring_cutoff,
        chain_cutoff,
        max_visits,
        max_connected_components,
        min_connected_component_size,
        max_cores,
        enforce_core_core,
        ring_matches_ring_only,
        enforce_chiral,
        disallow_planar_torsion_flips,
        min_threshold,
        initial_mapping,
    )
    return cores


# ---------------------------------------------------------------------------
# candidate construction


def _degree_order(mol, seed):
    """Permutation of A's atoms: seeded atoms first, then by descending degree.

    Unmapping a vertex costs pruning power proportional to its degree, so
    high-degree vertices are decided early (ref atom_mapping.py:196-214).
    Returns (perm, seed expressed in the permuted numbering).
    """
    key = np.array([mol.degree(i) for i in range(mol.num_atoms)], dtype=np.float64)
    if len(seed):
        key[seed[:, 0].astype(int)] = np.inf
    perm = np.argsort(key, kind="stable")[::-1]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    new_seed = np.stack([inv[seed[:, 0].astype(int)], seed[:, 1].astype(int)], axis=1) if len(seed) else seed
    return perm, new_seed.reshape(-1, 2).astype(int)


def _candidate_lists(cfg: _SearchConfig, mol_a, mol_b, conf_a, conf_b, seed):
    """Per-A-atom candidate B atoms, nearest first.

    Vectorized form of the reference's per-atom loop (atom_mapping.py:276-302):
    one (n_a, n_b) distance matrix, a broadcast ring/chain cutoff matrix, and
    optionally a ring-parity mask. Seeded A atoms get exactly their pinned
    partner.
    """
    dij = np.linalg.norm(conf_a[:, None, :] - conf_b[None, :, :], axis=-1)
    ring_a = np.array([mol_a.atom_in_ring(i) for i in range(mol_a.num_atoms)], dtype=bool)
    ring_b = np.array([mol_b.atom_in_ring(j) for j in range(mol_b.num_atoms)], dtype=bool)

    either_ring = ring_a[:, None] | ring_b[None, :]
    cutoffs = np.where(either_ring, cfg.ring_cutoff, cfg.chain_cutoff)
    allowed = dij < cutoffs
    if cfg.ring_matches_ring_only:
        allowed &= ring_a[:, None] == ring_b[None, :]

    order = np.argsort(dij, axis=1, kind="stable")
    lists = [[int(j) for j in order[i] if allowed[i, j]] for i in range(mol_a.num_atoms)]
    for i, j in seed:
        lists[int(i)] = [int(j)]
    return lists


def _admissibility(cfg: _SearchConfig, mol_a, mol_b, conf_a, conf_b):
    """Trial-core predicates (chirality preservation, planar-torsion sign) and
    the precomputed structures the native search consumes for the same checks."""
    predicates = []
    native_kwargs: dict = {}

    if cfg.enforce_chiral:
        chiral_a = ChiralRestrIdxSet.from_mol(mol_a, conf_a)
        chiral_b = ChiralRestrIdxSet.from_mol(mol_b, conf_b)
        predicates.append(lambda trial: not has_chiral_atom_flips(trial, chiral_a, chiral_b))
        native_kwargs["chiral_quartets_a"] = np.array(chiral_a.restr_idxs, dtype=np.int32).reshape(-1, 4)
        native_kwargs["disallowed_quartets_b"] = sorted(chiral_b.disallowed_set)

    if cfg.disallow_planar_torsion_flips:
        find_flipped = setup_find_flipped_planar_torsions(mol_a, mol_b)
        predicates.append(lambda trial: next(find_flipped(trial), None) is None)

        pt_a = enumerate_planar_torsions(mol_a)
        pt_b = dict(enumerate_planar_torsions(mol_b))
        pt_b.update({quartet[::-1]: sign for quartet, sign in list(pt_b.items())})
        native_kwargs["planar_torsions_a"] = np.array(list(pt_a.keys()), dtype=np.int32).reshape(-1, 4)
        native_kwargs["planar_signs_a"] = np.array(list(pt_a.values()), dtype=np.int8)
        native_kwargs["planar_torsions_b"] = np.array(list(pt_b.keys()), dtype=np.int32).reshape(-1, 4)
        native_kwargs["planar_signs_b"] = np.array(list(pt_b.values()), dtype=np.int8)

    return (lambda trial: all(p(trial) for p in predicates)), native_kwargs


def _native_search():
    """mcgregor_native.mcs_native with its library built, or None (with a
    warning that names the build error) where it cannot be built."""
    from timemachine_torch.fe import mcgregor_native
    from timemachine_torch.native import NativeBuildError

    try:
        mcgregor_native.load_library()
    except (NativeBuildError, OSError) as e:  # no toolchain, or a library that will not load: the Python search
        warnings.warn(f"native MCS unavailable ({e}); using the pure-Python search")
        return None
    return mcgregor_native.mcs_native


# ---------------------------------------------------------------------------
# ranking


def core_bonds_broken_count(mol_a, mol_b, core):
    """Bonds of A whose endpoints are both mapped but whose images are not
    bonded in B (ref atom_mapping.py:234-247)."""
    a_to_b = {int(a): int(b) for a, b in core}
    return sum(
        1
        for bond in mol_a.bonds
        if bond.src in a_to_b and bond.dst in a_to_b and mol_b.get_bond(a_to_b[bond.src], a_to_b[bond.dst]) is None
    )


def remove_cores_smaller_than_largest(cores):
    """Keep only maximum-size cores (ref atom_mapping.py:396-404)."""
    if not cores:
        return cores
    top = max(len(c) for c in cores)
    return [c for c in cores if len(c) == top]


def _dedupe(cores):
    seen: dict = {}
    for core in cores:
        seen.setdefault(frozenset((int(a), int(b)) for a, b in core), core)
    return list(seen.values())


def _rank_cores(mol_a, mol_b, conf_a, conf_b, cores):
    """Ranking permutation over cores by the reference's joint key: broken
    core bonds (both directions), summed |valence delta|, mean-square
    displacement of the alignment (ref atom_mapping.py:161-189)."""
    val_a = np.array([mol_a.valence(i) for i in range(mol_a.num_atoms)])
    val_b = np.array([mol_b.valence(j) for j in range(mol_b.num_atoms)])

    broken, valence, msd = [], [], []
    for core in cores:
        ai, bj = core[:, 0], core[:, 1]
        msd.append(float(np.mean(np.sum((conf_a[ai] - conf_b[bj]) ** 2, axis=1))))
        valence.append(int(np.abs(val_a[ai] - val_b[bj]).sum()))
        broken.append(
            core_bonds_broken_count(mol_a, mol_b, core) + core_bonds_broken_count(mol_b, mol_a, core[:, ::-1])
        )
    # np.lexsort keys are last-is-primary
    return np.lexsort((np.array(msd), np.array(valence), np.array(broken)))


# ---------------------------------------------------------------------------
# search driver


def _search(cfg: _SearchConfig, mol_a, mol_b, seed):
    """Full pipeline on an (A smaller than B) ordered pair: degree reordering,
    candidate lists, admissibility filters, MCS search,
    dedupe + rank, and un-permutation of the results (ref atom_mapping.py:249-393)."""
    perm, seed_p = _degree_order(mol_a, seed)
    mol_ap = mol_a.renumber(perm)
    conf_a, conf_b = mol_ap.get_conf(), mol_b.get_conf()

    candidates = _candidate_lists(cfg, mol_ap, mol_b, conf_a, conf_b, seed_p)
    predicate, native_kwargs = _admissibility(cfg, mol_ap, mol_b, conf_a, conf_b)

    search_args = (
        mol_a.num_atoms,
        mol_b.num_atoms,
        candidates,
        mol_ap.bond_list(),
        mol_b.bond_list(),
        cfg.max_visits,
        cfg.max_cores,
        cfg.enforce_core_core,
        cfg.max_connected_components,
        cfg.min_connected_component_size,
        cfg.min_threshold,
        seed_p,
    )

    # the native C++ search is the production path: the chiral and planar filters run as built-in hash-table
    # checks instead of per-node Python callbacks; the Python module is the spec and the fallback
    native = _native_search()
    if native is not None:
        cores, _, diagnostics = native(*search_args, **native_kwargs)
    else:
        cores, _, diagnostics = mcgregor.mcs(*search_args, predicate)

    cores = _dedupe(remove_cores_smaller_than_largest(cores))
    ranking = _rank_cores(mol_ap, mol_b, conf_a, conf_b, cores)

    out = []
    for p in ranking:
        core = cores[p].copy()
        core[:, 0] = perm[core[:, 0]]  # back to the caller's atom numbering
        out.append(core)
    return out, diagnostics
