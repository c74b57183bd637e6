"""Single-topology alchemical transformation: two ligands fused through a
mapped core, with per-term aligned parameter interpolation across λ.

Parity target: reference timemachine/fe/single_topology.py (2154 LoC):
AtomMapMixin combined-index bookkeeping, factorizable dummy-group end states
(setup_end_state), the master λ-window schedule for bonds/angles/torsions/
chiral volumes/nonbonded, aligned interpolation, intermediate-state
construction, and host combination.

The aligned term indices are λ-independent: only parameters change with λ.

The port of timemachine_tpu/fe/single_topology.py: the interpolation runs in
torch f64 over every aligned row at once where the JAX package jits a vmap
of its scalar functions; the bond graphs are graph_utils.Graph; states are
fe/terms.py's GuestTerms and HostGuestTerms (HostGuestTerms.to_system puts
them on a device).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from enum import IntEnum
from functools import cache, cached_property, partial
from typing import Optional

import numpy as np
import torch

from timemachine_torch.constants import (
    DEFAULT_BOND_IS_PRESENT_K,
    DEFAULT_CHIRAL_ATOM_RESTRAINT_K,
    DEFAULT_CHIRAL_BOND_RESTRAINT_K,
    NBParamIdx,
)
from timemachine_torch.fe import interpolate, model_utils, topology, utils
from timemachine_torch.fe.chiral_utils import ChiralRestrIdxSet
from timemachine_torch.fe.dummy import (
    canonicalize_bond,
    generate_anchored_dummy_group_assignments,
    generate_dummy_group_assignments,
)
from timemachine_torch.fe.interpolate import pad
from timemachine_torch.fe.lambda_schedule import construct_pre_optimized_relative_lambda_schedule
from timemachine_torch.fe.terms import (
    BoundPotential,
    ChiralAtomRestraint,
    ChiralBondRestraint,
    GuestTerms,
    HarmonicAngle,
    HarmonicBond,
    HostGuestTerms,
    HostTerms,
    Nonbonded,
    NonbondedPairListPrecomputed,
    PeriodicTorsion,
)
from timemachine_torch.fe.topology import get_ligand_ixn_pots_params
from timemachine_torch.ff import Forcefield
from timemachine_torch.ff.handlers import as_f64
from timemachine_torch.graph_utils import connected_components, graph_from_bonds

# ---------------------------------------------------------------------------
# Master λ-window schedule (ref single_topology.py:49-141). Each term family
# interpolates only inside its [λ_min, λ_max] window; boundaries are free-ish
# tuning parameters, kept numerically identical to the reference for behavior
# parity. Single source of truth: every window is written once in its
# "forward" direction below, and the reverse-direction partner is its λ-mirror
# (x -> 1-x reverses the window and swaps the endpoints).
# ---------------------------------------------------------------------------


def _flip_min_max(min_max):
    lamb_min, lamb_max = min_max
    return 1 - lamb_max, 1 - lamb_min


_FWD = {
    # core valence terms stay on throughout
    "CORE_BOND": [0.0, 1.0],
    "CORE_ANGLE": [0.0, 1.0],
    "CORE_TORSION": [0.0, 1.0],
    "CORE_TORSION_OFF_TO_ON": [0.7, 1.0],
    # core terms participating in a chiral-volume conversion
    "CORE_CHIRAL_ATOM_CONVERTING_ON": [0.0, 0.5],
    "CORE_CHIRAL_ANGLE_CONVERTING_ON": [0.5, 1.0],
    # B-side dummies turning on (non-converting)
    "DUMMY_B_BOND": [0.0, 0.7],
    "DUMMY_B_ANGLE": [0.0, 0.7],
    "DUMMY_B_TORSION": [0.7, 1.0],
    # B-side dummies whose chirality converts: bonds reach ~30 kJ/mol by the
    # time chiral volumes start, keeping the volumes numerically stable
    "DUMMY_B_CHIRAL_BOND_CONVERTING_ON": [0.0, 0.7],
    "DUMMY_B_CHIRAL_ATOM_CONVERTING_ON": [0.3, 0.5],
    "DUMMY_B_CHIRAL_ANGLE_CONVERTING_ON": [0.5, 0.7],
    # bi-phasic nonbonded: at λ=0.5 both dummy groups are partially present;
    # w-coords ride the optimized decoupling schedule (ref :103-140)
    "DUMMY_A_NONBONDED_W": [2 / 3, 1],
    "DUMMY_A_NONBONDED_EPS": [1 / 3, 2 / 3],
    "DUMMY_A_NONBONDED_Q": [1 / 3, 2 / 3],
    "CORE_NONBONDED_QLJ": [1 / 3, 2 / 3],
}

def _w(name):
    return list(_FWD[name])

def _rev(name):
    return list(_flip_min_max(_FWD[name]))

DEFAULT_MIN_MAX = [0.0, 1.0]

CORE_BOND_MIN_MAX = _w("CORE_BOND")
CORE_ANGLE_MIN_MAX = _w("CORE_ANGLE")
CORE_TORSION_MIN_MAX = _w("CORE_TORSION")
CORE_TORSION_OFF_TO_ON_MIN_MAX = _w("CORE_TORSION_OFF_TO_ON")
CORE_TORSION_ON_TO_OFF_MIN_MAX = _rev("CORE_TORSION_OFF_TO_ON")

CORE_CHIRAL_ATOM_CONVERTING_ON_MIN_MAX = _w("CORE_CHIRAL_ATOM_CONVERTING_ON")
CORE_CHIRAL_ANGLE_CONVERTING_ON_MIN_MAX = _w("CORE_CHIRAL_ANGLE_CONVERTING_ON")
CORE_CHIRAL_ATOM_CONVERTING_OFF_MIN_MAX = _rev("CORE_CHIRAL_ATOM_CONVERTING_ON")
CORE_CHIRAL_ANGLE_CONVERTING_OFF_MIN_MAX = _rev("CORE_CHIRAL_ANGLE_CONVERTING_ON")

DUMMY_B_BOND_MIN_MAX = _w("DUMMY_B_BOND")
DUMMY_B_ANGLE_MIN_MAX = _w("DUMMY_B_ANGLE")
DUMMY_B_TORSION_MIN_MAX = _w("DUMMY_B_TORSION")
DUMMY_A_BOND_MIN_MAX = _rev("DUMMY_B_BOND")
DUMMY_A_ANGLE_MIN_MAX = _rev("DUMMY_B_ANGLE")
DUMMY_A_TORSION_MIN_MAX = _rev("DUMMY_B_TORSION")

DUMMY_B_CHIRAL_BOND_CONVERTING_ON_MIN_MAX = _w("DUMMY_B_CHIRAL_BOND_CONVERTING_ON")
DUMMY_B_CHIRAL_ATOM_CONVERTING_ON_MIN_MAX = _w("DUMMY_B_CHIRAL_ATOM_CONVERTING_ON")
DUMMY_B_CHIRAL_ANGLE_CONVERTING_ON_MIN_MAX = _w("DUMMY_B_CHIRAL_ANGLE_CONVERTING_ON")
DUMMY_A_CHIRAL_BOND_CONVERTING_OFF_MIN_MAX = _rev("DUMMY_B_CHIRAL_BOND_CONVERTING_ON")
DUMMY_A_CHIRAL_ATOM_CONVERTING_OFF_MIN_MAX = _rev("DUMMY_B_CHIRAL_ATOM_CONVERTING_ON")
DUMMY_A_CHIRAL_ANGLE_CONVERTING_OFF_MIN_MAX = _rev("DUMMY_B_CHIRAL_ANGLE_CONVERTING_ON")

DUMMY_A_NONBONDED_W_MIN_MAX = _w("DUMMY_A_NONBONDED_W")
DUMMY_A_NONBONDED_EPS_MIN_MAX = _w("DUMMY_A_NONBONDED_EPS")
DUMMY_A_NONBONDED_Q_MIN_MAX = _w("DUMMY_A_NONBONDED_Q")
DUMMY_B_NONBONDED_W_MIN_MAX = _rev("DUMMY_A_NONBONDED_W")
DUMMY_B_NONBONDED_EPS_MIN_MAX = _rev("DUMMY_A_NONBONDED_EPS")
DUMMY_B_NONBONDED_Q_MIN_MAX = _rev("DUMMY_A_NONBONDED_Q")
CORE_NONBONDED_QLJ_MIN_MAX = _w("CORE_NONBONDED_QLJ")


class ChiralVolumeDisabledWarning(UserWarning):
    pass


class CoreBondChangeWarning(UserWarning):
    pass


class MissingAngleError(RuntimeError):
    pass


class ChargePertubationError(RuntimeError):
    pass


class DummyGroupAssignmentError(RuntimeError):
    pass


class MissingBondsInChiralVolumeException(Exception):
    pass


class TorsionsDefinedOverLinearAngleException(Exception):
    pass


def bond_isin(bonds, idxs):
    """Mask of term rows whose atoms are all contained in idxs
    (ref single_topology.py:163-177)."""
    b0 = bonds[:, :, None] == idxs[None, None, :]
    return b0.any(-1).all(-1)


def setup_dummy_bond_and_chiral_interactions(
    bond_idxs, bond_params, chiral_atom_idxs, chiral_atom_params, dummy_group, root_anchor_atom, core_atoms
):
    """Bonds within (dummy group + anchor) and chiral volumes with >= 1
    non-center dummy atom and all atoms in (dummy group + core)
    (ref single_topology.py:180-225)."""
    assert root_anchor_atom in core_atoms
    dummy_group_arr = np.array(list(dummy_group))
    dga = np.append(dummy_group_arr, root_anchor_atom)

    bond_mask = bond_isin(bond_idxs, dga)
    dummy_bond_idxs = bond_idxs[bond_mask]
    dummy_bond_params = np.asarray(bond_params)[bond_mask]

    dgc = np.concatenate([dummy_group_arr, core_atoms])
    has_ncda = (chiral_atom_idxs[:, 1:, None] == dummy_group_arr[None, None, :]).any(-1).any(-1)
    chiral_mask = bond_isin(chiral_atom_idxs, dgc) & has_ncda
    dummy_chiral_atom_idxs = chiral_atom_idxs[chiral_mask]
    dummy_chiral_atom_params = np.asarray(chiral_atom_params)[chiral_mask]

    return (dummy_bond_idxs, dummy_chiral_atom_idxs), (dummy_bond_params, dummy_chiral_atom_params)


def setup_dummy_interactions_from_ff(
    ff, mol, dummy_group, root_anchor_atom, nbr_anchor_atom, core_atoms, chiral_atom_k, chiral_bond_k
):
    """(ref single_topology.py:228-259)"""
    top = topology.BaseTopology(mol, ff)
    bond_params, hb = top.parameterize_harmonic_bond(ff.hb_handle.params)
    angle_params, ha = top.parameterize_harmonic_angle(ff.ha_handle.params)
    improper_params, it = top.parameterize_improper_torsion(ff.it_handle.params)
    chiral_atom_potential, _ = top.setup_chiral_restraints(chiral_atom_k, chiral_bond_k)
    return setup_dummy_interactions(
        hb.idxs,
        bond_params,
        ha.idxs,
        angle_params,
        it.idxs,
        improper_params,
        chiral_atom_potential.potential.idxs,
        chiral_atom_potential.params,
        dummy_group,
        root_anchor_atom,
        nbr_anchor_atom,
        core_atoms,
    )


def setup_dummy_interactions(
    bond_idxs,
    bond_params,
    angle_idxs,
    angle_params,
    improper_idxs,
    improper_params,
    chiral_atom_idxs,
    chiral_atom_params,
    dummy_group,
    root_anchor_atom,
    nbr_anchor_atom,
    core_atoms,
):
    """Factorizability rules for dummy interactions
    (ref single_topology.py:262-393): bonds/angles/impropers within
    dummy_group+anchor only; optional angle through (dummy, anchor,
    nbr_anchor); chiral volumes with >=1 dummy; no propers or nonbonded."""
    assert root_anchor_atom in core_atoms

    (dummy_bond_idxs, dummy_chiral_atom_idxs), (dummy_bond_params, dummy_chiral_atom_params) = (
        setup_dummy_bond_and_chiral_interactions(
            bond_idxs, bond_params, chiral_atom_idxs, chiral_atom_params, dummy_group, root_anchor_atom, core_atoms
        )
    )

    assert len(dummy_group) == len(list(dummy_group))
    dummy_group = list(dummy_group)
    dga = [*dummy_group, root_anchor_atom]

    dummy_angle_idxs, dummy_angle_params = [], []
    dummy_improper_idxs, dummy_improper_params = [], []

    for idxs, params in zip(angle_idxs, angle_params):
        if all(a in dga for a in idxs):
            dummy_angle_idxs.append(tuple(int(x) for x in idxs))
            dummy_angle_params.append(params)
    for idxs, params in zip(improper_idxs, improper_params):
        if all(a in dga for a in idxs):
            dummy_improper_idxs.append(tuple(int(x) for x in idxs))
            dummy_improper_params.append(params)

    if nbr_anchor_atom is not None:
        assert nbr_anchor_atom in core_atoms
        found = False
        for idxs, params in zip(angle_idxs, angle_params):
            i, j, k = idxs
            if (i in dummy_group and j == root_anchor_atom and k == nbr_anchor_atom) or (
                k in dummy_group and j == root_anchor_atom and i == nbr_anchor_atom
            ):
                dummy_angle_idxs.append(tuple(int(x) for x in idxs))
                dummy_angle_params.append(params)
                found = True
        if not found:
            raise MissingAngleError(
                f"Missing angle interaction in mol_b, dg={dummy_group}, root={root_anchor_atom}, nbr={nbr_anchor_atom}"
            )

    return (
        (dummy_bond_idxs, dummy_angle_idxs, dummy_improper_idxs, dummy_chiral_atom_idxs),
        (dummy_bond_params, dummy_angle_params, dummy_improper_params, dummy_chiral_atom_params),
    )


def canonicalize_bonds(bonds):
    assert bonds.ndim == 2 and bonds.shape[1] >= 2
    is_canonical = bonds[:, 0] < bonds[:, -1]
    return np.where(is_canonical[:, None], bonds, bonds[:, ::-1])


def canonicalize_improper_idxs(idxs) -> tuple[int, int, int, int]:
    """Symmetry-aware canonicalization of trefoil impropers
    (ref single_topology.py:403-452)."""
    j, c, k, l = idxs
    key = (j, k, l)
    jj, kk, ll = sorted(key)
    cw_items = sorted([(jj, kk, ll), (kk, ll, jj), (ll, jj, kk)])
    if key in cw_items:
        return (j, c, k, l)
    ccw_items = sorted([(kk, jj, ll), (jj, ll, kk), (ll, kk, jj)])
    assert key in ccw_items
    idx = ccw_items.index(key)
    j, k, l = cw_items[idx]
    return (j, c, k, l)


def canonicalize_chiral_atom_idxs(idxs):
    """Rotate (i,j,k) so the smallest neighbor leads; triple product is
    rotation-invariant (ref single_topology.py:462-470)."""
    assert idxs.ndim == 2 and idxs.shape[1] == 4
    c = idxs[:, 0:1]
    ijk = idxs[:, 1:]
    ijk_argmin = np.argmin(ijk, axis=1)
    ijks = ijk[:, [[0, 1, 2], [1, 2, 0], [2, 0, 1]]]
    ijk_canon = np.take_along_axis(ijks, ijk_argmin[:, None, None], axis=1)[:, 0]
    return np.concatenate([c, ijk_canon], axis=1)


def get_num_connected_components(num_atoms: int, bonds) -> int:
    return len(list(connected_components(graph_from_bonds(num_atoms, bonds))))


def _remap_or_empty(mapping, idxs, width: int):
    """Relabel an index table through `mapping`, tolerating empty tables."""
    idxs = np.asarray(idxs, dtype=np.int32).reshape(-1, width)
    return mapping[idxs] if len(idxs) else idxs


def _stack_rows(rows, width, dtype):
    return np.array(rows, dtype=dtype).reshape(-1, width)


def _collect_dummy_attachment_terms(ff: Forcefield, mol_b, core_b, anchored_dummy_groups):
    """Union over dummy groups of the factorizable attachment interactions,
    in mol_b indexing. Returns the ff-derived (angle, improper) tables and
    the topology-derived (bond, chiral-volume) tables."""
    angles, angle_ps = [], []
    impropers, improper_ps = [], []
    for anchor, (nbr, dummy_group) in anchored_dummy_groups.items():
        idxs, params = setup_dummy_interactions_from_ff(
            ff, mol_b, dummy_group, anchor, nbr, core_b, DEFAULT_CHIRAL_ATOM_RESTRAINT_K, DEFAULT_CHIRAL_BOND_RESTRAINT_K
        )
        angles.extend(idxs[1])
        angle_ps.extend(params[1])
        impropers.extend(idxs[2])
        improper_ps.extend(params[2])

    mol_b_top = topology.BaseTopology(mol_b, ff)
    b_bond_params, b_hb = mol_b_top.parameterize_harmonic_bond(ff.hb_handle.params)
    b_chiral_atom, _ = mol_b_top.setup_chiral_restraints(
        DEFAULT_CHIRAL_ATOM_RESTRAINT_K, DEFAULT_CHIRAL_BOND_RESTRAINT_K
    )
    bonds, bond_ps = [], []
    chirals, chiral_ps = [], []
    for anchor, (_, dummy_group) in anchored_dummy_groups.items():
        idxs, params = setup_dummy_bond_and_chiral_interactions(
            b_hb.idxs,
            b_bond_params,
            b_chiral_atom.potential.idxs,
            np.asarray(b_chiral_atom.params),
            dummy_group,
            anchor,
            core_b,
        )
        bonds.extend(np.asarray(idxs[0]).reshape(-1, 2).tolist())
        bond_ps.extend(np.asarray(params[0]).reshape(-1, 2).tolist())
        chirals.extend(np.asarray(idxs[1]).reshape(-1, 4).tolist())
        chiral_ps.extend(np.asarray(params[1]).reshape(-1).tolist())

    return {
        "angle": (_stack_rows(angles, 3, np.int32), _stack_rows(angle_ps, 3, np.float64)),
        "improper": (_stack_rows(impropers, 4, np.int32), _stack_rows(improper_ps, 3, np.float64)),
        "bond": (_stack_rows(bonds, 2, np.int32), _stack_rows(bond_ps, 2, np.float64)),
        "chiral_atom": (_stack_rows(chirals, 4, np.int32), np.array(chiral_ps, np.float64)),
    }


def _prune_unbonded_chiral_volumes(chiral_idxs, chiral_params, bond_idxs):
    """A chiral volume needs all three center-neighbor bonds alive at this
    end state; volumes missing one are disabled with a warning."""
    present = {frozenset(map(int, b)) for b in bond_idxs}
    kept_idxs, kept_params = [], []
    for (c, i, j, k), p in zip(np.asarray(chiral_idxs).reshape(-1, 4), chiral_params):
        missing = [(int(c), int(x)) for x in (i, j, k) if frozenset((int(c), int(x))) not in present]
        if missing:
            warnings.warn(
                f"Chiral Volume {int(c), int(i), int(j), int(k)} has disabled bonds {missing}, turning off.",
                ChiralVolumeDisabledWarning,
            )
        else:
            kept_idxs.append((c, i, j, k))
            kept_params.append(p)
    return _stack_rows(kept_idxs, 4, np.int32), np.array(kept_params, np.float64)


def setup_end_state(ff: Forcefield, mol_a, mol_b, core, a_to_c, b_to_c, anchored_dummy_groups) -> GuestTerms:
    """One alchemical end state: mol_a fully interacting, plus mol_b's dummy
    atoms attached through factorizable interactions only (so the dummy
    partition function separates and the end state matches mol_a's physics;
    ref semantics single_topology.py:473-720). All index tables land in
    combined indexing, canonicalized.
    """
    # fully-interacting side: every term of mol_a, relabeled a -> combined
    a_top = topology.BaseTopology(mol_a, ff)
    a_bond_params, a_hb = a_top.parameterize_harmonic_bond(ff.hb_handle.params)
    a_angle_params, a_ha = a_top.parameterize_harmonic_angle(ff.ha_handle.params)
    a_proper_params, a_pt = a_top.parameterize_proper_torsion(ff.pt_handle.params)
    a_improper_params, a_it = a_top.parameterize_improper_torsion(ff.it_handle.params)
    a_nbpl_params, a_nbpl = a_top.parameterize_nonbonded_pairlist(
        ff.q_handle.params, ff.q_handle_intra.params, ff.lj_handle.params, ff.lj_handle_intra.params, intramol_params=True
    )
    a_chiral_atom, a_chiral_bond = a_top.setup_chiral_restraints(
        DEFAULT_CHIRAL_ATOM_RESTRAINT_K, DEFAULT_CHIRAL_BOND_RESTRAINT_K
    )

    # dummy side: attachment terms of mol_b's dummies, relabeled b -> combined
    dummy = _collect_dummy_attachment_terms(ff, mol_b, core[:, 1], anchored_dummy_groups)

    def merged(name, a_idxs, a_params, width, param_width):
        d_idxs, d_params = dummy[name]
        idxs = np.concatenate([_remap_or_empty(a_to_c, a_idxs, width), _remap_or_empty(b_to_c, d_idxs, width)])
        params = np.concatenate(
            [np.asarray(a_params, np.float64).reshape(-1, param_width), d_params.reshape(-1, param_width)]
        )
        return idxs, params

    bond_idxs, bond_params = merged("bond", a_hb.idxs, a_bond_params, 2, 2)
    angle_idxs, angle_params = merged("angle", a_ha.idxs, a_angle_params, 3, 3)
    improper_idxs, improper_params = merged("improper", a_it.idxs, a_improper_params, 4, 3)

    # chiral volumes: mol_a's must all be backed by bonds; dummy ones are
    # pruned down to those whose bonds survive at this end state
    a_chiral_idxs = _remap_or_empty(a_to_c, a_chiral_atom.potential.idxs, 4)
    a_bonds_present = {frozenset(map(int, b)) for b in bond_idxs}
    for c, i, j, k in a_chiral_idxs:
        for x in (i, j, k):
            assert frozenset((int(c), int(x))) in a_bonds_present
    d_chiral_idxs, d_chiral_params = _prune_unbonded_chiral_volumes(
        _remap_or_empty(b_to_c, dummy["chiral_atom"][0], 4), dummy["chiral_atom"][1], bond_idxs
    )
    chiral_idxs = np.concatenate([a_chiral_idxs, d_chiral_idxs])
    chiral_params = np.concatenate([np.asarray(a_chiral_atom.params), d_chiral_params])

    # canonicalize + bind every family
    canon_rows = lambda rows: np.array([canonicalize_bond(tuple(x)) for x in rows], np.int32)
    chiral_bond_idxs = _remap_or_empty(a_to_c, a_chiral_bond.potential.idxs, 4)

    system = GuestTerms(
        bond=HarmonicBond(canonicalize_bonds(bond_idxs)).bind(np.asarray(bond_params, np.float64)),
        angle=HarmonicAngle(canon_rows(angle_idxs)).bind(np.asarray(angle_params)),
        proper=PeriodicTorsion(canon_rows(_remap_or_empty(a_to_c, a_pt.idxs, 4)).reshape(-1, 4)).bind(
            np.asarray(a_proper_params, np.float64).reshape(-1, 3)
        ),
        improper=PeriodicTorsion(
            np.array([canonicalize_improper_idxs(tuple(int(x) for x in row)) for row in improper_idxs], np.int32).reshape(-1, 4)
        ).bind(np.asarray(improper_params, np.float64).reshape(-1, 3)),
        nonbonded_pair_list=NonbondedPairListPrecomputed(
            canon_rows(_remap_or_empty(a_to_c, a_nbpl.idxs, 2)).reshape(-1, 2), a_nbpl.beta, a_nbpl.cutoff
        ).bind(np.asarray(a_nbpl_params, np.float64)),
        chiral_atom=ChiralAtomRestraint(canonicalize_chiral_atom_idxs(chiral_idxs)).bind(chiral_params),
        chiral_bond=ChiralBondRestraint(
            canonicalize_bonds(chiral_bond_idxs) if len(chiral_bond_idxs) else chiral_bond_idxs,
            np.asarray(a_chiral_bond.potential.signs),
        ).bind(np.asarray(a_chiral_bond.params)),
    )

    num_atoms = mol_a.num_atoms + mol_b.num_atoms - len(core)
    assert get_num_connected_components(num_atoms, system.bond.potential.idxs) == 1, (
        "hybrid molecule has multiple connected components"
    )
    return system


def find_dummy_groups_and_anchors(mol_a, mol_b, core_atoms_a, core_atoms_b):
    """Arbitrary-but-valid anchored dummy group assignment for A -> B
    (ref single_topology.py:723-776)."""
    bond_graph_a = mol_a.to_nx()
    bond_graph_b = mol_b.to_nx()
    candidates = (
        anchored
        for dummy_groups in generate_dummy_group_assignments(bond_graph_b, core_atoms_b)
        for anchored in generate_anchored_dummy_group_assignments(
            dummy_groups, bond_graph_a, bond_graph_b, core_atoms_a, core_atoms_b
        )
    )
    arbitrary = next(candidates)
    for _, (angle_anchor, _) in arbitrary.items():
        if angle_anchor is None:
            warnings.warn("Unable to find stable angle term in mol_a", CoreBondChangeWarning)
    return arbitrary


# ---------------------------------------------------------------------------
# interpolation functions (ref single_topology.py:779-1045)
# ---------------------------------------------------------------------------


# shared combinators: every bonded term is some mix of a (log-linear,
# softened) force-constant ramp and a linear geometric ramp, each clamped to
# the term's λ-window by interpolate.pad


def _ramp_k(src_k, dst_k, lamb, k_min, lo, hi):
    return pad(partial(interpolate.log_linear_interpolation, min_value=k_min), src_k, dst_k, lamb, lo, hi)


def _ramp_lin(src, dst, lamb, lo, hi):
    return pad(interpolate.linear_interpolation, src, dst, lamb, lo, hi)


def cyclic_difference(a, b, period):
    """Minimum |x| solving (a + x) % period == b % period
    (ref single_topology.py:827-841)."""
    d = torch.fmod(as_f64(b) - as_f64(a), period)

    def f(d):
        return torch.where(d <= period / 2, d, d - period)

    return torch.sign(d) * f(torch.abs(d))


def _nearest_phase(src_phase, dst_phase):
    """dst re-expressed within half a period of src, so the phase ramp takes
    the shortest arc."""
    return src_phase + cyclic_difference(src_phase, dst_phase, period=2 * np.pi)


# Each interpolate_*_params takes every aligned row at once: the arguments
# are columns (T,) of the src and dst tables and the rows' windows, where the
# JAX package vmaps the same function over the rows.


def interpolate_harmonic_bond_params(src_params, dst_params, lamb, k_min, lambda_min, lambda_max):
    (src_k, src_x), (dst_k, dst_x) = src_params, dst_params
    return [
        _ramp_k(src_k, dst_k, lamb, k_min, lambda_min, lambda_max),
        _ramp_lin(src_x, dst_x, lamb, lambda_min, lambda_max),
    ]


def interpolate_chiral_volume_params(src_params, dst_params, lamb, k_min, lambda_min, lambda_max):
    return [_ramp_k(src_params, dst_params, lamb, k_min, lambda_min, lambda_max)]


def interpolate_harmonic_angle_params(src_params, dst_params, lamb, k_min, lambda_min, lambda_max):
    (src_k, src_phase, _), (dst_k, dst_phase, _) = src_params, dst_params
    k = _ramp_k(src_k, dst_k, lamb, k_min, lambda_min, lambda_max)
    return [
        k,
        _ramp_lin(src_phase, _nearest_phase(src_phase, dst_phase), lamb, lambda_min, lambda_max),
        # stabilized functional form only for intermediate states
        torch.full_like(k, 0.0 if lamb in (0.0, 1.0) else 1e-3),
    ]


def interpolate_periodic_torsion_params(src_params, dst_params, lamb, lambda_min, lambda_max):
    (src_k, src_phase, src_period), (dst_k, dst_phase, _) = src_params, dst_params
    return [
        _ramp_lin(src_k, dst_k, lamb, lambda_min, lambda_max),
        _ramp_lin(src_phase, _nearest_phase(src_phase, dst_phase), lamb, lambda_min, lambda_max),
        src_period,
    ]


def interpolate_w_coord(w0, w1, lamb):
    """4D coordinate interpolation riding the pre-optimized decoupling
    schedule (ref single_topology.py:934-951)."""
    lambdas = construct_pre_optimized_relative_lambda_schedule(None)
    x = np.linspace(0.0, 1.0, len(lambdas))
    w0, w1, lamb = as_f64(w0), as_f64(w1), as_f64(lamb)
    return torch.where(
        w0 < w1,
        interpolate.linear_interpolation(w0, w1, interpolate.interp(lamb, x, lambdas)),
        interpolate.linear_interpolation(w1, w0, interpolate.interp(1.0 - lamb, x, lambdas)),
    )


def _over_rows(fn, src_params, dst_params, lamb, *scalars_and_windows):
    """fn on the columns of (T, k) src and dst tables and the (T,) windows,
    its k output columns stacked back into a (T, k) table."""
    *scalars, mins, maxes = scalars_and_windows
    src, dst = as_f64(src_params).T, as_f64(dst_params).T
    return torch.stack(fn(src, dst, lamb, *scalars, as_f64(mins), as_f64(maxes)), dim=1)


def batch_interpolate_harmonic_bond_params(src_params, dst_params, lamb, k_min, mins, maxes):
    return _over_rows(interpolate_harmonic_bond_params, src_params, dst_params, lamb, k_min, mins, maxes)


def batch_interpolate_harmonic_angle_params(src_params, dst_params, lamb, k_min, mins, maxes):
    return _over_rows(interpolate_harmonic_angle_params, src_params, dst_params, lamb, k_min, mins, maxes)


def batch_interpolate_periodic_torsion_params(src_params, dst_params, lamb, mins, maxes):
    return _over_rows(interpolate_periodic_torsion_params, src_params, dst_params, lamb, mins, maxes)


def batch_interpolate_chiral_atom_params(src_params, dst_params, lamb, k_min, mins, maxes):
    return _over_rows(interpolate_chiral_volume_params, np.reshape(src_params, (-1, 1)), np.reshape(dst_params, (-1, 1)), lamb, k_min, mins, maxes).reshape(-1)


def _decoupling_pair_params(qlj, w_real, cutoff, lamb, w_win, q_win, appearing):
    """Pair params for a pair with a dummy endpoint: the 4D w-coordinate flies
    in from the cutoff (appearing) or out to it (vanishing) on the optimized
    decoupling schedule, charge ramps from/to zero, and sig/eps are pinned at
    the real end-state's values."""
    zero_q = torch.zeros_like(qlj[:, 0])
    if appearing:
        w = interpolate.pad(interpolate_w_coord, cutoff, w_real, lamb, *w_win)
        q = interpolate.pad(interpolate.linear_interpolation, zero_q, qlj[:, 0], lamb, *q_win)
    else:
        w = interpolate.pad(interpolate_w_coord, w_real, cutoff, lamb, *w_win)
        q = interpolate.pad(interpolate.linear_interpolation, qlj[:, 0], zero_q, lamb, *q_win)
    return torch.cat((q[:, None], qlj[:, 1:3], w[:, None]), dim=1)


def batch_interpolate_nonbonded_pair_list_params(cutoff, src_params, dst_params, lamb):
    """Bi-phasic interpolation of precomputed pair params
    (ref single_topology.py:968-1045). A pair whose src (dst) qlj is all zero
    is a B-side (A-side) dummy pair and follows the decoupling protocol; core
    pairs stay at w=0 with qlj linearly ramped inside the core window."""
    src_params, dst_params = as_f64(src_params), as_f64(dst_params)
    src_qlj, src_w = src_params[:, : NBParamIdx.W_IDX], src_params[:, NBParamIdx.W_IDX]
    dst_qlj, dst_w = dst_params[:, : NBParamIdx.W_IDX], dst_params[:, NBParamIdx.W_IDX]

    appearing_b = _decoupling_pair_params(
        dst_qlj, dst_w, cutoff, lamb, DUMMY_B_NONBONDED_W_MIN_MAX, DUMMY_B_NONBONDED_Q_MIN_MAX, appearing=True
    )
    vanishing_a = _decoupling_pair_params(
        src_qlj, src_w, cutoff, lamb, DUMMY_A_NONBONDED_W_MIN_MAX, DUMMY_A_NONBONDED_Q_MIN_MAX, appearing=False
    )
    core_qlj = interpolate.pad(interpolate.linear_interpolation, src_qlj, dst_qlj, lamb, *CORE_NONBONDED_QLJ_MIN_MAX)
    core = torch.cat((core_qlj, torch.zeros((len(src_params), 1), dtype=torch.float64)), dim=1)

    is_dummy_b = torch.all(src_qlj == 0.0, dim=1, keepdim=True)
    is_dummy_a = torch.all(dst_qlj == 0.0, dim=1, keepdim=True)
    return torch.where(is_dummy_b, appearing_b, torch.where(is_dummy_a, vanishing_a, core))


class AtomMapFlags(IntEnum):
    CORE = 0
    MOL_A = 1
    MOL_B = 2


class AtomMapMixin:
    """Combined-molecule index bookkeeping (ref single_topology.py:1054-1142):
    a_to_c is the identity; unique B atoms append after mol_a's atoms."""

    def __init__(self, mol_a, mol_b, core):
        core = np.asarray(core)
        assert core.shape[1] == 2
        assert mol_a is not None and mol_b is not None
        if len(np.unique(core[:, 0])) < len(core) or len(np.unique(core[:, 1])) < len(core):
            raise AssertionError("core columns must not repeat atoms")

        self.mol_a = mol_a
        self.mol_b = mol_b
        self.core = core
        n_a, n_c = mol_a.num_atoms, self.get_num_atoms()

        # combined numbering: A atoms keep their indices; B-only atoms append
        # after them in ascending B order
        self.a_to_c = np.arange(n_a, dtype=np.int32)
        self.b_to_c = np.full(mol_b.num_atoms, -1, dtype=np.int32)
        self.b_to_c[core[:, 1]] = core[:, 0]
        dummy_b = np.flatnonzero(self.b_to_c < 0)
        self.b_to_c[dummy_b] = n_a + np.arange(len(dummy_b), dtype=np.int32)

        self.c_flags = np.full(n_c, AtomMapFlags.MOL_A, dtype=np.int32)
        self.c_flags[core[:, 0]] = AtomMapFlags.CORE
        self.c_flags[n_a:] = AtomMapFlags.MOL_B

        self.c_to_a = {int(v): k for k, v in enumerate(self.a_to_c)}
        self.c_to_b = {int(v): k for k, v in enumerate(self.b_to_c)}

    def _atoms_flagged(self, flag: AtomMapFlags) -> set:
        return set(np.flatnonzero(self.c_flags == flag).tolist())

    @cache
    def get_dummy_atoms_a(self) -> set:
        return self._atoms_flagged(AtomMapFlags.MOL_A)

    @cache
    def get_dummy_atoms_b(self) -> set:
        return self._atoms_flagged(AtomMapFlags.MOL_B)

    @cache
    def get_core_atoms(self) -> set:
        return self._atoms_flagged(AtomMapFlags.CORE)

    def get_num_atoms(self) -> int:
        return self.mol_a.num_atoms + self.mol_b.num_atoms - len(self.core)

    def get_num_dummy_atoms(self) -> int:
        return self.get_num_atoms() - len(self.core)


def assert_default_system_constraints(system):
    assert_bonds_defined_for_chiral_volumes(system)
    assert_torsions_defined_over_non_linear_angles(system)


def assert_bonds_defined_for_chiral_volumes(system, bond_k_min: float = DEFAULT_BOND_IS_PRESENT_K):
    """(ref single_topology.py:1159-1178)"""
    bonds_present = set()
    for idxs, (bond_k, _) in zip(system.bond.potential.idxs, np.asarray(system.bond.params)):
        if bond_k > bond_k_min:
            bonds_present.add(tuple(int(x) for x in idxs))
    for (c, i, j, k), chiral_k in zip(system.chiral_atom.potential.idxs, np.asarray(system.chiral_atom.params)):
        if chiral_k > 0:
            for x in (i, j, k):
                if canonicalize_bond((int(c), int(x))) not in bonds_present:
                    raise MissingBondsInChiralVolumeException(
                        f"bond {(int(c), int(x))} missing from Chiral Volume {(int(c), int(i), int(j), int(k))}"
                    )


def assert_torsions_defined_over_non_linear_angles(system):
    """(ref single_topology.py:1181-1214)"""
    linear_angles = set()
    for (i, j, k), angle_params in zip(system.angle.potential.idxs, np.asarray(system.angle.params)):
        angle_k, angle_a0 = angle_params[0], angle_params[1]
        if angle_k > 0 and abs(angle_a0 - np.pi) < 0.174533:
            linear_angles.add((int(i), int(j), int(k)))

    def check(idxs_arr, params_arr, kind):
        for (i, j, k, l), (torsion_k, _, _) in zip(idxs_arr, np.asarray(params_arr)):
            if torsion_k > 0:
                if canonicalize_bond((int(i), int(j), int(k))) in linear_angles:
                    raise TorsionsDefinedOverLinearAngleException(
                        f"angle {(int(i), int(j), int(k))} is linear in {kind} torsion {(int(i), int(j), int(k), int(l))}"
                    )
                if canonicalize_bond((int(j), int(k), int(l))) in linear_angles:
                    raise TorsionsDefinedOverLinearAngleException(
                        f"angle {(int(j), int(k), int(l))} is linear in {kind} torsion {(int(i), int(j), int(k), int(l))}"
                    )

    check(system.proper.potential.idxs, system.proper.params, "proper")
    check(system.improper.potential.idxs, system.improper.params, "improper")


def assert_chiral_consistency(src_chiral_idxs, dst_chiral_idxs):
    """(ref single_topology.py:1217-1226)"""
    src_set = ChiralRestrIdxSet(src_chiral_idxs)
    dst_set = ChiralRestrIdxSet(dst_chiral_idxs)
    assert len(src_set.allowed_set & dst_set.disallowed_set) == 0
    assert len(dst_set.allowed_set & src_set.disallowed_set) == 0


@dataclass
class AlignedPotential:
    """λ-independent idxs + (src, dst, window) parameter triples
    (ref single_topology.py:1229-1291). `interpolate(lamb)` binds the
    parameters at λ."""

    idxs: np.ndarray
    src_params: np.ndarray
    dst_params: np.ndarray
    mins: np.ndarray
    maxes: np.ndarray

    def interpolate_params(self, lamb):
        raise NotImplementedError()

    def interpolate(self, lamb):
        raise NotImplementedError()


class AlignedBond(AlignedPotential):
    k_min = 0.1

    def interpolate_params(self, lamb):
        return batch_interpolate_harmonic_bond_params(self.src_params, self.dst_params, lamb, self.k_min, self.mins, self.maxes)

    def interpolate(self, lamb):
        return HarmonicBond(self.idxs).bind(self.interpolate_params(lamb))


class AlignedAngle(AlignedPotential):
    k_min = 0.05

    def interpolate_params(self, lamb):
        return batch_interpolate_harmonic_angle_params(self.src_params, self.dst_params, lamb, self.k_min, self.mins, self.maxes)

    def interpolate(self, lamb):
        return HarmonicAngle(self.idxs).bind(self.interpolate_params(lamb))


class AlignedTorsion(AlignedPotential):
    def interpolate_params(self, lamb):
        return batch_interpolate_periodic_torsion_params(self.src_params, self.dst_params, lamb, self.mins, self.maxes)

    def interpolate(self, lamb):
        return PeriodicTorsion(self.idxs).bind(self.interpolate_params(lamb))


class AlignedChiralAtom(AlignedPotential):
    k_min = 0.025

    def interpolate_params(self, lamb):
        return batch_interpolate_chiral_atom_params(self.src_params, self.dst_params, lamb, self.k_min, self.mins, self.maxes)

    def interpolate(self, lamb):
        return ChiralAtomRestraint(self.idxs).bind(self.interpolate_params(lamb))


@dataclass
class AlignedNonbondedPairlist(AlignedPotential):
    cutoff: float = 1.2
    beta: float = 2.0

    def interpolate_params(self, lamb):
        return batch_interpolate_nonbonded_pair_list_params(self.cutoff, self.src_params, self.dst_params, lamb)

    def interpolate(self, lamb):
        return NonbondedPairListPrecomputed(self.idxs, self.beta, self.cutoff).bind(self.interpolate_params(lamb))


class SingleTopology(AtomMapMixin):
    """(ref single_topology.py:1294-2155)"""

    def __init__(self, mol_a, mol_b, core, forcefield: Forcefield):
        super().__init__(mol_a, mol_b, core)
        self.ff = forcefield

        a_charge = mol_a.total_charge()
        b_charge = mol_b.total_charge()
        if a_charge != b_charge:
            raise ChargePertubationError(f"mol a and mol b don't have the same charge: a: {a_charge} b: {b_charge}")

        self.anchored_dummy_groups_ab = find_dummy_groups_and_anchors(mol_a, mol_b, core[:, 0], core[:, 1])
        self.anchored_dummy_groups_ba = find_dummy_groups_and_anchors(mol_b, mol_a, core[:, 1], core[:, 0])

        self.src_system = self._setup_end_state_src()
        self.dst_system = self._setup_end_state_dst()

        assert_chiral_consistency(self.src_system.chiral_atom.potential.idxs, self.dst_system.chiral_atom.potential.idxs)
        assert_default_system_constraints(self.src_system)
        assert_default_system_constraints(self.dst_system)

        self.aligned_bond = self._align_bonds()
        self.aligned_angle = self._align_angles()
        self.aligned_proper = self._align_propers()
        self.aligned_improper = self._align_impropers()
        self.aligned_chiral_atom = self._align_chiral_atoms()
        self.aligned_nonbonded_pair_list = self._align_nonbonded_pair_list()

    # -- alignment ----------------------------------------------------------

    def _align_bonded_term(self, align_fn, assign_min_max_fn, src_potential, dst_potential):
        aligned_tuples = align_fn(
            [tuple(int(x) for x in row) for row in src_potential.potential.idxs],
            np.asarray(src_potential.params),
            [tuple(int(x) for x in row) for row in dst_potential.potential.idxs],
            np.asarray(dst_potential.params),
        )
        aligned_tuples = sorted(aligned_tuples)  # deterministic ordering
        idxs = np.array([x[0] for x in aligned_tuples], dtype=np.int32)
        src_params = np.array([x[1] for x in aligned_tuples], dtype=np.float64)
        dst_params = np.array([x[2] for x in aligned_tuples], dtype=np.float64)
        mins, maxes = assign_min_max_fn(aligned_tuples)
        return idxs, src_params, dst_params, mins, maxes

    def _align_bonds(self):
        idxs, src, dst, mins, maxes = self._align_bonded_term(
            interpolate.align_harmonic_bond_idxs_and_params, self._assign_bond_idxs_min_max,
            self.src_system.bond, self.dst_system.bond,
        )
        return AlignedBond(idxs.reshape(-1, 2), src.reshape(-1, 2), dst.reshape(-1, 2), mins, maxes)

    def _align_angles(self):
        idxs, src, dst, mins, maxes = self._align_bonded_term(
            interpolate.align_harmonic_angle_idxs_and_params, self._assign_angle_idxs_min_max,
            self.src_system.angle, self.dst_system.angle,
        )
        return AlignedAngle(idxs.reshape(-1, 3), src.reshape(-1, 3), dst.reshape(-1, 3), mins, maxes)

    def _align_propers(self):
        idxs, src, dst, mins, maxes = self._align_bonded_term(
            interpolate.align_proper_idxs_and_params, self._assign_periodic_torsion_idxs_min_max,
            self.src_system.proper, self.dst_system.proper,
        )
        return AlignedTorsion(idxs.reshape(-1, 4), src.reshape(-1, 3), dst.reshape(-1, 3), mins, maxes)

    def _align_impropers(self):
        idxs, src, dst, mins, maxes = self._align_bonded_term(
            interpolate.align_improper_idxs_and_params, self._assign_periodic_torsion_idxs_min_max,
            self.src_system.improper, self.dst_system.improper,
        )
        return AlignedTorsion(idxs.reshape(-1, 4), src.reshape(-1, 3), dst.reshape(-1, 3), mins, maxes)

    def _align_chiral_atoms(self):
        idxs, src, dst, mins, maxes = self._align_bonded_term(
            interpolate.align_chiral_atom_idxs_and_params, self._assign_chiral_atom_idxs_min_max,
            self.src_system.chiral_atom, self.dst_system.chiral_atom,
        )
        return AlignedChiralAtom(idxs.reshape(-1, 4), src.reshape(-1), dst.reshape(-1), mins, maxes)

    def _align_nonbonded_pair_list(self):
        src_pot = self.src_system.nonbonded_pair_list.potential
        dst_pot = self.dst_system.nonbonded_pair_list.potential
        assert src_pot.cutoff == dst_pot.cutoff and src_pot.beta == dst_pot.beta
        idxs, src, dst, mins, maxes = self._align_bonded_term(
            interpolate.align_nonbonded_idxs_and_params, self._assign_nonbonded_idxs_min_max,
            self.src_system.nonbonded_pair_list, self.dst_system.nonbonded_pair_list,
        )
        return AlignedNonbondedPairlist(
            idxs.reshape(-1, 2), src.reshape(-1, 4), dst.reshape(-1, 4), mins, maxes,
            cutoff=src_pot.cutoff, beta=src_pot.beta,
        )

    # -- window assignment (ref single_topology.py:1597-1770) ----------------

    @cached_property
    def src_chiral_idxs(self):
        return set(tuple(int(x) for x in row) for row in self.src_system.chiral_atom.potential.idxs)

    @cached_property
    def dst_chiral_idxs(self):
        return set(tuple(int(x) for x in row) for row in self.dst_system.chiral_atom.potential.idxs)

    def all_idxs_belong_to_core(self, idxs):
        return all(x in self.get_core_atoms() for x in idxs)

    def any_idxs_belong_to_dummy_a(self, idxs):
        return any(x in self.get_dummy_atoms_a() for x in idxs)

    def any_idxs_belong_to_dummy_b(self, idxs):
        return any(x in self.get_dummy_atoms_b() for x in idxs)

    def _chiral_volume_is_turning_on(self, idxs):
        return tuple(idxs) in self.dst_chiral_idxs and tuple(idxs) not in self.src_chiral_idxs

    def _chiral_volume_is_turning_off(self, idxs):
        return tuple(idxs) in self.src_chiral_idxs and tuple(idxs) not in self.dst_chiral_idxs

    def _induced_bonds(self, chiral_diff):
        out = set()
        for c, i, j, k in chiral_diff:
            out.add(canonicalize_bond((c, i)))
            out.add(canonicalize_bond((c, j)))
            out.add(canonicalize_bond((c, k)))
        return out

    def _induced_angles(self, chiral_diff):
        out = set()
        for c, i, j, k in chiral_diff:
            out.add(canonicalize_bond((i, c, j)))
            out.add(canonicalize_bond((i, c, k)))
            out.add(canonicalize_bond((j, c, k)))
        return out

    def _bond_idxs_belong_to_chiral_volume_turning_on(self, idxs):
        return idxs in self._induced_bonds(self.dst_chiral_idxs - self.src_chiral_idxs)

    def _bond_idxs_belong_to_chiral_volume_turning_off(self, idxs):
        return idxs in self._induced_bonds(self.src_chiral_idxs - self.dst_chiral_idxs)

    def _angle_idxs_belong_to_chiral_volume_turning_on(self, idxs):
        return idxs in self._induced_angles(self.dst_chiral_idxs - self.src_chiral_idxs)

    def _angle_idxs_belong_to_chiral_volume_turning_off(self, idxs):
        return idxs in self._induced_angles(self.src_chiral_idxs - self.dst_chiral_idxs)

    # Window assignment: each aligned term row picks its λ-window from
    # (region, chiral-conversion direction). The per-term-type methods below
    # differ only in how "conversion" is detected and which windows apply;
    # `_stack_windows` handles the plumbing.

    def _region(self, idxs) -> AtomMapFlags:
        if self.all_idxs_belong_to_core(idxs):
            return AtomMapFlags.CORE
        if self.any_idxs_belong_to_dummy_a(idxs):
            return AtomMapFlags.MOL_A
        if self.any_idxs_belong_to_dummy_b(idxs):
            return AtomMapFlags.MOL_B
        raise AssertionError(f"term {idxs} spans both dummy groups")

    @staticmethod
    def _stack_windows(pick, aligned_tuples):
        rows = np.array([pick(tuple(idxs), src_p, dst_p) for idxs, src_p, dst_p in aligned_tuples]).reshape(-1, 2)
        return rows[:, 0], rows[:, 1]

    def _assign_bond_idxs_min_max(self, aligned_tuples):
        def pick(idxs, _src, _dst):
            region = self._region(idxs)
            if region is AtomMapFlags.CORE:
                return CORE_BOND_MIN_MAX
            converting_off = self._bond_idxs_belong_to_chiral_volume_turning_off(idxs)
            converting_on = self._bond_idxs_belong_to_chiral_volume_turning_on(idxs)
            if region is AtomMapFlags.MOL_A:
                assert not converting_on  # A-side dummies only ever turn off
                return DUMMY_A_CHIRAL_BOND_CONVERTING_OFF_MIN_MAX if converting_off else DUMMY_A_BOND_MIN_MAX
            assert not converting_off
            return DUMMY_B_CHIRAL_BOND_CONVERTING_ON_MIN_MAX if converting_on else DUMMY_B_BOND_MIN_MAX

        return self._stack_windows(pick, aligned_tuples)

    def _assign_angle_idxs_min_max(self, aligned_tuples):
        def pick(idxs, _src, _dst):
            region = self._region(idxs)
            converting_on = self._angle_idxs_belong_to_chiral_volume_turning_on(idxs)
            converting_off = self._angle_idxs_belong_to_chiral_volume_turning_off(idxs)
            if region is AtomMapFlags.CORE:
                if converting_on:
                    return CORE_CHIRAL_ANGLE_CONVERTING_ON_MIN_MAX
                return CORE_CHIRAL_ANGLE_CONVERTING_OFF_MIN_MAX if converting_off else CORE_ANGLE_MIN_MAX
            if region is AtomMapFlags.MOL_A:
                assert not converting_on
                return DUMMY_A_CHIRAL_ANGLE_CONVERTING_OFF_MIN_MAX if converting_off else DUMMY_A_ANGLE_MIN_MAX
            assert not converting_off
            return DUMMY_B_CHIRAL_ANGLE_CONVERTING_ON_MIN_MAX if converting_on else DUMMY_B_ANGLE_MIN_MAX

        return self._stack_windows(pick, aligned_tuples)

    def _assign_periodic_torsion_idxs_min_max(self, aligned_tuples):
        def pick(idxs, src_params, dst_params):
            region = self._region(idxs)
            if region is AtomMapFlags.MOL_A:
                return DUMMY_A_TORSION_MIN_MAX
            if region is AtomMapFlags.MOL_B:
                return DUMMY_B_TORSION_MIN_MAX
            # core torsions appearing (src k=0) / vanishing (dst k=0) get the
            # late/early sub-window
            if src_params[0] == 0:
                return CORE_TORSION_OFF_TO_ON_MIN_MAX
            return CORE_TORSION_ON_TO_OFF_MIN_MAX if dst_params[0] == 0 else CORE_TORSION_MIN_MAX

        return self._stack_windows(pick, aligned_tuples)

    def _assign_chiral_atom_idxs_min_max(self, aligned_tuples):
        def pick(idxs, src_k, dst_k):
            region = self._region(idxs)
            turning_on = self._chiral_volume_is_turning_on(idxs)
            turning_off = self._chiral_volume_is_turning_off(idxs)
            if not (turning_on or turning_off):
                assert src_k == dst_k
                return DEFAULT_MIN_MAX
            if region is AtomMapFlags.CORE:
                return CORE_CHIRAL_ATOM_CONVERTING_ON_MIN_MAX if turning_on else CORE_CHIRAL_ATOM_CONVERTING_OFF_MIN_MAX
            if region is AtomMapFlags.MOL_A:
                assert turning_off
                return DUMMY_A_CHIRAL_ATOM_CONVERTING_OFF_MIN_MAX
            assert turning_on
            return DUMMY_B_CHIRAL_ATOM_CONVERTING_ON_MIN_MAX

        return self._stack_windows(pick, aligned_tuples)

    def _assign_nonbonded_idxs_min_max(self, aligned_tuples):
        rows = np.tile(np.asarray(DEFAULT_MIN_MAX, dtype=np.float64), (len(aligned_tuples), 1))
        return rows[:, 0], rows[:, 1]

    # -- masses / confs -------------------------------------------------------

    def combine_masses(self, use_hmr: bool = False) -> list[float]:
        """(ref single_topology.py:1452-1500)"""
        mol_a_masses = utils.get_mol_masses(self.mol_a)
        mol_b_masses = utils.get_mol_masses(self.mol_b)
        if use_hmr:
            mol_a_top = topology.BaseTopology(self.mol_a, self.ff)
            mol_b_top = topology.BaseTopology(self.mol_b, self.ff)
            _, mol_a_hb = mol_a_top.parameterize_harmonic_bond(self.ff.hb_handle.params)
            _, mol_b_hb = mol_b_top.parameterize_harmonic_bond(self.ff.hb_handle.params)
            mol_a_masses = model_utils.apply_hmr(mol_a_masses, mol_a_hb.idxs)
            mol_b_masses = model_utils.apply_hmr(mol_b_masses, mol_b_hb.idxs)

        out = []
        for c_idx in range(self.get_num_atoms()):
            flag = self.c_flags[c_idx]
            if flag == AtomMapFlags.CORE:
                out.append(max(mol_a_masses[self.c_to_a[c_idx]], mol_b_masses[self.c_to_b[c_idx]]))
            elif flag == AtomMapFlags.MOL_A:
                out.append(mol_a_masses[self.c_to_a[c_idx]])
            elif flag == AtomMapFlags.MOL_B:
                out.append(mol_b_masses[self.c_to_b[c_idx]])
            else:
                raise AssertionError(f"Unknown atom flag: {flag}")
        return out

    def combine_confs(self, x_a, x_b, lamb: float = 1.0):
        return self.combine_confs_lhs(x_a, x_b) if lamb < 0.5 else self.combine_confs_rhs(x_a, x_b)

    def combine_confs_rhs(self, x_a, x_b):
        assert x_a.shape == (self.mol_a.num_atoms, 3)
        assert x_b.shape == (self.mol_b.num_atoms, 3)
        x0 = np.zeros((self.get_num_atoms(), 3))
        x0[self.a_to_c] = x_a
        x0[self.b_to_c] = x_b
        return x0

    def combine_confs_lhs(self, x_a, x_b):
        assert x_a.shape == (self.mol_a.num_atoms, 3)
        assert x_b.shape == (self.mol_b.num_atoms, 3)
        x0 = np.zeros((self.get_num_atoms(), 3))
        x0[self.b_to_c] = x_b
        x0[self.a_to_c] = x_a
        return x0

    def _setup_end_state_src(self):
        return setup_end_state(
            self.ff, self.mol_a, self.mol_b, self.core, self.a_to_c, self.b_to_c, self.anchored_dummy_groups_ab
        )

    def _setup_end_state_dst(self):
        return setup_end_state(
            self.ff, self.mol_b, self.mol_a, self.core[:, ::-1], self.b_to_c, self.a_to_c, self.anchored_dummy_groups_ba
        )

    # -- intermediate states ----------------------------------------------------

    def setup_intermediate_state(self, lamb: float) -> GuestTerms:
        """(ref single_topology.py:1772-1837)"""
        chiral_bond = ChiralBondRestraint(np.zeros((0, 4), dtype=np.int32), np.zeros(0, dtype=np.int32)).bind(
            np.zeros(0)
        )
        return GuestTerms(
            bond=self.aligned_bond.interpolate(lamb),
            angle=self.aligned_angle.interpolate(lamb),
            proper=self.aligned_proper.interpolate(lamb),
            improper=self.aligned_improper.interpolate(lamb),
            chiral_atom=self.aligned_chiral_atom.interpolate(lamb),
            nonbonded_pair_list=self.aligned_nonbonded_pair_list.interpolate(lamb),
            chiral_bond=chiral_bond,
        )

    def mol(self, lamb: float, min_bond_k: float = DEFAULT_BOND_IS_PRESENT_K):
        """Combined-molecule graph at λ (bonds = active harmonic terms)
        (ref single_topology.py:1839-1892)."""
        from timemachine_torch.chem.mol import Atom, Bond, Mol

        vs = self.setup_intermediate_state(lamb)
        atoms = []
        for c_idx in range(self.get_num_atoms()):
            flag = self.c_flags[c_idx]
            if flag == AtomMapFlags.CORE:
                z = (
                    self.mol_a.atoms[self.c_to_a[c_idx]].atomic_num
                    if lamb < 0.5
                    else self.mol_b.atoms[self.c_to_b[c_idx]].atomic_num
                )
            elif flag == AtomMapFlags.MOL_A:
                z = self.mol_a.atoms[self.c_to_a[c_idx]].atomic_num
            else:
                z = self.mol_b.atoms[self.c_to_b[c_idx]].atomic_num
            atoms.append(Atom(int(z)))
        bonds = []
        for (i, j), (k, _) in zip(vs.bond.potential.idxs, np.asarray(vs.bond.params)):
            if k > min_bond_k:
                bonds.append(Bond(int(i), int(j), 1))
        return Mol(atoms, bonds, name=f"{self.mol_a.name}->{self.mol_b.name}@{lamb}")

    def _get_guest_params(self, q_handle, lj_handle, lamb: float, cutoff: float):
        """Per-atom (q, σ/2, √ε, w) of the combined mol at λ, for the
        guest-environment interaction group (ref single_topology.py:1894-1982)."""
        guest_charges, guest_sigmas, guest_epsilons, guest_w_coords = [], [], [], []

        guest_a_q = q_handle.parameterize(self.mol_a)
        guest_a_lj = lj_handle.parameterize(self.mol_a)
        guest_b_q = q_handle.parameterize(self.mol_b)
        guest_b_lj = lj_handle.parameterize(self.mol_b)

        for idx, membership in enumerate(self.c_flags):
            if membership == AtomMapFlags.CORE:
                a_idx, b_idx = self.c_to_a[idx], self.c_to_b[idx]
                q = interpolate.pad(
                    interpolate.linear_interpolation, guest_a_q[a_idx], guest_b_q[b_idx], lamb, *CORE_NONBONDED_QLJ_MIN_MAX
                )
                sig = interpolate.pad(
                    interpolate.linear_interpolation, guest_a_lj[a_idx, 0], guest_b_lj[b_idx, 0], lamb, *CORE_NONBONDED_QLJ_MIN_MAX
                )
                eps = interpolate.pad(
                    interpolate.linear_interpolation, guest_a_lj[a_idx, 1], guest_b_lj[b_idx, 1], lamb, *CORE_NONBONDED_QLJ_MIN_MAX
                )
                w = 0.0
            elif membership == AtomMapFlags.MOL_A:
                a_idx = self.c_to_a[idx]
                q = interpolate.pad(interpolate.linear_interpolation, guest_a_q[a_idx], 0, lamb, *DUMMY_A_NONBONDED_Q_MIN_MAX)
                sig = guest_a_lj[a_idx, 0]
                eps_src = guest_a_lj[a_idx, 1]
                eps_dst = torch.maximum(torch.tensor(0.02, dtype=torch.float64), eps_src / 3)
                eps = interpolate.pad(interpolate.linear_interpolation, eps_src, eps_dst, lamb, *DUMMY_A_NONBONDED_EPS_MIN_MAX)
                w = interpolate.pad(interpolate_w_coord, 0.0, cutoff, lamb, *DUMMY_A_NONBONDED_W_MIN_MAX)
            elif membership == AtomMapFlags.MOL_B:
                b_idx = self.c_to_b[idx]
                q = interpolate.pad(interpolate.linear_interpolation, 0, guest_b_q[b_idx], lamb, *DUMMY_B_NONBONDED_Q_MIN_MAX)
                sig = guest_b_lj[b_idx, 0]
                eps_dst = guest_b_lj[b_idx, 1]
                eps_src = torch.maximum(torch.tensor(0.02, dtype=torch.float64), eps_dst / 3)
                eps = interpolate.pad(interpolate.linear_interpolation, eps_src, eps_dst, lamb, *DUMMY_B_NONBONDED_EPS_MIN_MAX)
                w = interpolate.pad(interpolate_w_coord, cutoff, 0.0, lamb, *DUMMY_B_NONBONDED_W_MIN_MAX)
            else:
                raise AssertionError
            guest_charges.append(q)
            guest_sigmas.append(sig)
            guest_epsilons.append(eps)
            guest_w_coords.append(w)

        columns = [guest_charges, guest_sigmas, guest_epsilons, guest_w_coords]
        return torch.stack([torch.stack([as_f64(v) for v in col]) for col in columns], dim=1)

    def _parameterize_host_nonbonded(self, host_nonbonded: BoundPotential) -> BoundPotential:
        """(ref single_topology.py:1984-2008)"""
        num_host_atoms = host_nonbonded.params.shape[0]
        num_guest_atoms = self.get_num_atoms()
        hg_nb_params = torch.cat(
            [as_f64(host_nonbonded.params), torch.zeros((num_guest_atoms, host_nonbonded.params.shape[1]), dtype=torch.float64)]
        )
        combined = Nonbonded(
            num_host_atoms + num_guest_atoms,
            host_nonbonded.potential.exclusion_idxs,
            host_nonbonded.potential.scale_factors,
            host_nonbonded.potential.beta,
            host_nonbonded.potential.cutoff,
            atom_idxs=np.arange(num_host_atoms, dtype=np.int32),
        )
        return combined.bind(hg_nb_params)

    def _parameterize_host_guest_nonbonded_ixn(self, lamb, host_nonbonded, num_water_atoms: int, ff, host_topology):
        """(ref single_topology.py:2010-2055)"""
        num_host_atoms = host_nonbonded.params.shape[0]
        num_guest_atoms = self.get_num_atoms()
        cutoff = host_nonbonded.potential.cutoff

        guest_ixn_env_params = self._get_guest_params(self.ff.q_handle, self.ff.lj_handle, lamb, cutoff)

        num_other_atoms = num_host_atoms - num_water_atoms
        lig_idxs = np.arange(num_guest_atoms, dtype=np.int32) + num_host_atoms
        env_idxs = np.concatenate(
            [np.arange(num_other_atoms, dtype=np.int32), np.arange(num_water_atoms, dtype=np.int32) + num_other_atoms]
        )

        hg_nb_ixn_params = np.array(host_nonbonded.params.detach()).copy()
        if ff.env_bcc_handle is not None and host_topology is not None:
            env_bcc_h = ff.env_bcc_handle.get_env_handle(host_topology, ff)
            hg_nb_ixn_params[:, NBParamIdx.Q_IDX] = env_bcc_h.parameterize(ff.env_bcc_handle.params)

        ixn_pot, ixn_params = get_ligand_ixn_pots_params(
            lig_idxs, env_idxs, hg_nb_ixn_params, guest_ixn_env_params,
            beta=host_nonbonded.potential.beta, cutoff=cutoff,
        )
        return ixn_pot.bind(ixn_params)

    def combine_with_host(self, host_system: HostTerms, lamb: float, num_water_atoms: int, ff, host_topology=None) -> HostGuestTerms:
        """(ref single_topology.py:2057-2154)"""
        guest_system = self.setup_intermediate_state(lamb=lamb)
        num_host_atoms = host_system.nonbonded_all_pairs.params.shape[0]

        guest_chiral_atom = ChiralAtomRestraint(guest_system.chiral_atom.potential.idxs + num_host_atoms).bind(
            guest_system.chiral_atom.params
        )
        guest_chiral_bond = ChiralBondRestraint(
            guest_system.chiral_bond.potential.idxs + num_host_atoms, guest_system.chiral_bond.potential.signs
        ).bind(guest_system.chiral_bond.params)
        guest_nb_pair_list = NonbondedPairListPrecomputed(
            guest_system.nonbonded_pair_list.potential.idxs + num_host_atoms,
            guest_system.nonbonded_pair_list.potential.beta,
            guest_system.nonbonded_pair_list.potential.cutoff,
        ).bind(guest_system.nonbonded_pair_list.params)

        def combine(host_bp, guest_bp, ctor):
            idxs = np.concatenate([host_bp.potential.idxs, guest_bp.potential.idxs + num_host_atoms])
            params = torch.cat([as_f64(host_bp.params), as_f64(guest_bp.params)])
            return ctor(idxs).bind(params)

        combined_bond = combine(host_system.bond, guest_system.bond, HarmonicBond)
        combined_angle = combine(host_system.angle, guest_system.angle, HarmonicAngle)
        combined_proper = combine(host_system.proper, guest_system.proper, PeriodicTorsion)
        combined_improper = combine(host_system.improper, guest_system.improper, PeriodicTorsion)

        host_nonbonded_all_pairs = self._parameterize_host_nonbonded(host_system.nonbonded_all_pairs)
        host_guest_ixn = self._parameterize_host_guest_nonbonded_ixn(
            lamb, host_system.nonbonded_all_pairs, num_water_atoms, ff, host_topology
        )

        return HostGuestTerms(
            bond=combined_bond,
            angle=combined_angle,
            proper=combined_proper,
            improper=combined_improper,
            chiral_atom=guest_chiral_atom,
            chiral_bond=guest_chiral_bond,
            nonbonded_pair_list=guest_nb_pair_list,
            nonbonded_all_pairs=host_nonbonded_all_pairs,
            nonbonded_ixn_group=host_guest_ixn,
        )
