"""Forcefield parameter-assignment handlers (SMIRKS-typed): the port of
timemachine_tpu/ff/handlers.py. Its jnp code is torch f64 here, so a
handler's parameters carry gradients through autograd as jax.grad carries
them through the JAX code; numpy stays numpy. The exclusion list is built in
graph_utils' BFS order, which is networkx's.

Parity targets: reference `timemachine/ff/handlers/bonded.py` (valence-dict
assignment, "last match wins"), `handlers/nonbonded.py` (per-atom typing,
exclusion generation over graph distance, LJ parameter pre-transforms,
bond-charge-correction machinery), built on this framework's native SMARTS
engine instead of RDKit/OpenEye.

Charge model note: the reference's AM1(BCC)-based handlers call OpenEye QM
(gated, optional there too). Here base charges come from, in priority order:
1. a cache property on the molecule (`AM1Cache`-style, as the reference
   caches), 2. per-atom "PartialCharges" properties (PrecomputedCharge),
3. the in-repo AM1 SCF (`timemachine_torch.qm`), 4. where that cannot run
(an unsupported element, an open shell, a degenerate conformer, an SCF that
does not converge), a native Gasteiger-Marsili PEOE fallback with a
GasteigerFallbackWarning, or MissingBaseChargesError under
TM_STRICT_CHARGES=1. The differentiable CCC correction layer (SMIRKS-matched
bond charge increments) is identical in behavior and is where forcefield
training happens (du/dq exact via autograd).
"""

from __future__ import annotations

import base64
import os
import pickle
import warnings
from collections import Counter

import numpy as np
import torch

from timemachine_torch import constants
from timemachine_torch.chem.mol import Mol
from timemachine_torch.chem.smarts import match_smarts
from timemachine_torch.graph_utils import all_pairs_shortest_path_length

_SUFFIX = "Handler"

AM1_CHARGE_CACHE = "AM1Cache"
AM1ELF10_CHARGE_CACHE = "AM1ELF10Cache"
AM1BCC_CHARGE_CACHE = "AM1BCCCache"
AM1BCCELF10_CHARGE_CACHE = "AM1BCCELF10Cache"
BOND_SMIRK_MATCH_CACHE = "BondSmirkMatchCache"
GASTEIGER_CHARGE_CACHE = "GasteigerCache"


class GasteigerFallbackWarning(UserWarning):
    """Base charges degraded from AM1-family to Gasteiger PEOE."""


class MissingBaseChargesError(RuntimeError):
    """Strict charge mode: no cached/precomputed base charges available."""


class NativeAM1Unavailable(Exception):
    """The native AM1 backend cannot handle this molecule (unsupported
    element, open shell, degenerate conformer, or SCF non-convergence)."""


def as_f64(x) -> torch.Tensor:
    """x as a torch f64 tensor on its device (a tensor keeps its graph)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _native_am1_base_charges(mol: Mol, mode: str) -> np.ndarray:
    """Compute AM1-family base charges with the in-repo AM1 SCF
    (`timemachine_torch.qm`), scaled by sqrt(ONE_4PI_EPS0) like the
    reference's oe_assign_charges (ref nonbonded.py:98-150). Raises
    NativeAM1Unavailable when the model cannot apply."""
    from timemachine_torch.qm.charges import am1_mol_charges, am1bcc_mol_charges
    from timemachine_torch.qm.scf import SCFConvergenceError

    try:
        if mode == "AM1":
            q = am1_mol_charges(mol, symmetrize=False)
        elif mode == "AM1ELF10":
            q = am1_mol_charges(mol, symmetrize=True)
        elif mode in ("AM1BCC", "AM1BCCELF10"):
            q = am1bcc_mol_charges(mol)
        else:
            raise NativeAM1Unavailable(f"unknown charge mode {mode!r}")
    except (ValueError, SCFConvergenceError) as e:
        raise NativeAM1Unavailable(str(e)) from e
    return np.asarray(q, dtype=np.float64) * np.sqrt(constants.ONE_4PI_EPS0)


def strict_base_charges() -> bool:
    """Whether missing AM1-family charges are an error (TM_STRICT_CHARGES=1)
    instead of a Gasteiger fallback with a warning."""
    return os.environ.get("TM_STRICT_CHARGES", "0") == "1"


def canonicalize_bond(arr):
    """Orient an index tuple so arr[0] < arr[-1] (ref handlers/utils.py:41-69)."""
    if len(arr) == 0:
        raise ValueError("zero sized array")
    if len(arr) == 1:
        return arr
    if arr[0] > arr[-1]:
        return type(arr)(reversed(arr))
    if arr[0] == arr[-1]:
        raise ValueError("Invalid bond with first and last indices equal")
    return arr


def match_smirks(mol: Mol, smirks: str):
    """Map-ordered, non-uniquified matches under the MDL aromaticity model —
    the contract of the reference's match_smirks (ff/handlers/utils.py:72-106)."""
    return match_smarts(mol, smirks, aromaticity="mdl")


def generate_vd_idxs(mol: Mol, smirks: list[str]):
    """Valence-dict assignment: canonicalized match tuple -> last matching
    pattern wins (SMIRKS hierarchy; ref handlers/bonded.py:8-26)."""
    vd = {}
    for p_idx, patt in enumerate(smirks):
        for m in match_smirks(mol, patt):
            vd[tuple(canonicalize_bond(list(m)))] = p_idx
    bond_idxs = np.array(list(vd.keys()), dtype=np.int32)
    param_idxs = np.array(list(vd.values()), dtype=np.int32)
    return bond_idxs, param_idxs


def generate_exclusion_idxs(mol: Mol, scale12, scale13, scale14_lj, scale14_q):
    """Exclusions from all-pairs shortest path <= 3 bonds; shorter distances
    override longer (ref handlers/nonbonded.py:153-204)."""
    exclusions = {}
    g = mol.to_nx()
    for src, dsts in all_pairs_shortest_path_length(g, cutoff=3):
        for dst, length in dsts.items():
            if length == 0:
                continue
            if length == 1:
                scale = (scale12, scale12)
            elif length == 2:
                scale = (scale13, scale13)
            else:
                scale = (scale14_q, scale14_lj)
            exclusions[tuple(canonicalize_bond((src, dst)))] = scale
    idxs = np.array(list(exclusions.keys()), dtype=np.int32).reshape(-1, 2)
    scales = np.array(list(exclusions.values()), dtype=np.float64).reshape(-1, 2)
    return idxs, scales


def generate_nonbonded_idxs(mol: Mol, smirks: list[str]):
    """Per-atom type assignment, last match wins (ref nonbonded.py:207-231)."""
    param_idxs = np.zeros(mol.num_atoms, dtype=np.int32)
    assigned = np.zeros(mol.num_atoms, dtype=bool)
    for p_idx, patt in enumerate(smirks):
        for m in match_smirks(mol, patt):
            param_idxs[m[0]] = p_idx
            assigned[m[0]] = True
    return param_idxs


def apply_bond_charge_corrections(initial_charges, bond_idxs, deltas, runtime_validate=True):
    """charges[a] += delta; charges[b] -= delta per directed bond — exactly
    preserves net charge; differentiable in deltas (ref nonbonded.py:301-341)."""
    q = as_f64(initial_charges)
    if len(bond_idxs):
        idxs = torch.as_tensor(np.asarray(bond_idxs, dtype=np.int64))
        deltas = as_f64(deltas)
        q = q.index_add(0, idxs[:, 0], deltas)
        q = q.index_add(0, idxs[:, 1], -deltas)
    assert np.asarray(bond_idxs).reshape(-1, 2).shape[1] == 2
    if runtime_validate:
        assert torch.isclose(q.sum(), as_f64(initial_charges).sum(), atol=1e-5)
    directed = Counter(tuple(b) for b in np.asarray(bond_idxs).reshape(-1, 2).tolist())
    if directed and max(directed.values()) > 1:
        warnings.warn(f"Duplicate directed bonds! {[b for b, c in directed.items() if c > 1]}")
    return q


def compute_or_load_bond_smirks_matches(mol: Mol, smirks_list):
    """Ordered directed bonds + their assigned BCC types: first match wins
    per directed bond; uses the AM1BCC aromaticity model
    (ref nonbonded.py:264-299)."""
    if BOND_SMIRK_MATCH_CACHE in mol.props:
        bond_idxs, type_idxs = pickle.loads(base64.b64decode(mol.props[BOND_SMIRK_MATCH_CACHE]))
        return np.array(bond_idxs).reshape(-1, 2), np.array(type_idxs, dtype=np.int32)
    bond_idxs = []
    type_idxs = []
    seen = set()
    for type_idx, smirks in enumerate(smirks_list):
        for m in match_smarts(mol, smirks, aromaticity="am1bcc"):
            a, b = m[0], m[1]
            if (a, b) not in seen:
                seen.add((a, b))
                bond_idxs.append([a, b])
                type_idxs.append(type_idx)
    mol.props[BOND_SMIRK_MATCH_CACHE] = base64.b64encode(pickle.dumps((bond_idxs, type_idxs)))
    return np.array(bond_idxs).reshape(-1, 2), np.array(type_idxs, dtype=np.int32)


def compute_or_load_base_charges(mol: Mol, mode: str = "AM1ELF10"):
    """Base charges (already scaled by sqrt(ONE_4PI_EPS0), like the
    reference's oe_assign_charges, nonbonded.py:98-150). Sources in priority
    order: cached property, per-atom precomputed charges, the native AM1 SCF,
    native Gasteiger fallback (warned; an error in strict mode)."""
    cache_prop = f"{mode}Cache"
    if cache_prop in mol.props:
        raw = mol.props[cache_prop]
        charges = pickle.loads(base64.b64decode(raw))
        assert len(charges) == mol.num_atoms
        return np.array(charges, dtype=np.float64)
    if "PartialCharges" in mol.props:
        q = np.array([float(x) for x in str(mol.props["PartialCharges"]).split()])
        assert len(q) == mol.num_atoms
        return q * np.sqrt(constants.ONE_4PI_EPS0)
    try:
        scaled = _native_am1_base_charges(mol, mode)
    except NativeAM1Unavailable as e:
        native_am1_failure = str(e)
    else:
        mol.props[cache_prop] = base64.b64encode(pickle.dumps(list(scaled)))
        return scaled
    if GASTEIGER_CHARGE_CACHE in mol.props and not strict_base_charges():
        # a previous call on this mol already fell back (and warned once);
        # degraded charges live under their OWN key so they can never
        # masquerade as AM1-family values on later reads or serialization.
        # Strict mode rejects the cache too: previously-cached degraded
        # charges must not slip through a TM_STRICT_CHARGES=1 run.
        charges = pickle.loads(base64.b64decode(mol.props[GASTEIGER_CHARGE_CACHE]))
        assert len(charges) == mol.num_atoms
        return np.array(charges, dtype=np.float64)
    if strict_base_charges():
        raise MissingBaseChargesError(
            f"No {mode} charge cache on mol {mol.name!r} and the native AM1 backend "
            f"could not produce charges ({native_am1_failure}). Strict charge mode is on "
            "(TM_STRICT_CHARGES=1): supply per-atom charges via the mol's "
            "'PartialCharges' property or a cached AM1 property, or unset "
            "TM_STRICT_CHARGES to accept the Gasteiger (PEOE) fallback."
        )
    warnings.warn(
        f"No {mode} charge cache on mol {mol.name!r} and the native AM1 backend could "
        f"not produce charges ({native_am1_failure}); falling back to native Gasteiger "
        "(PEOE) base charges. This CHANGES THE PHYSICS relative to AM1-family "
        "electrostatics — supply charges (or set TM_STRICT_CHARGES=1 to make this an "
        "error) for production-accuracy results.",
        GasteigerFallbackWarning,
    )
    from timemachine_torch.ff.gasteiger import gasteiger_charges

    q = gasteiger_charges(mol)
    scaled = q * np.sqrt(constants.ONE_4PI_EPS0)
    mol.props[GASTEIGER_CHARGE_CACHE] = base64.b64encode(pickle.dumps(list(scaled)))
    return scaled


class SerializableMixIn:
    def serialize(self):
        key = type(self).__name__[: -len(_SUFFIX)]
        patterns = []
        for smi, p in zip(self.smirks, self.params):
            if isinstance(p, (list, tuple)):
                patterns.append((smi, *p))
            elif isinstance(p, np.ndarray):
                patterns.append((smi, *p.tolist()))
            else:
                patterns.append((smi, float(p)))
        body = {"patterns": patterns}
        if getattr(self, "props", None) is not None:
            body["props"] = self.props
        return {key: body}


# --------------------------------------------------------------------------
# bonded handlers
# --------------------------------------------------------------------------


class ReversibleBondHandler(SerializableMixIn):
    """Assignment symmetric to index reversal (ref handlers/bonded.py:30-68)."""

    def __init__(self, smirks, params, props):
        self.smirks = smirks
        self.params = np.array(params, dtype=np.float64)
        self.props = props
        assert len(self.smirks) == len(self.params)

    def lookup_smirks(self, query):
        for s_idx, s in enumerate(self.smirks):
            if s == query:
                return self.params[s_idx]

    def partial_parameterize(self, params, mol):
        return self.static_parameterize(params, self.smirks, mol)

    def parameterize(self, mol):
        return self.static_parameterize(self.params, self.smirks, mol)

    @staticmethod
    def static_parameterize(params, smirks, mol):
        bond_idxs, param_idxs = generate_vd_idxs(mol, smirks)
        return params[param_idxs], bond_idxs


class HarmonicBondHandler(ReversibleBondHandler):
    @staticmethod
    def static_parameterize(params, smirks, mol):
        mol_params, bond_idxs = ReversibleBondHandler.static_parameterize(params, smirks, mol)
        mol_bonds = {tuple(sorted((b.src, b.dst))) for b in mol.bonds}
        ff_bonds = {tuple(sorted((int(i), int(j)))) for i, j in bond_idxs}
        if mol_bonds != ff_bonds:
            raise ValueError(
                "Did not preserve the bond table of input mol!\n"
                f"missing bonds (present in mol): {mol_bonds - ff_bonds}\n"
                f"new bonds (not present in mol): {ff_bonds - mol_bonds}"
            )
        if len(mol_params) == 0:
            mol_params = params[:0]
            bond_idxs = np.zeros((0, 2), dtype=np.int32)
        return mol_params, bond_idxs


class HarmonicAngleHandler(ReversibleBondHandler):
    @staticmethod
    def static_parameterize(params, smirks, mol):
        mol_params, angle_idxs = ReversibleBondHandler.static_parameterize(params, smirks, mol)
        if len(mol_params) == 0:
            mol_params = params[:0]
            angle_idxs = np.zeros((0, 3), dtype=np.int32)
        # third column: numerical-stability epsilon for the angle kernel
        mol_params = np.c_[mol_params, np.zeros(len(mol_params))]
        return mol_params, angle_idxs


class ProperTorsionHandler:
    """Variadic multi-term torsions (ref handlers/bonded.py:116-202)."""

    def __init__(self, smirks, params, props):
        self.counts = []
        self.smirks = []
        self.params = []
        for smi, terms in zip(smirks, params):
            self.smirks.append(smi)
            self.counts.append(len(terms))
            for term in terms:
                self.params.append(term)
        self.counts = np.array(self.counts, dtype=np.int32)
        self.params = np.array(self.params, dtype=np.float64)
        self.props = props

    def parameterize(self, mol):
        return self.static_parameterize(self.params, self.smirks, self.counts, mol)

    def partial_parameterize(self, params, mol):
        return self.static_parameterize(params, self.smirks, self.counts, mol)

    @staticmethod
    def static_parameterize(params, smirks, counts, mol):
        torsion_idxs, param_idxs = generate_vd_idxs(mol, smirks)
        scatter_idxs = []
        repeats = []
        pfxsum = np.concatenate([[0], np.cumsum(counts)])
        for p_idx in param_idxs:
            scatter_idxs.extend(range(pfxsum[p_idx], pfxsum[p_idx + 1]))
            repeats.append(counts[p_idx])
        if len(param_idxs) > 0:
            assigned_params = params[np.array(scatter_idxs)]
            proper_idxs = np.repeat(torsion_idxs, repeats, axis=0).astype(np.int32)
        else:
            assigned_params = params[:0]
            proper_idxs = np.zeros((0, 4), dtype=np.int32)
        return assigned_params, proper_idxs

    def serialize(self):
        list_params = []
        counter = 0
        for smi_idx in range(len(self.smirks)):
            t_params = []
            for _ in range(self.counts[smi_idx]):
                t_params.append(self.params[counter].tolist())
                counter += 1
            list_params.append(t_params)
        key = type(self).__name__[: -len(_SUFFIX)]
        return {key: {"patterns": [(s, p) for s, p in zip(self.smirks, list_params)]}}


class ImproperTorsionHandler(SerializableMixIn):
    """Trefoil impropers centered on atom 1 (ref handlers/bonded.py:205-263)."""

    def __init__(self, smirks, params, props):
        self.smirks = smirks
        self.params = np.array(params, dtype=np.float64)
        self.props = props
        assert self.params.shape[1] == 3
        assert len(self.smirks) == len(self.params)

    def partial_parameterize(self, params, mol):
        return self.static_parameterize(params, self.smirks, mol)

    def parameterize(self, mol):
        return self.static_parameterize(self.params, self.smirks, mol)

    @staticmethod
    def static_parameterize(params, smirks, mol):
        impropers = {}

        def make_key(idxs):
            ctr = idxs[1]
            nbs = sorted((idxs[0], idxs[2], idxs[3]))
            return nbs[0], ctr, nbs[1], nbs[2]

        for p_idx, patt in enumerate(smirks):
            for m in match_smirks(mol, patt):
                impropers[make_key(m)] = p_idx

        improper_idxs = []
        param_idxs = []
        for atom_idxs, p_idx in impropers.items():
            center = atom_idxs[1]
            others = [atom_idxs[0], atom_idxs[2], atom_idxs[3]]
            for i, j, k in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
                improper_idxs.append((others[i], center, others[j], others[k]))
                param_idxs.append(p_idx)
        if len(param_idxs) > 0:
            return params[np.array(param_idxs)], np.array(improper_idxs, dtype=np.int32)
        return params[:0], np.zeros((0, 4), dtype=np.int32)


# --------------------------------------------------------------------------
# nonbonded handlers
# --------------------------------------------------------------------------


class NonbondedHandler(SerializableMixIn):
    def __init__(self, smirks, params, props):
        assert len(smirks) == len(params)
        self.smirks = smirks
        self.params = np.array(params, dtype=np.float64)
        self.props = props

    def partial_parameterize(self, params, mol):
        return self.static_parameterize(params, self.smirks, mol)

    def parameterize(self, mol):
        return self.static_parameterize(self.params, self.smirks, mol)

    @staticmethod
    def static_parameterize(params, smirks, mol):
        param_idxs = generate_nonbonded_idxs(mol, smirks)
        return params[param_idxs]


class SimpleChargeHandler(NonbondedHandler):
    pass


class SimpleChargeIntraHandler(SimpleChargeHandler):
    pass


class SimpleChargeSolventHandler(SimpleChargeHandler):
    pass


class PrecomputedChargeHandler(SerializableMixIn):
    """Charges read off the molecule (per-atom PartialCharge props or a
    whitespace-separated PartialCharges mol prop) (ref nonbonded.py:392-410)."""

    def __init__(self, smirks=(), params=(), props=None):
        assert len(smirks) == 0 and len(params) == 0 and props is None
        self.smirks = []
        self.params = []
        self.props = None

    def parameterize(self, mol):
        if "PartialCharges" in mol.props:
            q = np.array([float(x) for x in str(mol.props["PartialCharges"]).split()])
        elif "atom.dprop.PartialCharge" in mol.props:
            # RDKit's atom-property serialization in SDF — the format the
            # reference's own charged test data uses
            # (testsystems/water_exchange/bb_centered_espaloma.sdf)
            q = np.array([float(x) for x in str(mol.props["atom.dprop.PartialCharge"]).split()])
        else:
            q = np.array([float(mol.props[f"PartialCharge_{i}"]) for i in range(mol.num_atoms)])
        assert len(q) == mol.num_atoms
        return q * np.sqrt(constants.ONE_4PI_EPS0)

    def partial_parameterize(self, _, mol):
        return self.parameterize(mol)


class PrecomputedChargeIntraHandler(PrecomputedChargeHandler):
    pass


class LennardJonesHandler(NonbondedHandler):
    @staticmethod
    def static_parameterize(params, smirks, mol):
        """FF stores (σ, √ε); engine wants (σ/2, √ε) (ref nonbonded.py:429-458)."""
        param_idxs = generate_nonbonded_idxs(mol, smirks)
        assigned = as_f64(params)[torch.as_tensor(param_idxs, dtype=torch.int64)]
        return torch.stack([assigned[:, 0] / 2, assigned[:, 1]], dim=1)


class LennardJonesIntraHandler(LennardJonesHandler):
    pass


class LennardJonesSolventHandler(LennardJonesHandler):
    pass


class GBSAHandler(NonbondedHandler):
    pass


class AM1Handler(SerializableMixIn):
    def __init__(self, smirks=(), params=(), props=None):
        assert len(smirks) == 0 and len(params) == 0 and props is None
        self.smirks, self.params, self.props = [], [], None

    def partial_parameterize(self, _, mol):
        return self.static_parameterize(mol)

    def parameterize(self, mol):
        return self.static_parameterize(mol)

    @staticmethod
    def static_parameterize(mol):
        return compute_or_load_base_charges(mol, mode="AM1")


class AM1BCCHandler(SerializableMixIn):
    def __init__(self, smirks=(), params=(), props=None):
        self.smirks, self.params, self.props = [], [], None

    def partial_parameterize(self, _, mol):
        return self.static_parameterize(mol)

    def parameterize(self, mol):
        return self.static_parameterize(mol)

    @staticmethod
    def static_parameterize(mol):
        return compute_or_load_base_charges(mol, mode="AM1BCCELF10")


class AM1BCCIntraHandler(AM1BCCHandler):
    pass


class AM1BCCSolventHandler(AM1BCCHandler):
    pass


class AM1CCCHandler(SerializableMixIn):
    """Correctable Charge Corrections: base charges + SMIRKS-matched bond
    charge increments; differentiable w.r.t. the increments — the charge-
    training surface (ref nonbonded.py:877-975)."""

    base_mode = "AM1ELF10"

    def __init__(self, smirks, params, props):
        assert len(smirks) == len(params)
        self.smirks = smirks
        self.params = np.array(params, dtype=np.float64)
        self.props = props
        self.supported_elements = {1, 6, 7, 8, 9, 14, 16, 17, 35, 53}

    def validate_input(self, mol):
        elements = set(int(z) for z in mol.atomic_nums)
        if not elements.issubset(self.supported_elements):
            raise RuntimeError("mol contains unsupported elements: ", elements - self.supported_elements)

    def partial_parameterize(self, params, mol):
        self.validate_input(mol)
        return self.static_parameterize(params, self.smirks, mol)

    def parameterize(self, mol):
        return self.partial_parameterize(self.params, mol)

    @classmethod
    def static_parameterize(cls, params, smirks, mol):
        base = compute_or_load_base_charges(mol, mode=cls.base_mode)
        bond_idxs, type_idxs = compute_or_load_bond_smirks_matches(mol, smirks)
        deltas = as_f64(params)[torch.as_tensor(type_idxs, dtype=torch.int64)] if len(type_idxs) else torch.zeros(0, dtype=torch.float64)
        q = apply_bond_charge_corrections(base, bond_idxs, deltas, runtime_validate=False)
        assert q.shape[0] == mol.num_atoms
        return q


class AM1CCCIntraHandler(AM1CCCHandler):
    pass


class AM1CCCSolventHandler(AM1CCCHandler):
    pass


class AM1BCCCCCHandler(AM1CCCHandler):
    """CCC on top of AM1BCCELF10 base charges; supports P
    (ref nonbonded.py:985-1019)."""

    base_mode = "AM1BCCELF10"

    def __init__(self, smirks, params, props):
        super().__init__(smirks, params, props)
        self.supported_elements.add(15)


class AM1BCCCCCIntraHandler(AM1BCCCCCHandler):
    pass


class AM1BCCCCCSolventHandler(AM1BCCCCCHandler):
    pass


NN_FEATURES_PROPNAME = "NNFeatures"


def eval_charge_nn(layer_weights, features):
    """Per-bond charge-delta MLP: silu hidden layers, linear scalar output
    (ref nonbonded.py:509-523 eval_nn)."""
    x = features
    for W in layer_weights[:-1]:
        h = W @ x
        x = h / (1.0 + torch.exp(-h))  # silu
    return torch.squeeze(layer_weights[-1] @ x)


class NNHandler(SerializableMixIn):
    """Neural bond-charge corrections: base AM1-family charges plus an MLP
    evaluated on precomputed per-bond features (ref nonbonded.py:526-577).

    The reference ships a pickled unflatten closure to reshape the flat
    parameter vector; here the layer shapes are carried explicitly in
    `props["layer_shapes"]` (list of (out, in) pairs), so serialization needs
    no code objects. Per-mol features live in
    mol.props["NNFeatures"] = {"atom_features": (N, Fa),
    "bond_idxs": (B, 2), "bond_src_features"/"bond_dst_features": (B, Fb)}
    (base64-pickled, as in the reference), produced by an external
    featurizer."""

    base_mode = "AM1BCCELF10"

    def __init__(self, smirks, params, props):
        self.smirks = smirks  # unused (kept for the serialization contract)
        if (params is None or len(np.atleast_1d(params)) == 0) and props and "flat_params" in props:
            params = props["flat_params"]
        self.params = np.asarray(params, dtype=np.float64).ravel()
        self.props = props

    def serialize(self):
        # the generic mixin zips smirks x params, which is empty here (no
        # patterns) — carry the flat weight vector in props instead so it
        # round-trips through deserialize_handlers
        props = dict(self.props or {})
        props["flat_params"] = self.params.tolist()
        props["layer_shapes"] = [list(s) for s in props["layer_shapes"]]
        return {"NN": {"patterns": [], "props": props}}

    def _layer_weights(self, flat_params):
        shapes = [tuple(s) for s in self.props["layer_shapes"]]
        weights, at = [], 0
        for out_d, in_d in shapes:
            weights.append(as_f64(flat_params[at : at + out_d * in_d]).reshape(out_d, in_d))
            at += out_d * in_d
        assert at == len(flat_params), "flat param vector does not match layer_shapes"
        return weights

    def get_bond_idxs_and_charge_deltas(self, flat_params, mol):
        features = pickle.loads(base64.b64decode(mol.props[NN_FEATURES_PROPNAME]))
        atom_f = np.asarray(features["atom_features"])
        bond_idxs = np.asarray(features["bond_idxs"], dtype=np.int32)
        src_f = np.asarray(features["bond_src_features"])
        dst_f = np.asarray(features["bond_dst_features"])

        # one feature row per bond: [atom_i | atom_j | src | dst]
        order = np.lexsort((bond_idxs[:, 1], bond_idxs[:, 0]))
        bond_idxs = bond_idxs[order]
        rows = np.concatenate([atom_f[bond_idxs[:, 0]], atom_f[bond_idxs[:, 1]], src_f[order], dst_f[order]], axis=1)

        weights = self._layer_weights(flat_params)
        deltas = torch.stack([eval_charge_nn(weights, f) for f in as_f64(rows)]) if len(rows) else torch.zeros(0, dtype=torch.float64)
        return bond_idxs, np.sqrt(constants.ONE_4PI_EPS0) * deltas

    def partial_parameterize(self, params, mol):
        base = compute_or_load_base_charges(mol, mode=self.base_mode)
        bond_idxs, deltas = self.get_bond_idxs_and_charge_deltas(params, mol)
        return apply_bond_charge_corrections(base, bond_idxs, deltas, runtime_validate=False)

    def parameterize(self, mol):
        return self.partial_parameterize(self.params, mol)


class EnvironmentBCCPartialHandler(SerializableMixIn):
    """Serializable carrier for environment (protein) BCC terms; concrete
    application requires a host topology (ref nonbonded.py:768-800).
    The host-side application lives in ff/envbcc.py and is gated on having a
    protein system."""

    def __init__(self, smirks, params, props):
        self.smirks = smirks
        self.params = np.array(params)
        self.props = props

    def get_env_handle(self, host_topology, ff):
        from timemachine_torch.ff.envbcc import EnvironmentBCCHandler

        return EnvironmentBCCHandler(self.smirks, self.params, ff.protein_ff, ff.water_ff, host_topology)


class EnvironmentNNPartialHandler(EnvironmentBCCPartialHandler):
    pass
