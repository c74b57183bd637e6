"""System builders: water boxes and protein systems (the port's copy of
timemachine_tpu/md/builders.py, with the host's potentials as fe/terms.py's
HostTerms).

Parity target: reference timemachine/md/builders.py (build_water_system:315,
build_protein_system:197). Water boxes are built natively (lattice placement
+ clash deletion + flexible TIP3P parameters). Protein systems are built
natively too: the PDB's graph perceived by chem/pdb.py, Amber parameters
assigned by ff/amber_xml.py from the shipped amber99sb set (the framework's
SMIRKS typing where the templates do not match), solvated on the same
lattice. The JAX package's OpenMM branch runs only where `import openmm`
succeeds; the port always takes the native path (ROADMAP P36).

Water parameters are the public amber14/tip3p values (flexible variant, since
the engine is unconstrained like the reference, which builds with
rigidWater=False).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from timemachine_torch.constants import DEFAULT_NB_BETA, DEFAULT_NB_CUTOFF, ONE_4PI_EPS0
from timemachine_torch.fe import terms as potentials
from timemachine_torch.fe.terms import HostTerms

# flexible TIP3P (amber14), public parameters
TIP3P = {
    "q_O": -0.834,
    "q_H": 0.417,
    "sig_O": 0.315061,  # nm
    "eps_O": 0.635968,  # kJ/mol
    "sig_H": 0.1,  # inert (eps 0)
    "eps_H": 0.0,
    "r_OH": 0.09572,  # nm
    "k_OH": 462750.4,  # kJ/mol/nm^2
    "theta_HOH": 1.82421813418,  # rad
    "k_HOH": 836.8,  # kJ/mol/rad^2
    "mass_O": 15.99943,
    "mass_H": 1.007947,
}

# Joung-Cheatham monovalent ion parameters for TIP3P (public)
ION_PARAMS = {
    "Na+": {"q": 1.0, "sig": 0.2439281, "eps": 0.3658460312, "mass": 22.98977},
    "Cl-": {"q": -1.0, "sig": 0.4477657, "eps": 0.0355910174, "mass": 35.453},
}

WATER_DENSITY_PER_NM3 = 33.3  # molecules/nm^3 at 997 kg/m^3


@dataclass
class HostResidue:
    name: str
    atomic_nums: list
    bonds: list  # (i, j) within the residue, or (i, j, order)
    bond_orders: Optional[list] = None  # one per bond where `bonds` holds pairs (build_protein_system's residues)


@dataclass
class HostTopology:
    """Minimal host topology record (replaces the reference's OpenMM topology
    handle): residue templates for env-BCC, atom group indices for barostats,
    and the host's charges in the nonbonded parameters' units (written by
    build_protein_system; env-BCC corrects them)."""

    residues: list
    group_idxs: list
    charges: Optional[np.ndarray] = None


class HostConfig:
    """(ref free_energy.py:59-66)"""

    def __init__(self, host_system: HostTerms, conf, box, num_water_atoms, host_topology, masses):
        self.host_system = host_system
        self.conf = np.asarray(conf)
        self.box = np.asarray(box)
        self.num_water_atoms = num_water_atoms
        self.host_topology = host_topology
        # API-compat alias with the reference's naming
        self.omm_topology = host_topology
        self.masses = np.array(masses)


def _water_geometry():
    """One TIP3P water: O at origin, Hs in the xy-plane."""
    r = TIP3P["r_OH"]
    theta = TIP3P["theta_HOH"]
    h1 = np.array([r, 0.0, 0.0])
    h2 = np.array([r * np.cos(theta), r * np.sin(theta), 0.0])
    return np.stack([np.zeros(3), h1, h2])


def _random_rotations(n, rng):
    """Uniform random rotation matrices via quaternions."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            np.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x**2 + z**2), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x**2 + y**2)], -1),
        ],
        axis=1,
    )


def _build_water_potentials(n_waters, extra_particles=()):
    """Bound potentials for n_waters TIP3P waters (+ optional ions appended).

    extra_particles: sequence of ION_PARAMS-style dicts.
    """
    n_ions = len(extra_particles)
    n_atoms = 3 * n_waters + n_ions

    bond_idxs, bond_params = [], []
    angle_idxs, angle_params = [], []
    exclusion_idxs, exclusion_scales = [], []
    nb_params = np.zeros((n_atoms, 4))
    masses = np.zeros(n_atoms)
    scale_q = np.sqrt(ONE_4PI_EPS0)

    for w in range(n_waters):
        o, h1, h2 = 3 * w, 3 * w + 1, 3 * w + 2
        bond_idxs += [[o, h1], [o, h2]]
        bond_params += [[TIP3P["k_OH"], TIP3P["r_OH"]]] * 2
        angle_idxs += [[h1, o, h2]]
        angle_params += [[TIP3P["k_HOH"], TIP3P["theta_HOH"], 0.0]]
        exclusion_idxs += [[o, h1], [o, h2], [h1, h2]]
        exclusion_scales += [[1.0, 1.0]] * 3
        nb_params[o] = [TIP3P["q_O"] * scale_q, TIP3P["sig_O"] / 2, np.sqrt(TIP3P["eps_O"]), 0.0]
        nb_params[h1] = [TIP3P["q_H"] * scale_q, TIP3P["sig_H"] / 2, 0.0, 0.0]
        nb_params[h2] = [TIP3P["q_H"] * scale_q, TIP3P["sig_H"] / 2, 0.0, 0.0]
        masses[o] = TIP3P["mass_O"]
        masses[h1] = masses[h2] = TIP3P["mass_H"]

    for k, ion in enumerate(extra_particles):
        i = 3 * n_waters + k
        nb_params[i] = [ion["q"] * scale_q, ion["sig"] / 2, np.sqrt(ion["eps"]), 0.0]
        masses[i] = ion["mass"]

    bond_pot = potentials.HarmonicBond(np.array(bond_idxs, dtype=np.int32).reshape(-1, 2)).bind(
        np.array(bond_params).reshape(-1, 2)
    )
    angle_pot = potentials.HarmonicAngle(np.array(angle_idxs, dtype=np.int32).reshape(-1, 3)).bind(
        np.array(angle_params).reshape(-1, 3)
    )
    proper_pot = potentials.PeriodicTorsion(np.zeros((0, 4), dtype=np.int32)).bind(np.zeros((0, 3)))
    improper_pot = potentials.PeriodicTorsion(np.zeros((0, 4), dtype=np.int32)).bind(np.zeros((0, 3)))
    nb_pot = potentials.Nonbonded(
        n_atoms,
        np.array(exclusion_idxs, dtype=np.int32).reshape(-1, 2),
        np.array(exclusion_scales).reshape(-1, 2),
        DEFAULT_NB_BETA,
        DEFAULT_NB_CUTOFF,
    ).bind(nb_params)

    system = HostTerms(
        bond=bond_pot, angle=angle_pot, proper=proper_pot, improper=improper_pot, nonbonded_all_pairs=nb_pot
    )
    return system, masses


def build_water_system(
    box_width: float,
    water_ff: str = "tip3p",
    mols: Optional[Sequence] = None,
    ionic_concentration: float = 0.0,
    neutralize: bool = False,
    seed: int = 2024,
) -> HostConfig:
    """Cubic water box of side box_width (nm), waters deleted where they
    clash with the given mols (ref builders.py:315-416 behavior, built
    natively). Box margins match bulk density; run the minimizer +
    pre-equilibration (md.minimizer) before production, as the reference does.
    """
    from timemachine_torch.ff import sanitize_water_ff

    if ionic_concentration < 0.0:
        raise ValueError("Ionic concentration must be greater than or equal to 0.0")
    if sanitize_water_ff(water_ff) != "tip3p":
        raise NotImplementedError(f"native water builder supports tip3p variants, got {water_ff}")

    rng = np.random.default_rng(seed)
    n_target = int(round(WATER_DENSITY_PER_NM3 * box_width**3))
    n_side = int(np.ceil(n_target ** (1 / 3)))
    spacing = box_width / n_side

    # simple-cubic O lattice, randomly oriented waters, jittered slightly
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij")).reshape(3, -1).T
    centers = (grid[:n_target] + 0.5) * spacing
    centers += rng.normal(0, 0.01, centers.shape)
    rots = _random_rotations(len(centers), rng)
    template = _water_geometry()
    waters = centers[:, None, :] + np.einsum("nij,aj->nai", rots, template)

    # delete clashy waters (any atom within 0.21 nm of a mol atom; the
    # reference uses a similar minimum-distance criterion via Modeller)
    if mols:
        keep = np.ones(len(waters), dtype=bool)
        lig_coords = np.concatenate([m.get_conf() for m in mols])
        for i, wat in enumerate(waters):
            d = np.linalg.norm(wat[:, None, :] - lig_coords[None, :, :], axis=-1)
            if d.min() < 0.21:
                keep[i] = False
        waters = waters[keep]

    n_waters = len(waters)

    ions = []
    if neutralize and mols:
        net = int(round(sum(m.total_charge() for m in mols)))
        ion_name = "Cl-" if net > 0 else "Na+"
        ions += [ION_PARAMS[ion_name]] * abs(net)
    if ionic_concentration > 0:
        # pairs of Na+/Cl- at the requested molarity (55.5 M water reference)
        n_pairs = int(round(ionic_concentration * n_waters / 55.5))
        ions += [ION_PARAMS["Na+"], ION_PARAMS["Cl-"]] * n_pairs

    # ions replace random waters
    if ions:
        assert len(ions) < n_waters
        replace = rng.choice(n_waters, size=len(ions), replace=False)
        ion_coords = waters[replace, 0, :]
        keep_mask = np.ones(n_waters, dtype=bool)
        keep_mask[replace] = False
        waters = waters[keep_mask]
        n_waters = len(waters)
        conf = np.concatenate([waters.reshape(-1, 3), ion_coords])
    else:
        conf = waters.reshape(-1, 3)

    system, masses = _build_water_potentials(n_waters, ions)
    box = np.eye(3) * box_width

    group_idxs = [np.arange(3 * w, 3 * w + 3) for w in range(n_waters)]
    group_idxs += [np.array([3 * n_waters + k]) for k in range(len(ions))]
    residues = [HostResidue("HOH", [8, 1, 1], [(0, 1), (0, 2)]) for _ in range(n_waters)]
    residues += [HostResidue("ION", [11], []) for _ in ions]
    topology = HostTopology(residues=residues, group_idxs=group_idxs)

    return HostConfig(system, conf, box, 3 * n_waters, topology, masses)


def build_water_system_from_pdb(water_pdb) -> HostConfig:
    """Pure-water box read from a PDB file (path or raw text): coordinates
    and box come from the file, TIP3P parameters from the native tables
    (the prepared water-exchange systems of the reference's
    testsystems/water_exchange/ load this way)."""
    from timemachine_torch.chem.pdb import parse_pdb

    structure = parse_pdb(water_pdb)
    if structure.residues or structure.ions:
        raise NotImplementedError("build_water_system_from_pdb supports pure-water PDBs")
    if structure.box is None:
        raise ValueError("water PDB must carry a CRYST1 record")

    waters = []
    for res in structure.waters:
        # order O, H, H regardless of file order (elements are symbols)
        order = np.argsort([0 if str(el).upper() in ("O", "8") else 1 for el in res.elements])
        coords = np.asarray(res.coords, dtype=np.float64)[order] / 10.0  # Å → nm
        elements = [str(res.elements[i]).upper() for i in order]
        if elements not in (["O", "H", "H"], ["8", "1", "1"]):
            raise ValueError(f"water residue with elements {elements}")
        waters.append(coords)
    n_waters = len(waters)
    conf = np.concatenate(waters, axis=0)

    system, masses = _build_water_potentials(n_waters)
    group_idxs = [np.arange(3 * w, 3 * w + 3) for w in range(n_waters)]
    residues = [HostResidue("HOH", [8, 1, 1], [(0, 1), (0, 2)]) for _ in range(n_waters)]
    topology = HostTopology(residues=residues, group_idxs=group_idxs)
    return HostConfig(system, conf, structure.box.copy(), 3 * n_waters, topology, masses)


def strip_units(coords):
    return np.asarray(coords)


def build_protein_system(host_pdbfile, protein_ff: str, water_ff: str, mols=None, box_margin: float = 0.0) -> HostConfig:
    """Solvated protein system with ~1 nm padding (ref md/builders.py:197-313),
    built natively: the PDB (a path or raw text) perceived by chem/pdb.py,
    Amber host physics from the shipped reconstructed amber99sb set
    (ff/amber_xml.py) for any amber* protein_ff (a path-like protein_ff
    names another XML), the framework's SMIRKS typing for any other
    protein_ff and for residues the Amber templates cannot match (with a
    warning), the PDB's waters kept and a TIP3P lattice carved around the
    solute and `mols`. Atoms are [protein, waters]."""
    import os
    import warnings

    from timemachine_torch.chem.pdb import parse_pdb, protein_mol_from_pdb
    from timemachine_torch.chem.periodic import ATOMIC_NUM
    from timemachine_torch.fe.topology import _SCALE_12, _SCALE_13, _SCALE_14_LJ, _SCALE_14_Q
    from timemachine_torch.ff import Forcefield, sanitize_water_ff
    from timemachine_torch.ff.handlers import generate_exclusion_idxs
    from timemachine_torch.md.utils import get_group_indices

    if sanitize_water_ff(water_ff) != "tip3p":
        raise NotImplementedError(f"native protein builder supports tip3p water, got {water_ff}")

    structure = parse_pdb(host_pdbfile)
    protein = protein_mol_from_pdb(structure)
    n_p = protein.num_atoms
    p_conf = protein.get_conf()

    amber_paths = None
    if protein_ff.endswith(".xml") and os.path.exists(protein_ff):
        amber_paths = [protein_ff]
    elif os.path.exists(f"{protein_ff}.xml"):
        amber_paths = [f"{protein_ff}.xml"]
    elif protein_ff.startswith("amber"):
        from timemachine_torch.ff.amber_xml import AMBER99SB_XML

        amber_paths = [str(AMBER99SB_XML)]
        if "ildn" in protein_ff:
            warnings.warn(
                f"protein_ff={protein_ff!r}: using the shipped reconstructed "
                "amber99sb parameter set; the ILDN side-chain chi corrections "
                "are NOT included (their fitted amplitudes are not "
                "reproducible offline with confidence — deliberately not "
                "guessed). Pass the path of a real XML as protein_ff for "
                "certified amber99sbildn physics.",
                stacklevel=2,
            )

    amber_masses = None
    ap = None
    if amber_paths is not None:
        from timemachine_torch.ff.amber_xml import AmberAssignmentError, AmberForceField, assign_protein_parameters

        try:
            aff = AmberForceField.parse(amber_paths)
            ap = assign_protein_parameters(structure, protein, aff)
        except AmberAssignmentError as e:
            if protein_ff.endswith(".xml"):
                raise  # an explicitly-supplied XML failing is an error
            warnings.warn(
                f"Amber template assignment failed ({e}); falling back to "
                "native SMIRNOFF-host parameterization (not Amber-parity).",
                stacklevel=2,
            )
    if ap is not None:
        bond_idxs, bond_params = ap.bond_idxs, ap.bond_params
        angle_idxs, angle_params = ap.angle_idxs, ap.angle_params
        proper_idxs, proper_params = ap.proper_idxs, ap.proper_params
        improper_idxs, improper_params = ap.improper_idxs, ap.improper_params
        q_params = ap.charges * np.sqrt(ONE_4PI_EPS0)
        lj_params = np.stack([ap.lj[:, 0] / 2.0, np.sqrt(ap.lj[:, 1])], axis=1)
        excl_idxs, excl_scales = ap.exclusion_idxs, ap.exclusion_scales
        if np.all(ap.masses > 0):
            amber_masses = ap.masses
    else:
        ff = Forcefield.load_default()
        warnings.warn(
            f"protein_ff={protein_ff!r} is not an Amber forcefield name/XML (or its "
            "templates did not match): using NATIVE SMIRNOFF-host parameterization "
            "(framework SMIRKS typing + standard base-charge policy). This is not "
            "Amber-parity physics; pass protein_ff='amber99sbildn' (shipped set) or "
            "the path of an Amber XML for Amber hosts."
        )
        bond_params, bond_idxs = ff.hb_handle.parameterize(protein)
        angle_params, angle_idxs = ff.ha_handle.parameterize(protein)
        proper_params, proper_idxs = ff.pt_handle.parameterize(protein)
        improper_params, improper_idxs = ff.it_handle.parameterize(protein)
        q_params = _numpy(ff.q_handle.parameterize(protein))  # sqrt(ONE_4PI_EPS0)-scaled
        lj_params = _numpy(ff.lj_handle.parameterize(protein))  # (sig/2, sqrt(eps))
        excl_idxs, excl_scales = generate_exclusion_idxs(
            protein, scale12=_SCALE_12, scale13=_SCALE_13, scale14_lj=_SCALE_14_LJ, scale14_q=_SCALE_14_Q
        )

    # pre-equilibrated waters shipped in the PDB keep their coordinates
    pdb_water_coords = []
    for res in structure.waters:
        order = np.argsort([0 if el == "O" else 1 for el in res.elements])  # O first
        if len(res.atom_names) != 3:
            raise ValueError(f"non-3-site water {res.name} {res.resseq}")
        pdb_water_coords.append(np.asarray(res.coords, dtype=np.float64)[order] / 10.0)
    if structure.ions:
        raise NotImplementedError("PDB ions not supported by the native protein builder yet")

    presolvated = structure.box is not None and pdb_water_coords
    if presolvated:
        # an equilibrated system shipped with its own box: coordinates and box as they are, no lattice waters
        box_width = float(np.max(np.diagonal(structure.box)))
        waters = pdb_water_coords
    else:
        # solvation box (reference: extent + 1 nm padding + margin), cubic like build_water_system, and at
        # least what the nonbonded cutoff's minimum image needs
        padding = 1.0
        solute = np.concatenate([p_conf] + pdb_water_coords) if pdb_water_coords else p_conf
        box_lengths = np.amax(solute, axis=0) - np.amin(solute, axis=0) + padding + box_margin
        box_width = max(float(np.max(box_lengths)), 2 * DEFAULT_NB_CUTOFF + 0.15)
        # the protein and the PDB's waters move by `shift`; the ligands do not (ROADMAP R13)
        shift = box_width / 2.0 - (np.amax(solute, axis=0) + np.amin(solute, axis=0)) / 2.0
        p_conf = p_conf + shift
        pdb_water_coords = [w + shift for w in pdb_water_coords]

        # lattice waters, carved around protein + pdb waters + ligands
        rng = np.random.default_rng(2024)
        n_target = int(round(WATER_DENSITY_PER_NM3 * box_width**3))
        n_side = int(np.ceil(n_target ** (1 / 3)))
        spacing = box_width / n_side
        grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij")).reshape(3, -1).T
        centers = (grid[:n_target] + 0.5) * spacing + rng.normal(0, 0.01, (n_target, 3))
        rots = _random_rotations(len(centers), rng)
        lattice = centers[:, None, :] + np.einsum("nij,aj->nai", rots, _water_geometry())

        from scipy.spatial import cKDTree

        occupied = [p_conf] + pdb_water_coords
        if mols:
            occupied += [m.get_conf() + shift for m in mols]
        tree = cKDTree(np.concatenate(occupied))
        d, _ = tree.query(lattice.reshape(-1, 3), k=1)
        keep = d.reshape(-1, 3).min(axis=1) > 0.24  # reference Modeller-like clash criterion
        lattice = lattice[keep]
        waters = pdb_water_coords + [lattice.reshape(-1, 3)]

    water_conf = np.concatenate([np.asarray(w).reshape(-1, 3) for w in waters])
    n_w = len(water_conf) // 3

    # assemble combined host arrays: [protein, waters]
    w_sys, w_masses = _build_water_potentials(n_w)
    off = n_p

    def _cat_idxs(a, b):
        return np.concatenate([np.asarray(a, dtype=np.int32), np.asarray(b, dtype=np.int32) + off])

    bond_pot = potentials.HarmonicBond(_cat_idxs(bond_idxs, w_sys.bond.potential.idxs)).bind(
        np.concatenate([_numpy(bond_params).reshape(-1, 2), _numpy(w_sys.bond.params)])
    )
    angle_pot = potentials.HarmonicAngle(_cat_idxs(angle_idxs, w_sys.angle.potential.idxs)).bind(
        np.concatenate([_numpy(angle_params).reshape(-1, 3), _numpy(w_sys.angle.params)])
    )
    proper_pot = potentials.PeriodicTorsion(np.asarray(proper_idxs, dtype=np.int32).reshape(-1, 4)).bind(
        _numpy(proper_params).reshape(-1, 3)
    )
    improper_pot = potentials.PeriodicTorsion(np.asarray(improper_idxs, dtype=np.int32).reshape(-1, 4)).bind(
        _numpy(improper_params).reshape(-1, 3)
    )

    n_atoms = n_p + 3 * n_w
    nb_params = np.zeros((n_atoms, 4))
    nb_params[:n_p, 0] = q_params
    nb_params[:n_p, 1:3] = lj_params
    nb_params[n_p:] = _numpy(w_sys.nonbonded_all_pairs.params)
    all_excl = _cat_idxs(excl_idxs, w_sys.nonbonded_all_pairs.potential.exclusion_idxs)
    all_scales = np.concatenate(
        [np.asarray(excl_scales).reshape(-1, 2), np.asarray(w_sys.nonbonded_all_pairs.potential.scale_factors)]
    )
    nb_pot = potentials.Nonbonded(n_atoms, all_excl, all_scales, DEFAULT_NB_BETA, DEFAULT_NB_CUTOFF).bind(nb_params)

    system = HostTerms(
        bond=bond_pot, angle=angle_pot, proper=proper_pot, improper=improper_pot, nonbonded_all_pairs=nb_pot
    )
    masses = np.concatenate([amber_masses if amber_masses is not None else protein.masses, w_masses])
    conf = np.concatenate([p_conf, water_conf])
    box = np.eye(3) * box_width

    # topology record: protein residues (for env-BCC) then waters
    atom_offset = 0
    residues = []
    for res in structure.residues:
        na = len(res.atom_names)
        z = [int(ATOMIC_NUM.get(el, 0)) for el in res.elements]
        intra = [b for b in protein.bonds if atom_offset <= b.src < atom_offset + na and atom_offset <= b.dst < atom_offset + na]
        residues.append(
            HostResidue(res.name, z, [(b.src - atom_offset, b.dst - atom_offset) for b in intra], [b.order for b in intra])
        )
        atom_offset += na
    residues += [HostResidue("HOH", [8, 1, 1], [(0, 1), (0, 2)]) for _ in range(n_w)]

    bond_list = [tuple(map(int, b)) for b in np.asarray(bond_pot.potential.idxs)]
    group_idxs = get_group_indices(bond_list, n_atoms)
    # the charges too (the JAX package's record leaves them None): env-BCC reads them (ROADMAP R14)
    host_topology = HostTopology(residues, group_idxs, nb_params[:, 0].copy())

    print("built a native protein system with", n_p, "protein atoms and", 3 * n_w, "water atoms")
    return HostConfig(
        host_system=system,
        conf=conf,
        box=box,
        num_water_atoms=3 * n_w,
        host_topology=host_topology,
        masses=masses,
    )


def _numpy(x) -> np.ndarray:
    """A handler's or a bound potential's parameters as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def host_config_arrays(cfg: HostConfig) -> dict:
    """The host's arrays under the keys of the JAX package's host npz
    (testsystems/dhfr.py's load_host_arrays)."""
    hs = cfg.host_system
    nb = hs.nonbonded_all_pairs
    a = {}
    for term in ("bond", "angle", "proper", "improper"):
        a[f"{term}_idxs"] = np.asarray(getattr(hs, term).potential.idxs)
        a[f"{term}_params"] = _numpy(getattr(hs, term).params)
    a.update(
        excl_idxs=np.asarray(nb.potential.exclusion_idxs),
        excl_scales=np.asarray(nb.potential.scale_factors),
        nb_params=_numpy(nb.params),
        beta=nb.potential.beta,
        cutoff=nb.potential.cutoff,
        conf=cfg.conf,
        box=cfg.box,
        masses=cfg.masses,
        num_water_atoms=cfg.num_water_atoms,
    )
    return a


def _host_terms(a: dict) -> HostTerms:
    n = a["conf"].shape[0]
    return HostTerms(
        bond=potentials.HarmonicBond(a["bond_idxs"]).bind(a["bond_params"]),
        angle=potentials.HarmonicAngle(a["angle_idxs"]).bind(a["angle_params"]),
        proper=potentials.PeriodicTorsion(a["proper_idxs"].reshape(-1, 4)).bind(a["proper_params"]),
        improper=potentials.PeriodicTorsion(a["improper_idxs"].reshape(-1, 4)).bind(a["improper_params"]),
        nonbonded_all_pairs=potentials.Nonbonded(
            n, a["excl_idxs"], a["excl_scales"], float(a["beta"]), float(a["cutoff"])
        ).bind(a["nb_params"]),
    )


def permute_host_config_atoms(cfg: HostConfig, perm: np.ndarray) -> HostConfig:
    """Re-number host atoms by `perm` (new_conf[i] = conf[perm[i]]), term rows
    whose atoms are all waters leading (testsystems/dhfr.py's
    permute_host_arrays; ref md/builders.py:623). Energies are invariant;
    the returned config is for standalone (apo) use: num_water_atoms keeps
    its count but the waters-last indexing no longer holds, and the
    topology record drops the host's charges (as JAX's never has them)."""
    from timemachine_torch.testsystems.dhfr import permute_host_arrays

    a = permute_host_arrays(host_config_arrays(cfg), perm)
    inv = np.empty(len(perm), dtype=np.int64)
    inv[np.asarray(perm, dtype=np.int64)] = np.arange(len(perm))
    group_idxs = [np.sort(inv[g]) for g in cfg.host_topology.group_idxs]
    # no charges: env-BCC walks the residues over contiguous atoms, which no longer holds, and refuses the record
    topology = HostTopology(cfg.host_topology.residues, group_idxs, None)
    return HostConfig(_host_terms(a), a["conf"], cfg.box, cfg.num_water_atoms, topology, a["masses"])


def save_host_config(cfg: HostConfig, path: str):
    """Serialize a parameterized HostConfig's arrays to an npz (term idxs +
    params + conf/box/masses); pairs with load_host_config."""
    np.savez_compressed(path, **host_config_arrays(cfg))


def load_host_config(path: str) -> "HostConfig | None":
    """Rebuild a HostConfig from save_host_config's npz; None if unreadable.
    The topology record carries group indices (recomputed from bonds) but no
    residue templates: env-BCC callers need the full build."""
    from timemachine_torch.md.utils import get_group_indices
    from timemachine_torch.testsystems.dhfr import load_host_arrays

    try:
        a = load_host_arrays(path)
        n = a["conf"].shape[0]
        group_idxs = get_group_indices([tuple(map(int, b)) for b in a["bond_idxs"]], n)
        topology = HostTopology(residues=[], group_idxs=group_idxs)
        return HostConfig(_host_terms(a), a["conf"], a["box"], int(a["num_water_atoms"]), topology, a["masses"])
    except Exception:
        return None
