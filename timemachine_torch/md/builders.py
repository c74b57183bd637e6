"""System builders: water boxes (the port's copy of HostConfig, HostTopology
and build_water_system of timemachine_tpu/md/builders.py, with the host's
potentials as fe/terms.py's HostTerms).

Parity target: reference timemachine/md/builders.py (build_water_system:315).
Water boxes are built natively (lattice placement + clash deletion +
flexible TIP3P parameters). The PDB, protein and host-config file builders
are not ported yet (build_protein_system raises NotImplementedError).

Water parameters are the public amber14/tip3p values (flexible variant, since
the engine is unconstrained like the reference, which builds with
rigidWater=False).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

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
    bonds: list


@dataclass
class HostTopology:
    """Minimal host topology record (replaces the reference's OpenMM topology
    handle): residue templates for env-BCC, atom group indices for barostats."""

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


def build_protein_system(*args, **kwargs):
    """Not ported yet: the protein builders come with the coordinate builders
    (ROADMAP queue 1 item 2b)."""
    raise NotImplementedError("build_protein_system is not ported yet (ROADMAP queue 1 item 2b)")
