"""Environment (protein) bond-charge corrections (the port's copy of
timemachine_tpu/ff/envbcc.py; `parameterize` returns a torch float64
tensor, differentiable in the BCC parameters).

Parity target: reference ff/handlers/nonbonded.py EnvironmentBCCHandler
(:628-766): applies SMIRKS-matched BCCs to protein residue charges so
protein-ligand electrostatics can be trained. The concrete application
requires a parameterized host topology; this framework's host layer
(md/builders.py) produces `HostTopology` objects carrying residue templates.

Residue template molecules are built natively from the same residue SMILES
table the reference uses (published amino-acid protonation states).
"""

from __future__ import annotations

import numpy as np

import torch

# Amino-acid template SMILES (standard protonation states at pH 7; same
# published table the reference vendors, ff/handlers/utils.py:10-38)
SMILES_BY_RES_NAME = {
    "ACE": "CC=O",
    "NME": "CN",
    "ARG": "N[C@@H](CCC[NH+]=C(N)N)C(O)=O",
    "HID": "C1=C(NC=N1)C[C@@H](C(=O)O)N",
    "HIE": "N[C@@H](CC1=CNC=N1)C(O)=O",
    "HIP": "N[C@@H](CC1=CNC=[NH+]1)C(O)=O",
    "LYS": "N[C@@H](CCCC[NH3+])C(O)=O",
    "ASP": "N[C@@H](CC([O-])=O)C(O)=O",
    "ASH": "N[C@@H](CC(O)=O)C(O)=O",
    "GLU": "N[C@@H](CCC([O-])=O)C(O)=O",
    "GLH": "N[C@@H](CCC(O)=O)C(O)=O",
    "SER": "C([C@@H](C(=O)O)N)O",
    "THR": "C[C@H]([C@@H](C(=O)O)N)O",
    "ASN": "C([C@@H](C(=O)O)N)C(=O)N",
    "GLN": "C(CC(=O)N)[C@@H](C(=O)O)N",
    "CYS": "C([C@@H](C(=O)O)N)S",
    "CYM": "N[C@@H](C[S-])C(O)=O",
    "GLY": "C(C(=O)O)N",
    "PRO": "C1C[C@H](NC1)C(=O)O",
    "ALA": "C[C@H](N)C(=O)O",
    "VAL": "CC(C)[C@@H](C(=O)O)N",
    "ILE": "CC[C@H](C)[C@@H](C(=O)O)N",
    "LEU": "CC(C)C[C@@H](C(=O)O)N",
    "MET": "CSCC[C@@H](C(=O)O)N",
    "PHE": "C1=CC=C(C=C1)C[C@@H](C(=O)O)N",
    "TYR": "C1=CC(=CC=C1C[C@@H](C(=O)O)N)O",
    "TRP": "C1=CC=C2C(=C1)C(=CN2)C[C@@H](C(=O)O)N",
}


class EnvironmentBCCHandler:
    """Applies BCC increments to host (protein) charges per residue template.

    Requires a host topology object exposing residues with (name, elements,
    bonds, initial charges). Raises a clear error if none is available —
    mirroring the reference's gating on openmm.
    """

    def __init__(self, patterns, params, protein_ff_name, water_ff_name, host_topology):
        self.patterns = patterns
        self.params = np.array(params)
        self.protein_ff_name = protein_ff_name
        self.water_ff_name = water_ff_name
        self.host_topology = host_topology

    def parameterize(self, params):
        from timemachine_torch.chem.mol import Mol
        from timemachine_torch.ff.handlers import apply_bond_charge_corrections, as_f64, compute_or_load_bond_smirks_matches

        topo = self.host_topology
        if not hasattr(topo, "residues"):
            raise NotImplementedError(
                "EnvironmentBCCHandler requires a host topology with residue templates; "
                "build the host with md.builders.build_protein_system"
            )
        if getattr(topo, "charges", None) is None:
            raise ValueError(
                "EnvironmentBCCHandler requires the host's charges in its topology record; "
                "build the host with md.builders.build_protein_system and do not permute it"
            )
        params = as_f64(params)
        final_charges = []
        cur = 0
        for res in topo.residues:
            n = len(res.atomic_nums)
            init_q = as_f64(topo.charges[cur : cur + n])
            if res.name not in SMILES_BY_RES_NAME:
                final_charges.append(init_q)
                cur += n
                continue
            orders = getattr(res, "bond_orders", None)
            bonds = res.bonds if orders is None else [(i, j, o) for (i, j), o in zip(res.bonds, orders)]
            res_mol = Mol.from_arrays(res.atomic_nums, bonds)
            bond_idxs, type_idxs = compute_or_load_bond_smirks_matches(res_mol, self.patterns)
            deltas = params[torch.as_tensor(type_idxs, dtype=torch.int64)] if len(type_idxs) else params.new_zeros(0)
            final_charges.append(apply_bond_charge_corrections(init_q, bond_idxs, deltas, runtime_validate=False))
            cur += n
        return torch.cat(final_charges)
