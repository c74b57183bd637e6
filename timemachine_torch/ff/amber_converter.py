"""Extract residue templates (atoms, bonds, charges, BCC symmetry classes)
from Amber-style OpenMM XML forcefields (the port's copy of
timemachine_tpu/ff/amber_converter.py; an offline tool, the standard
library only).

Parity target: reference `timemachine/ff/amber_converter.py` — an offline
data-prep tool for protein-ligand charge fitting: per-residue atom/bond
typing feeding EnvironmentBCC (:83-312; the RDKit grid drawing there is
omitted — see fe/dummy_draw.py for native drawing utilities).

This framework's runtime env-BCC (ff/envbcc.py) uses native residue SMILES
templates; this converter exists so users can regenerate templates from any
Amber XML (e.g. amber99sbildn.xml from an OpenMM installation).

Usage:
    python -m timemachine_torch.ff.amber_converter amber99sbildn.xml \
        --method template_bond --output_path templates.py
"""

from __future__ import annotations

import pprint
from argparse import ArgumentParser
from typing import Any
from xml.dom import minidom

STANDARD_RESIDUES = [
    "ace", "ala", "arg", "asn", "asp", "cys", "cym", "cyx", "gln", "glh",
    "glu", "gly", "hip", "hid", "hie", "ile", "leu", "lys", "met", "nme",
    "nmet", "phe", "pro", "ser", "thr", "trp", "tyr", "val",
]


def dual_sort(src_key, dst_key, src_idx, dst_idx):
    """Canonicalize a typed bond while preserving BCC directionality
    (ref amber_converter.py:74-80)."""
    if src_key < dst_key:
        return src_key, dst_key, src_idx, dst_idx
    return dst_key, src_key, dst_idx, src_idx


def convert_amber_xml(input_path: str, method: str = "template_bond", standard_only: bool = True) -> dict:
    """Parse an Amber-style OpenMM XML into per-residue templates.

    Returns {residue_name: {"atoms": [element symbols], "atom_names": [...],
    "atom_types": [...], "charges": [...], "bonds": [(i, j)],
    "bond_classes": [class index]}} where bond class indices define the BCC
    symmetry classes under the chosen method:

    method="harmonic_bond": classes from the bonded-force atom CLASSES
        (over-symmetrizes; ref amber_converter.py:165-188)
    method="template_bond": classes from the residue template atom TYPES
        (under-symmetrizes; ref amber_converter.py:190-209)
    """
    assert method in ("harmonic_bond", "template_bond")
    xmldoc = minidom.parse(input_path)

    # atom type -> element / class tables
    name_to_elem: dict[str, str] = {}
    name_to_class: dict[str, str] = {}
    for atom_info in xmldoc.getElementsByTagName("Type"):
        name = atom_info.attributes["name"].value
        name_to_elem[name] = atom_info.attributes.get("element").value if atom_info.attributes.get("element") else "X"
        name_to_class[name] = atom_info.attributes["class"].value

    # harmonic-bond class pairs (for validation in harmonic_bond mode)
    hb_bond_set = set()
    for force in xmldoc.getElementsByTagName("HarmonicBondForce"):
        for cn in force.childNodes:
            if cn.nodeName == "Bond":
                c1 = cn.attributes["class1"].value
                c2 = cn.attributes["class2"].value
                hb_bond_set.add(tuple(sorted((c1, c2))))

    # per-atom-type nonbonded parameter hash (charge symmetry refinement,
    # ref amber_converter.py:111-126)
    nb_hash: dict[str, str] = {}
    charge_of: dict[str, float] = {}
    for force in xmldoc.getElementsByTagName("NonbondedForce"):
        for cn in force.childNodes:
            if cn.nodeName == "Atom":
                a_type = str(cn.attributes["type"].value)
                charge = cn.attributes["charge"].value
                sig = cn.attributes["sigma"].value
                eps = cn.attributes["epsilon"].value
                nb_hash[a_type] = f"{charge}_{sig}_{eps}"
                charge_of[a_type] = float(charge)

    residues: dict[str, Any] = {}
    for res in xmldoc.getElementsByTagName("Residue"):
        res_name = res.attributes["name"].value
        if standard_only and res_name.lower() not in STANDARD_RESIDUES:
            continue

        atom_types: list[str] = []
        atom_names: list[str] = []
        bonds: list[tuple] = []
        bond_classes: list[int] = []
        bond_type_map: dict[tuple, int] = {}

        for cn in res.childNodes:
            if cn.nodeName == "Atom":
                atom_types.append(str(cn.attributes["type"].value))
                atom_names.append(str(cn.attributes["name"].value))
            elif cn.nodeName == "Bond":
                src_idx = int(cn.attributes["from"].value)
                dst_idx = int(cn.attributes["to"].value)
                if method == "harmonic_bond":
                    src_key = name_to_class[atom_types[src_idx]]
                    dst_key = name_to_class[atom_types[dst_idx]]
                else:
                    src_key = atom_types[src_idx]
                    dst_key = atom_types[dst_idx]
                src_key, dst_key, s, d = dual_sort(src_key, dst_key, src_idx, dst_idx)
                if method == "harmonic_bond":
                    assert (src_key, dst_key) in hb_bond_set
                key = (src_key, dst_key)
                if key not in bond_type_map:
                    bond_type_map[key] = len(bond_type_map)
                bonds.append((s, d))
                bond_classes.append(bond_type_map[key])

        residues[res_name] = {
            "atoms": [name_to_elem[t] for t in atom_types],
            "atom_names": atom_names,
            "atom_types": atom_types,
            "charges": [charge_of.get(t, 0.0) for t in atom_types],
            "nb_hashes": [nb_hash.get(t, "") for t in atom_types],
            "bonds": bonds,
            "bond_classes": bond_classes,
        }

    return residues


def main():
    parser = ArgumentParser(description="Convert Amber XML residue templates for env-BCC typing")
    parser.add_argument("input_path")
    parser.add_argument("--method", default="template_bond", choices=["harmonic_bond", "template_bond"])
    parser.add_argument("--all_residues", action="store_true")
    parser.add_argument("--output_path", default=None)
    args = parser.parse_args()

    residues = convert_amber_xml(args.input_path, args.method, standard_only=not args.all_residues)
    stream = open(args.output_path, "w") if args.output_path else None
    pprint.PrettyPrinter(width=300, indent=2, stream=stream).pprint(residues)
    if stream:
        stream.close()


if __name__ == "__main__":
    main()
