"""SDF (MDL V2000) reader/writer.

The port's copy of timemachine_tpu/chem/sdf.py.

Replaces RDKit's SDMolSupplier/SDWriter for the framework's I/O needs:
multi-record files, coordinates, formal charges (M  CHG), and data fields
(`> <prop>`) — which the reference uses to cache partial charges on ligands
(ref ff/handlers/nonbonded.py:234-259) and to carry experimental ΔG labels in
the FEP benchmark sets.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Sequence, TextIO

import numpy as np

from timemachine_torch.chem.mol import Atom, Bond, Mol
from timemachine_torch.chem.periodic import ATOMIC_NUM, SYMBOLS


def _parse_counts_line(line: str) -> tuple[int, int]:
    n_atoms = int(line[0:3])
    n_bonds = int(line[3:6])
    return n_atoms, n_bonds


_CHARGE_CODE = {0: 0, 1: 3, 2: 2, 3: 1, 5: -1, 6: -2, 7: -3}  # old-style atom-block codes


def _parse_molblock(lines: list[str], name: str) -> Mol:
    n_atoms, n_bonds = _parse_counts_line(lines[3])
    atoms: list[Atom] = []
    coords = np.zeros((n_atoms, 3))
    for i in range(n_atoms):
        ln = lines[4 + i]
        x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
        symbol = ln[31:34].strip()
        coords[i] = (x, y, z)
        charge_code = int(ln[36:39]) if len(ln) >= 39 and ln[36:39].strip() else 0
        atoms.append(Atom(ATOMIC_NUM[symbol], _CHARGE_CODE.get(charge_code, 0)))
    bonds: list[Bond] = []
    for i in range(n_bonds):
        ln = lines[4 + n_atoms + i]
        src, dst, order = int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
        bonds.append(Bond(src, dst, order))
    # property block: M  CHG overrides atom-block charges
    for ln in lines[4 + n_atoms + n_bonds :]:
        if ln.startswith("M  CHG"):
            fields = ln.split()
            n = int(fields[2])
            for k in range(n):
                idx = int(fields[3 + 2 * k]) - 1
                chg = int(fields[4 + 2 * k])
                atoms[idx].formal_charge = chg
        elif ln.startswith("M  END"):
            break
    return Mol(atoms, bonds, coords, name=name)


def _iter_records(text: str) -> Iterator[tuple[list[str], dict]]:
    records = text.split("$$$$")
    for rec in records:
        body = rec.strip("\n")
        if not body.strip():
            continue
        lines = body.split("\n")
        # strip leading blank lines left from the separator
        while lines and not lines[0].strip() and len(lines) > 4:
            lines.pop(0)
        # find M  END
        end_idx = None
        for i, ln in enumerate(lines):
            if ln.startswith("M  END"):
                end_idx = i
                break
        if end_idx is None:
            continue
        mol_lines = lines[: end_idx + 1]
        props: dict = {}
        i = end_idx + 1
        while i < len(lines):
            ln = lines[i]
            if ln.startswith(">"):
                key = ln[ln.find("<") + 1 : ln.rfind(">")]
                vals = []
                i += 1
                while i < len(lines) and lines[i].strip() != "":
                    vals.append(lines[i])
                    i += 1
                props[key] = "\n".join(vals)
            i += 1
        yield mol_lines, props


def read_sdf_string(text: str) -> list[Mol]:
    mols = []
    for mol_lines, props in _iter_records(text):
        name = mol_lines[0].strip()
        mol = _parse_molblock(mol_lines, name)
        mol.props = props
        mols.append(mol)
    return mols


def read_sdf(path) -> list[Mol]:
    return read_sdf_string(Path(path).read_text())


def mol_to_molblock(mol: Mol) -> str:
    lines = [mol.name, "  timemachine_tpu", ""]
    lines.append(f"{mol.num_atoms:3d}{mol.num_bonds:3d}  0  0  0  0  0  0  0  0999 V2000")
    for i, a in enumerate(mol.atoms):
        x, y, z = mol.coords[i]
        lines.append(f"{x:10.4f}{y:10.4f}{z:10.4f} {SYMBOLS[a.atomic_num]:<3s} 0  0  0  0  0  0  0  0  0  0  0  0")
    for b in mol.bonds:
        lines.append(f"{b.src + 1:3d}{b.dst + 1:3d}{b.order:3d}  0")
    charged = [(i + 1, a.formal_charge) for i, a in enumerate(mol.atoms) if a.formal_charge != 0]
    for start in range(0, len(charged), 8):
        chunk = charged[start : start + 8]
        lines.append("M  CHG" + f"{len(chunk):3d}" + "".join(f"{i:4d}{c:4d}" for i, c in chunk))
    lines.append("M  END")
    return "\n".join(lines)


def write_sdf(mols: Sequence[Mol], path_or_file) -> None:
    out = []
    for mol in mols:
        out.append(mol_to_molblock(mol))
        for k, v in mol.props.items():
            out.append(f">  <{k}>")
            out.append(str(v))
            out.append("")
        out.append("$$$$")
    text = "\n".join(out) + "\n"
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
    else:
        Path(path_or_file).write_text(text)
