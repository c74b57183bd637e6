"""Convert SMIRNOFF (openforcefield) XML forcefields into this framework's
serialized FF dict format (the port's copy of
timemachine_tpu/ff/smirnoff_converter.py; an offline tool, numpy and
ElementTree only).

Capability target: reference `timemachine/ff/smirnoff_converter.py`. Instead
of that module's openmm.unit-backed AST evaluator and minidom walks, units
are reduced with a tiny `base [** exp] {*,/} ...` tokenizer over a static
MD-unit factor table (kJ/mol, nm, radian, e, ps) and tags are pulled with
ElementTree through a declarative per-term extraction spec.

Usage:
    python -m timemachine_torch.ff.smirnoff_converter input.offxml \
        --charge_type CCC --output_path my_ff.py
"""

from __future__ import annotations

import json
import pprint
import re
import xml.etree.ElementTree as ET
from argparse import ArgumentParser
from typing import Any

import numpy as np

# conversion factors into the MD unit system
_UNIT_FACTORS = {
    "kilocalorie_per_mole": 4.184,
    "kilocalories_per_mole": 4.184,
    "kilocalorie": 4.184,
    "kilocalories": 4.184,
    "kilojoule_per_mole": 1.0,
    "kilojoules_per_mole": 1.0,
    "kilojoule": 1.0,
    "kilojoules": 1.0,
    "angstrom": 0.1,
    "angstroms": 0.1,
    "nanometer": 1.0,
    "nanometers": 1.0,
    "picosecond": 1.0,
    "picoseconds": 1.0,
    "degree": np.pi / 180.0,
    "degrees": np.pi / 180.0,
    "radian": 1.0,
    "radians": 1.0,
    "elementary_charge": 1.0,
    "mole": 1.0,
}

_TOKEN = re.compile(r"(\*\*|[*/])")


def string_to_unit(unit_string: str) -> float:
    """Reduce a unit expression like 'kilocalories_per_mole / angstrom ** 2'
    to one MD-unit conversion factor."""
    tokens = [t.strip() for t in _TOKEN.split(unit_string) if t.strip()]
    value = 1.0
    mode = "*"
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok in ("*", "/"):
            mode = tok
            i += 1
            continue
        base = _UNIT_FACTORS[tok] if tok in _UNIT_FACTORS else float(tok)
        if i + 1 < len(tokens) and tokens[i + 1] == "**":
            base **= float(tokens[i + 2])
            i += 2
        value = value * base if mode == "*" else value / base
        i += 1
    return value


def parse_quantity(number_string: str) -> float:
    """'<number> * <unit expr>' (or a bare number) -> value in MD units."""
    head, sep, tail = number_string.partition("*")
    if not sep:
        return float(number_string)
    return float(head) * string_to_unit(tail)


def _torsion_components(attrib: dict) -> list:
    """All (k_i/idivf_i, phase_i, period_i) rows a Proper node carries."""
    rows = []
    for n in range(1, 100):
        if f"k{n}" not in attrib:
            break
        rows.append(
            [
                parse_quantity(attrib[f"k{n}"]) / float(attrib[f"idivf{n}"]),
                parse_quantity(attrib[f"phase{n}"]),
                float(attrib[f"periodicity{n}"]),
            ]
        )
    return rows


def _lj_row(attrib: dict) -> list:
    eps = parse_quantity(attrib["epsilon"])
    if "rmin_half" in attrib:
        sigma = 2.0 * parse_quantity(attrib["rmin_half"]) / 2.0 ** (1.0 / 6.0)
    else:
        sigma = parse_quantity(attrib["sigma"])
    # sqrt(eps) stored to keep the Lorentz-Berthelot combining rule
    # singularity-free under differentiation
    return [sigma, float(np.sqrt(eps))]


# handler name -> (xml tag, attrib -> param row)
_TERM_SPECS = {
    "HarmonicBond": ("Bond", lambda a: [parse_quantity(a["k"]), parse_quantity(a["length"])]),
    "HarmonicAngle": ("Angle", lambda a: [parse_quantity(a["k"]), parse_quantity(a["angle"])]),
    "ProperTorsion": ("Proper", _torsion_components),
    # trefoil convention: improper k is split over the 3 central permutations
    "ImproperTorsion": (
        "Improper",
        lambda a: [
            parse_quantity(a["k1"]) / 3.0,
            parse_quantity(a["phase1"]),
            float(a["periodicity1"]),
        ],
    ),
    "LennardJones": ("Atom", _lj_row),
}


def _builtin_charge_table(kind: str) -> dict:
    """Charge handler block from the builtin converted forcefields (the
    reference embeds these tables in ff/charges.py)."""
    from timemachine_torch.ff.serialize import builtin_params_dir

    fname, key = {
        "CCC": ("smirnoff_2_0_0_ccc.json", "AM1CCC"),
        "BCC": ("smirnoff_2_0_0_am1bcc.json", "AM1BCC"),
        "SC": ("smirnoff_1_1_0_sc.json", "SimpleCharge"),
    }[kind]
    with open(builtin_params_dir() / fname) as fh:
        return {key: json.load(fh)[key]}


def convert_smirnoff_xml(xml_path: str, charge_type: str = "CCC") -> dict:
    """SMIRNOFF XML file -> FF dict with per-handler SMIRKS pattern tables."""
    root = ET.parse(xml_path).getroot()
    forcefield: dict[str, Any] = {}

    for handler_name, (tag, extract) in _TERM_SPECS.items():
        patterns = [[node.attrib["smirks"], *_as_row(extract(node.attrib))] for node in root.iter(tag)]
        forcefield[handler_name] = {"patterns": patterns}

    # vdW block properties (scale factors, combining rule, ...)
    vdw_node = next(root.iter("vdW"), None)
    if vdw_node is not None:
        props = {
            key: (float(val) if "scale" in key else val)
            for key, val in vdw_node.attrib.items()
            if key not in ("cutoff", "switch_width", "version")
        }
        forcefield["LennardJones"]["props"] = props
    else:
        forcefield["LennardJones"]["props"] = {}

    forcefield.update(_builtin_charge_table(charge_type))
    return forcefield


def _as_row(extracted):
    """ProperTorsion extracts a LIST of component rows (kept nested); all
    other handlers extract one flat row."""
    if extracted and isinstance(extracted[0], list):
        return [extracted]
    return extracted


def main():
    parser = ArgumentParser(description="Convert an openforcefield XML FF to a timemachine_torch FF")
    parser.add_argument("input_path", help="Path to XML ff")
    parser.add_argument("--charge_type", default="SC", choices=["SC", "CCC", "BCC"])
    parser.add_argument("--output_path", help="Path to write FF file", default=None)
    args = parser.parse_args()

    forcefield = convert_smirnoff_xml(args.input_path, args.charge_type)
    stream = open(args.output_path, "w") if args.output_path is not None else None
    pprint.PrettyPrinter(width=500, compact=False, stream=stream, indent=2).pprint(forcefield)
    if stream is not None:
        stream.close()


if __name__ == "__main__":
    main()
