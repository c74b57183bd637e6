"""Diff two serialized force fields section by section (counterpart of
timemachine_tpu/ff/compare_forcefields.py).

Reads either serialization: python-literal .py files or .json files; a
built-in force field's name resolves to the shipped file, as
Forcefield.load_from_file resolves it. Run:
python -m timemachine_torch.ff.compare_forcefields REFERENCE_FF COMP_FF
(exit 0 identical, 2 different, 1 not found).
"""

import ast
import json
import os
import sys
from argparse import ArgumentParser
from pathlib import Path

from timemachine_torch.ff.serialize import builtin_params_dir


def _load(path: str) -> dict:
    p = Path(path)
    if not p.exists():
        # a built-in force field's name, as Forcefield.load_from_file resolves it
        builtin = builtin_params_dir() / (p.name if p.suffix else p.name + ".json")
        if builtin.exists():
            p = builtin
    text = p.read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return ast.literal_eval(text)


def compare_forcefields(ref_ff: dict, comp_ff: dict, out=print) -> bool:
    """Print differences; returns True when the forcefields are identical."""
    same = True
    ref_keys = set(ref_ff.keys())
    comp_keys = set(comp_ff.keys())
    diff_keys = ref_keys.difference(comp_keys)
    if diff_keys:
        out(f"The top level sections differ, the following keys {diff_keys}")
        same = False
    for key in sorted(ref_keys - diff_keys):
        ref_sec = ref_ff[key]
        if not isinstance(ref_sec, dict):
            if ref_sec != comp_ff.get(key):
                out(f"Difference in {key} value: Reference value {ref_sec} New Value {comp_ff.get(key)}")
                same = False
            continue
        for subkey, ref_val in ref_sec.items():
            if subkey not in comp_ff[key]:
                out(f"Section {key} has no {subkey} section in comparison")
                same = False
                continue
            comp_val = comp_ff[key][subkey]
            if isinstance(ref_val, dict):
                for dict_key, val in ref_val.items():
                    cv = comp_val.get(dict_key)
                    if val != cv:
                        out(f"Difference in {subkey} value for {dict_key}: Reference value {val} New Value {cv}")
                        same = False
            elif isinstance(ref_val, (list, tuple)):
                comp_by_smirks = {p[0]: p for p in comp_val}
                for pattern in ref_val:
                    smirks, params = pattern[0], list(pattern[1:])
                    comp_pattern = comp_by_smirks.get(smirks)
                    if comp_pattern is None:
                        out(f"Comp FF has no pattern {smirks}")
                        same = False
                        continue
                    if len(pattern) != len(comp_pattern) or any(
                        rv != cv for rv, cv in zip(pattern, comp_pattern)
                    ):
                        out(f"{key} pattern {smirks} differs:")
                        out(f"Reference  {params}")
                        out(f"Comparison {list(comp_pattern[1:])}")
                        same = False
            else:
                if ref_val != comp_val:
                    out(f"Difference in {subkey} value: Reference value {ref_val} New Value {comp_val}")
                    same = False
    return same


def main():
    parser = ArgumentParser(description="Compare serialized forcefields")
    parser.add_argument("reference_ff")
    parser.add_argument("comp_ff")
    args = parser.parse_args()
    ref_path = os.path.expanduser(args.reference_ff)
    comp_path = os.path.expanduser(args.comp_ff)
    try:
        ref_ff, comp_ff = _load(ref_path), _load(comp_path)
    except FileNotFoundError as e:
        print("No such forcefield path or built-in name:", e.filename)
        sys.exit(1)
    same = compare_forcefields(ref_ff, comp_ff)
    print("identical" if same else "forcefields differ")
    sys.exit(0 if same else 2)


if __name__ == "__main__":
    main()
