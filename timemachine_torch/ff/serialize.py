"""Forcefield (de)serialization.

The port's copy of timemachine_tpu/ff/serialize.py.

Two formats:
* the reference-compatible python-literal dict format
  (ref ff/handlers/deserialize.py: `ast.literal_eval` of
  {Section: {"patterns": [(smirks, *params)], "props": ...}}), so users can
  load their existing timemachine forcefield files unchanged;
* JSON with the same section structure (this framework's shipped built-ins,
  timemachine_tpu/ff/params/*.json).
"""

from __future__ import annotations

import ast
import io
import json
import pprint
from pathlib import Path

from timemachine_torch import constants
from timemachine_torch.ff import handlers as handlers_mod
from timemachine_torch.ff.handlers import _SUFFIX

PROTEIN_FF_TAG = "ProteinForcefield"
WATER_FF_TAG = "WaterForcefield"


def _handlers_from_dict(obj_dict):
    protein_ff = obj_dict.pop(PROTEIN_FF_TAG, constants.DEFAULT_PROTEIN_FF)
    water_ff = obj_dict.pop(WATER_FF_TAG, constants.DEFAULT_WATER_FF)
    out = []
    for k, v in obj_dict.items():
        ctor = getattr(handlers_mod, k + _SUFFIX, None)
        if ctor is None:
            raise ValueError(f"Unknown handler: {k}")
        smirks, params = [], []
        for elems in v["patterns"]:
            smirks.append(elems[0])
            if len(elems) == 2:
                params.append(elems[1])
            else:
                params.append(list(elems[1:]))
        out.append(ctor(smirks, params, v.get("props")))
    return out, protein_ff, water_ff


def deserialize_handlers(text: str):
    """Accepts either the python-literal or JSON serialization."""
    stripped = text.lstrip()
    if stripped.startswith("{") and '"' in stripped[:200] and ":" in stripped:
        try:
            return _handlers_from_dict(json.loads(text))
        except json.JSONDecodeError:
            pass
    return _handlers_from_dict(ast.literal_eval(text))


def serialize_handlers(all_handlers, protein_ff, water_ff, fmt="python"):
    final = {PROTEIN_FF_TAG: protein_ff, WATER_FF_TAG: water_ff}
    for handler in all_handlers:
        if handler is None:
            continue
        obj = handler.serialize()
        for k in obj:
            assert k not in final, f"Handler {k} already exists"
        final.update(obj)
    if fmt == "json":
        return json.dumps(final, indent=1)
    buf = io.StringIO()
    pp = pprint.PrettyPrinter(width=500, compact=False, stream=buf)
    pp._sorted = lambda x: x
    pp.pprint(final)
    return buf.getvalue()


def builtin_params_dir() -> Path:
    """The shipped force fields, read as files from the JAX package's tree
    (timemachine_tpu/ff/params/*.json); no module of that package is
    imported."""
    return Path(__file__).resolve().parents[2] / "timemachine_tpu" / "ff" / "params"
