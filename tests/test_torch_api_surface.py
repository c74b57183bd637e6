"""Every module of timemachine_tpu has a counterpart at the same path in
timemachine_torch, holding each of its public module-level names.

Both packages are read by AST, so nothing is imported (no JAX). A JAX
module's public names are its module-level def, class and assignment
targets not starting with "_", and the entries of its __all__. The port's
module is the file at the same path, or the package whose __init__.py
stands there; its names are the same kinds plus what it imports. The
exceptions are the allowlists below, each with its reason.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "timemachine_tpu", ROOT / "timemachine_torch"

KERNEL_MODULE = "ROADMAP queue 2: a TPU kernel module, ported as a csrc/*.cu kernel and its ops/*_kernel.py wrapper"

# JAX modules with no counterpart file
MODULES_LEFT_OUT = {
    "ff/openmm_deserializer.py": "needs OpenMM, which neither machine has (ROADMAP P36)",
    "ops/pallas/__init__.py": KERNEL_MODULE,
    "ops/pallas/dotscan_kernel.py": KERNEL_MODULE,
    "ops/pallas/gather_kernel.py": KERNEL_MODULE,
    "ops/pallas/nonbonded_kernel.py": KERNEL_MODULE,
    "ops/pallas/quadscan_kernel.py": KERNEL_MODULE,
    "ops/pallas/rowscan_kernel.py": KERNEL_MODULE,
}

# public names of ported modules that the port does not hold
NAMES_LEFT_OUT = {
    "md/fire.py": {"fire_minimize_jax": "a name that says JAX; the port's fire_minimize is its function"},
    "ff/handlers.py": {
        "native_am1_enabled": "the TM_NATIVE_AM1 environment switch, which the port does not copy (ROADMAP §3)"
    },
    "parallel/client.py": {"TPUPoolClient": "names a platform the port does not run"},
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _public_names(tree: ast.Module, with_imports: bool) -> set:
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                elts = target.elts if isinstance(target, ast.Tuple) else [target]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                names.update(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _port_path(rel: str) -> Path:
    p = PORT_PKG / rel
    if p.exists():
        return p
    return PORT_PKG / rel[: -len(".py")] / "__init__.py"


def test_the_allowlists_name_only_what_exists():
    modules = set(_jax_modules())
    assert set(MODULES_LEFT_OUT) <= modules
    for rel, names in NAMES_LEFT_OUT.items():
        assert rel in modules
        jax_names = _public_names(ast.parse((JAX_PKG / rel).read_text()), with_imports=False)
        assert set(names) <= jax_names, rel
        assert not set(names) & _public_names(ast.parse(_port_path(rel).read_text()), with_imports=True), rel
    for rel in MODULES_LEFT_OUT:
        assert not _port_path(rel).exists(), rel


@pytest.mark.parametrize("rel", [m for m in _jax_modules() if m not in MODULES_LEFT_OUT])
def test_every_public_name_has_a_counterpart(rel):
    port = _port_path(rel)
    assert port.exists(), f"no counterpart of timemachine_tpu/{rel}"
    jax_names = _public_names(ast.parse((JAX_PKG / rel).read_text()), with_imports=False)
    port_names = _public_names(ast.parse(port.read_text()), with_imports=True)
    missing = jax_names - port_names - set(NAMES_LEFT_OUT.get(rel, {}))
    assert not missing, f"timemachine_torch/{rel} lacks {sorted(missing)}"
