"""How far the host's BLAS moves the AM1 charges of the solvent leg's
ligands, and with them the windows that build_rbfe_solvent builds
(chip_smoke.py phase 15, tests/test_torch_rbfe_build.py).

The AM1 SCF (qm/scf.py) stops at the first iterate with |dE| < 1e-7 and
|[F, P]| < 1e-5, so which iterate that is, and the charges' last digits,
follow the rounding of numpy's LAPACK (eigh, solve) and matmul: the
OpenBLAS build and the kernels it picks for the CPU. This probe prints the
OpenBLAS kernels and builds that numpy and scipy took, builds the 12
windows on the CPU and holds them against the committed cache with
`rbfe_solvent.build_differences` (the charge columns both relative to the
column's largest |value| and in e), and prints for each ligand how far its
stopped charges lie from the same SCF run on to |dE| < 1e-12. With
--coretypes it does the same in a fresh process under each OpenBLAS kernel
family named (OPENBLAS_CORETYPE), so that one host shows what another
host's kernels do, and adds how far that process's stopped and converged
charges lie from the first process's; a family the CPU cannot run is
reported with the kernels OpenBLAS took instead, or with the process's
exit code.

Usage, from the repository root:
    python -m timemachine_torch.probes.am1_host [--coretypes Haswell,Zen,...] [--out PATH]
Prints one JSON object per process, the host's own first, without the
charges themselves, which --out keeps; the readings are printed, not
checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TIGHT_TOL = 1e-12  # the SCF's |dE| stop for the converged charges (qm/scf.py stops at 1e-7)
# numpy's OpenBLAS (64-bit integers) names them with the suffix 64_, scipy's without
CORENAME_SYMBOLS = ("scipy_openblas_get_corename64_", "scipy_openblas_get_corename")
CONFIG_SYMBOLS = ("scipy_openblas_get_config64_", "scipy_openblas_get_config")


def _call_str(so, symbols):
    for sym in symbols:
        if hasattr(so, sym):
            fn = getattr(so, sym)
            fn.restype = ctypes.c_char_p
            return fn().decode().strip()
    return "unknown"


def blas_kernels() -> dict:
    """{library file name: "kernel family; build"} for every OpenBLAS that
    this process has loaded (numpy's and, once imported, scipy's): the
    kernels OpenBLAS took on this CPU and its version and build options."""
    import scipy.linalg  # noqa: F401  (loads scipy's OpenBLAS)

    with open("/proc/self/maps") as f:
        libs = sorted({line.split()[-1] for line in f if "openblas" in line.lower() and line.rstrip().endswith(".so")})
    out = {}
    for lib in libs:
        so = ctypes.CDLL(lib)
        out[Path(lib).name] = f"{_call_str(so, CORENAME_SYMBOLS)}; {_call_str(so, CONFIG_SYMBOLS)}"
    return out


def scf_stop_errors(mols) -> dict:
    """{ligand: {"iterations": at the default stop and at TIGHT_TOL,
    "stop_vs_tight_e": max |q - q_tight| in e, "q", "q_tight": the
    charges}}: how far the stopped charges lie from converged ones."""
    from timemachine_torch.qm.scf import am1

    out = {}
    for mol in mols:
        args = (list(mol.atomic_nums), np.asarray(mol.get_conf(), dtype=np.float64) * 10.0, int(mol.total_charge()))
        stop, tight = am1(*args), am1(*args, tol=TIGHT_TOL)
        out[mol.name] = dict(
            iterations=[stop.n_iterations, tight.n_iterations],
            stop_vs_tight_e=float(np.abs(stop.charges - tight.charges).max()),
            q=stop.charges.tolist(), q_tight=tight.charges.tolist(),
        )
    return out


def across_processes(res: dict, first: dict) -> dict:
    """{ligand: (max |q - first's q|, max |q_tight - first's q_tight|) in e}."""
    return {
        name: [float(np.abs(np.subtract(d[k], first["scf"][name][k])).max()) for k in ("q", "q_tight")]
        for name, d in res["scf"].items()
    }


def probe() -> dict:
    import torch

    from timemachine_torch.testsystems import rbfe_solvent

    torch.set_num_threads(1)
    rec = {}
    t0 = time.perf_counter()
    states = rbfe_solvent.build_rbfe_solvent(device="cpu", record=rec)
    seconds = time.perf_counter() - t0
    diff = rbfe_solvent.build_differences(states, rbfe_solvent.load_rbfe_solvent(device="cpu"))
    st = rec["single_topology"]
    return dict(
        coretype=os.environ.get("OPENBLAS_CORETYPE", ""), numpy=np.__version__, blas=blas_kernels(),
        build_seconds=seconds, **diff, scf=scf_stop_errors((st.mol_a, st.mol_b)),
    )


def _brief(res: dict) -> str:
    scf = {name: {k: v for k, v in d.items() if k not in ("q", "q_tight")} for name, d in res.get("scf", {}).items()}
    return json.dumps({**res, "scf": scf} if scf else res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coretypes", default="", help="comma-separated OPENBLAS_CORETYPE values, each in a fresh process")
    ap.add_argument("--out", default=None, help="also write every object, as a JSON list, to this file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(probe()))  # the parent reads the charges from it
        return 0
    results = [probe()]
    print(_brief(results[0]), flush=True)
    for core in filter(None, args.coretypes.split(",")):
        env = {**os.environ, "OPENBLAS_CORETYPE": core}
        p = subprocess.run([sys.executable, "-m", "timemachine_torch.probes.am1_host", "--child"], env=env, capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode == 0 and lines:
            res = json.loads(lines[-1])
            res["vs_first_e"] = across_processes(res, results[0])
        else:
            res = dict(coretype=core, returncode=p.returncode, stderr=p.stderr[-400:])
        results.append(res)
        print(_brief(res), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
