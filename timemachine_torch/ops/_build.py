"""Build the package's CUDA sources with nvcc at first use, load them with ctypes.

Each `csrc/<name>.cu` exports plain `extern "C"` launchers, so it compiles
in seconds without PyTorch's headers. The shared library goes to
`timemachine_torch/_build/` under a name keyed by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# no --use_fast_math: the sweep relies on IEEE 0 * x = 0 for padding pairs
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict = {}


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """The nvcc command and its output (register and spill report) of the
    last build of `name`."""
    return library_path(name).with_suffix(".log").read_text()


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` for sm_90a if no current build exists, then
    load it (once per process)."""
    if name in _libs:
        return _libs[name]
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{shlex.join(cmd)}\n{proc.stderr}")
        so.with_suffix(".log").write_text(shlex.join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    _libs[name] = ctypes.CDLL(str(so))
    return _libs[name]
