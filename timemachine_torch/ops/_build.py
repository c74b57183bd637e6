"""Build the package's CUDA sources with nvcc at first use, load them with ctypes.

Each `csrc/<name>.cu` exports plain `extern "C"` launchers, so it compiles
in seconds without PyTorch's headers; `load_libraries` runs one nvcc per
source, all at once. The shared library goes to
`timemachine_torch/_build/` under a name keyed by a hash of the source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source is rebuilt
and an unchanged one is reused.
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
LIBRARIES = ("rowscan", "nb_tiles", "gather", "quadscan", "dotscan", "probe_fma", "probe_bf16")  # every source under csrc/
# no --use_fast_math: the sweeps rely on IEEE 0 * x = 0 for padding pairs
# and on IEEE expf, cosf and division in the exact electrostatics
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
    headers = b"".join(path.read_bytes() for path in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """The nvcc command and its output (register and spill report) of the
    last build of `name`."""
    return library_path(name).with_suffix(".log").read_text()


def _start_build(name: str):
    """Start nvcc on `csrc/<name>.cu` in the background: (Popen, command, tmp path)."""
    so = library_path(name)
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), cmd, tmp


def load_libraries(*names: str) -> list:
    """Compile every `csrc/<name>.cu` that has no current build for sm_90a,
    one nvcc each, all started together, then load them (once per process)."""
    missing = [name for name in dict.fromkeys(names) if name not in _libs and not library_path(name).exists()]
    jobs = {name: _start_build(name) for name in missing}
    failed = []
    for name, (proc, cmd, tmp) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}:\n{shlex.join(cmd)}\n{err}")
            continue
        so = library_path(name)
        so.with_suffix(".log").write_text(shlex.join(cmd) + "\n" + out + err)
        os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
    return [_libs[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` for sm_90a if no current build exists, then
    load it (once per process)."""
    return load_libraries(name)[0]
