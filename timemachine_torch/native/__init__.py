"""Native C++ host components, built at first use with the system toolchain
(the port's counterpart of timemachine_tpu/native/__init__.py): the McGregor
MCS search of atom mapping (mcgregor.cpp, a copy of the JAX package's).

A library is compiled with `g++ -O3 -shared -fPIC` (or $CXX) into
`timemachine_torch/_build/` under a name keyed by a hash of its source and
flags, so an edited source is rebuilt and an unchanged one reused; plain C
ABI + ctypes, no PyTorch headers.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    pass


def build_library(name: str) -> Path:
    """Compile native/<name>.cpp into a shared library unless a current
    build exists; returns its path. Raises NativeBuildError, naming the
    compiler's error, where no working toolchain is available."""
    src = SRC_DIR / f"{name}.cpp"
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(src.read_bytes() + " ".join((cxx, *CXX_FLAGS)).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeBuildError(f"failed to build {src.name} with {cxx}: {detail}") from e
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a partial file
    return out
