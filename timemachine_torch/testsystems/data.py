"""Locate the public benchmark data files (counterpart of
timemachine_tpu/testsystems/data.py): hif2a's ligands_40.sdf, FreeSolv's
freesolv.sdf and the DHFR PDB, which the repository does not ship.

The directory is TIMEMACHINE_TORCH_DATA, else TIMEMACHINE_TPU_DATA (the JAX
package's variable, so both packages read one directory); the JAX package
also looks in a fixed reference checkout, which the port does not name.
Without one, FileNotFoundError, as JAX's raises.
"""

import os
from pathlib import Path


def _candidates() -> list:
    return [os.environ.get("TIMEMACHINE_TORCH_DATA"), os.environ.get("TIMEMACHINE_TPU_DATA")]


def data_dir() -> Path:
    for c in _candidates():
        if c and Path(c).exists():
            return Path(c)
    raise FileNotFoundError(
        "benchmark data directory not found; set TIMEMACHINE_TORCH_DATA to a checkout of the public test data"
    )


def path_to_data(*parts) -> Path:
    p = data_dir().joinpath(*parts)
    if not p.exists():
        raise FileNotFoundError(str(p))
    return p
