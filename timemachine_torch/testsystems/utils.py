"""The FreeSolv set (counterpart of timemachine_tpu/testsystems/utils.py),
read from the public data directory (testsystems/data.py)."""

from typing import Optional

from timemachine_torch.fe.utils import get_mol_name, read_sdf
from timemachine_torch.testsystems.data import path_to_data


def fetch_freesolv(n_mols: Optional[int] = None, exclude_mols: Optional[set] = None) -> list:
    """The FreeSolv molecules but those named in `exclude_mols`, the first n_mols of them."""
    skip = exclude_mols or set()
    kept = (m for m in read_sdf(path_to_data("freesolv", "freesolv.sdf")) if get_mol_name(m) not in skip)
    out = []
    for mol in kept:
        if n_mols is not None and len(out) >= n_mols:
            break
        out.append(mol)
    return out
