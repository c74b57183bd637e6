"""The barostat's moves under the names of timemachine_tpu/md/barostat/moves.py;
the classes live in md/barostat/__init__.py and md/moves.py."""

from timemachine_torch.md.barostat import CentroidRescaler, MonteCarloBarostat, scatter_idxs_from_group_idxs
from timemachine_torch.md.moves import NPTMove

__all__ = ["CentroidRescaler", "MonteCarloBarostat", "NPTMove", "scatter_idxs_from_group_idxs"]
