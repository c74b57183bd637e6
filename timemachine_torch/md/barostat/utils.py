"""The barostat's helpers under the names of timemachine_tpu/md/barostat/utils.py;
the functions live in md/utils.py."""

from timemachine_torch.md.utils import compute_box_center, compute_box_volume, get_bond_list, get_group_indices

__all__ = ["compute_box_center", "compute_box_volume", "get_bond_list", "get_group_indices"]
