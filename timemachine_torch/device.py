"""The port's default device: the CUDA card.

Entry points (Context, setup_dhfr, HostSystem.from_arrays, the potentials,
the barostat, SegmentSum) take `device=None` to mean the card. On a machine
without one, building a tensor there raises as torch raises; nothing falls
back to the CPU. Tests and host-side tools ask for the CPU by name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device("cuda") for None, else the device asked for."""
    return torch.device("cuda") if device is None else torch.device(device)
