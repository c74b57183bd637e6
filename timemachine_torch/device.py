"""The port's default device: the CUDA card.

Entry points (Context, setup_dhfr_native, HostSystem.from_arrays, the potentials,
the barostat, SegmentSum) take `device=None` to mean the card. On a machine
without one, building a tensor there raises as torch raises; nothing falls
back to the CPU. Tests and host-side tools ask for the CPU by name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device("cuda") for None, else the device asked for."""
    return torch.device("cuda") if device is None else torch.device(device)


def working_dtype(device=None, dtype=None) -> torch.dtype:
    """`dtype` where given, else the working dtype of `device` (None: the
    card): float32 on the card, the kernels' type, as the JAX package runs
    on its accelerator; float64 elsewhere, as its CPU tests run."""
    if dtype is not None:
        return dtype
    return torch.float32 if resolve_device(device).type == "cuda" else torch.float64
