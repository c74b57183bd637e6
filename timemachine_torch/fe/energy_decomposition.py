"""Per-component reduced energies of trajectories (the port of
timemachine_tpu/fe/energy_decomposition.py), the u_kln of the bisection.

Each component is one potential module (the first state's, on its device)
called frame by frame at another state's parameters, as
free_energy.generate_pair_bar_ulkns calls it; JAX maps a jitted energy over
chunks of frames. A frame with a non-finite coordinate or box gives NaN,
which the BAR estimate takes as +inf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, TypeVar

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ, DEFAULT_TEMP

Frames = TypeVar("Frames")


@dataclass
class EnergyDecomposedState:
    """Samples (frames, boxes) and per-component reduced energy functions."""

    frames: Sequence
    boxes: Sequence
    batch_u_fns: Sequence[Callable]


def make_batch_u_fn(potential, params, kBT: float) -> Callable:
    """(frames, boxes) -> (n_frames,) float64 reduced energies of `potential`
    (a module) at `params`, one call a frame on the module's device; NaN for
    a frame whose coordinates or box are not finite."""

    def batch_u_fn(xs, boxes):
        xs, boxes = np.asarray(xs), np.asarray(boxes)
        dev, dt = potential.params.device, potential.params.dtype
        good = np.isfinite(xs).all(axis=(1, 2)) & np.isfinite(boxes).reshape(len(boxes), -1).all(axis=1)
        out = np.full(len(xs), np.nan)
        with torch.no_grad():
            us = [
                potential.u(torch.as_tensor(x, device=dev, dtype=dt), params, torch.as_tensor(b, device=dev, dtype=dt))
                for x, b in zip(xs[good], boxes[good])
            ]
        if us:
            out[good] = torch.stack(us).cpu().numpy().astype(np.float64)
        return out / kBT

    return batch_u_fn


def get_batch_u_fns(pots, params, temperature: float = DEFAULT_TEMP) -> list:
    """(ref energy_decomposition.py:28-69)"""
    kBT = temperature * BOLTZ
    assert len(pots) == len(params)
    return [make_batch_u_fn(pot, p, kBT) for pot, p in zip(pots, params)]


def compute_energy_decomposed_u_kln(states: list) -> np.ndarray:
    """u_kln_by_component[comp, k, l, n]: sample n of state k under state l's
    energy (ref energy_decomposition.py:72-108)."""
    k_states = len(states)
    n_frames = len(states[0].frames)
    n_components = len(states[0].batch_u_fns)
    for state in states:
        assert len(state.frames) == n_frames
        assert len(state.batch_u_fns) == n_components

    u_kln = np.zeros((n_components, k_states, k_states, n_frames))
    for k in range(k_states):
        xs, boxes = np.array(states[k].frames), states[k].boxes
        for l in range(k_states):
            for comp in range(n_components):
                u_kln[comp, k, l] = states[l].batch_u_fns[comp](xs, boxes)
    return u_kln
