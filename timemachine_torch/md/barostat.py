"""Monte Carlo barostat with molecule-centroid rescaling
(counterpart of timemachine_tpu/md/barostat/__init__.py).

A move proposes dV ~ U(-s, s), scales every molecule's centroid about the
origin by (V'/V)^(1/3) (molecules move rigidly), and accepts unless
w = dU + P dV - N_mol kT ln(V'/V) > 0 and u > exp(-w / kT). With adaptive
scaling, s starts at 0.01 V and, per window of at least 10 attempts, shrinks
by 1.1 below 25% acceptance and grows by 1.1 (capped at 0.3 V) above 75%.
The decision is a torch.where on the device: a move never syncs the host.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np
import torch
from torch import nn

from timemachine_torch.constants import AVOGADRO, BOLTZ
from timemachine_torch.ops.segment import SegmentSum


def scatter_idxs_from_group_idxs(group_idxs, n_atoms: int):
    """(atom -> molecule id, molecule sizes); atoms in no group get their own
    singleton ids after the groups', in atom order."""
    scatter = np.full(n_atoms, -1, dtype=np.int64)
    for mol_id, grp in enumerate(group_idxs):
        scatter[np.asarray(grp)] = mol_id
    loose = np.nonzero(scatter < 0)[0]
    scatter[loose] = len(group_idxs) + np.arange(loose.size)
    return scatter, np.bincount(scatter).astype(np.float64)


class CentroidRescaler(nn.Module):
    """Scales molecule centroids about a center, displacing each molecule
    rigidly; atoms in no group stay put."""

    def __init__(self, group_idxs, n_atoms: int, device=None):
        super().__init__()
        scatter, sizes = scatter_idxs_from_group_idxs(group_idxs, n_atoms)
        grouped = np.zeros((n_atoms, 1), dtype=bool)
        for g in group_idxs:
            grouped[np.asarray(g)] = True
        self.register_buffer("scatter_idxs", torch.as_tensor(scatter, device=device))
        self.register_buffer("group_sizes", torch.as_tensor(sizes, device=device))
        self.register_buffer("grouped_mask", torch.as_tensor(grouped, device=device))
        self.segment_sum = SegmentSum(scatter, len(sizes), device=device)

    def compute_centroids(self, coords):
        return self.segment_sum(coords) / self.group_sizes.to(coords.dtype)[:, None]

    def scale_centroids(self, coords, center, scale):
        centroids = self.compute_centroids(coords)
        displacement = (center + scale * (centroids - center)) - centroids
        return coords + torch.where(self.grouped_mask, displacement[self.scatter_idxs], 0.0)


@dataclass
class BarostatState:
    volume_scale: torch.Tensor  # adaptive proposal width s (nm^3)
    n_accepted: torch.Tensor  # int32, this window
    n_attempted: torch.Tensor  # int32, this window
    total_accepted: torch.Tensor  # int32
    total_attempted: torch.Tensor  # int32
    generator: torch.Generator  # the move's two uniforms


@dataclass(eq=False)
class MonteCarloBarostat:
    # volume moves displace molecules rigidly: the Context may leave out
    # bond-graph-local terms from dU (they cancel exactly)
    rigid_group_move = True

    num_atoms: int
    pressure: float  # bar
    temperature: float  # K
    group_idxs: Sequence[np.ndarray]
    interval: int
    seed: int = 0
    adaptive_scaling_enabled: bool = True
    initial_volume_scale_factor: float = 0.0

    def init_state(self, device, dtype) -> BarostatState:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return BarostatState(
            torch.tensor(self.initial_volume_scale_factor, dtype=dtype, device=device), zero, zero, zero, zero, gen
        )

    def make_move_fn(self, energy_fn, device=None):
        """move(state, x, v, box) -> (state, x, v, box), drawing its two
        uniforms from state.generator. energy_fn(x, box) -> scalar U."""
        move_with = self.make_move_with_uniforms(energy_fn, device)

        def move(state, x, v, box):
            u = torch.rand(2, generator=state.generator, device=box.device, dtype=box.dtype)
            return move_with(state, x, v, box, u[0], u[1])

        return move

    def make_move_with_uniforms(self, energy_fn, device=None):
        """move(state, x, v, box, u_dv, u_acc): the move given its uniforms,
        u_dv for the volume proposal and u_acc for the Metropolis test."""
        rescaler = CentroidRescaler(self.group_idxs, self.num_atoms, device=device)
        num_mols = len(self.group_idxs)
        kt = BOLTZ * self.temperature
        pressure_kj_nm3 = self.pressure * AVOGADRO * 1e-25
        adaptive = self.adaptive_scaling_enabled

        def move(state: BarostatState, x, v, box, u_dv, u_acc):
            volume = box[0, 0] * box[1, 1] * box[2, 2]
            vs = state.volume_scale
            if adaptive:
                vs = torch.where(vs == 0.0, 0.01 * volume, vs)
            delta_volume = vs * 2.0 * (u_dv - 0.5)
            new_volume = volume + delta_volume
            length_scale = (new_volume / volume) ** (1.0 / 3.0)

            x_prop = rescaler.scale_centroids(x, x.new_zeros(3), length_scale.to(x.dtype))
            box_prop = box * length_scale.to(box.dtype)
            du = energy_fn(x_prop, box_prop) - energy_fn(x, box)
            du = torch.where(torch.isnan(du), torch.inf, du)
            w = du + pressure_kj_nm3 * delta_volume - num_mols * kt * torch.log(new_volume / volume)
            accepted = ~((w > 0) & (u_acc > torch.exp(-w / kt)))

            n_acc = state.n_accepted + accepted.to(torch.int32)
            n_att = state.n_attempted + 1
            if adaptive:
                due = n_att >= 10
                low = due & (n_acc < 0.25 * n_att)
                high = due & (n_acc > 0.75 * n_att)
                vs = torch.where(low, vs / 1.1, vs)
                vs = torch.where(high, torch.minimum(vs * 1.1, 0.3 * volume), vs)
                reset = low | high
                n_acc = torch.where(reset, 0, n_acc)
                n_att = torch.where(reset, 0, n_att)
            new_state = replace(
                state,
                volume_scale=vs,
                n_accepted=n_acc,
                n_attempted=n_att,
                total_accepted=state.total_accepted + accepted.to(torch.int32),
                total_attempted=state.total_attempted + 1,
            )
            return new_state, torch.where(accepted, x_prop, x), v, torch.where(accepted, box_prop, box)

        return move
