"""Compact ligand-environment interaction-group trajectories (counterpart
of timemachine_tpu/fe/interaction_group_traj.py): only the environment
atoms that enter the ligand's cutoff shell in some frame are kept, padded
to the widest frame's shell, so U_ig can be evaluated again cheaply over
sweeps of the nonbonded parameters (forcefield fitting).

The shell is found frame by frame on the host, and the kept atoms are
chosen with numpy's argpartition, as JAX's are, so `selected_env_idxs`
equals JAX's. `make_U_fxn` returns a function of an nb_params tensor whose
energies live on the tensor's device and are differentiable by autograd, as
JAX's are by jax.grad. JAX's has no Pallas kernel: plain PyTorch, the
(frame, ligand, shell) grid by broadcasting, is its counterpart.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from timemachine_torch.ops import nonbonded
from timemachine_torch.ops.pbc import distance_sq

Position = np.ndarray
PairFxn = Callable

_TRAJ_FIELDS = ("xs_lig", "xs_env", "box_diags", "cutoff", "selected_env_idxs", "ligand_idxs")


def nb_pair_fxn(x_a, x_b, param_a, param_b, box):
    """The example pair function: switched erfc electrostatics and LJ over
    the 4D distance (beta 2.0, cutoff 1.2 nm), zero beyond the cutoff;
    broadcasts over leading axes (params (..., 4), box (..., 3, 3))."""
    beta, cutoff = 2.0, 1.2
    dw = param_b[..., 3] - param_a[..., 3]
    r = torch.sqrt(distance_sq(x_a, x_b, box) + dw * dw)
    e_q = nonbonded.switched_direct_space_pme(r, param_a[..., 0] * param_b[..., 0], beta)
    e_lj = nonbonded.lennard_jones(
        r,
        nonbonded.combine_sigma(param_a[..., 1], param_b[..., 1]),
        nonbonded.combine_epsilon(param_a[..., 2], param_b[..., 2]),
    )
    return torch.where(r < cutoff, e_q + e_lj, 0.0)


def env_mask_within_cutoff(x_env, x_lig, box, cutoff):
    """(n_env,) bool: the minimum-image distance of x_env[i] to some ligand atom is below the cutoff."""
    d2 = distance_sq(x_env[:, None, :], x_lig[None, :, :], box)
    return torch.any(d2 < cutoff * cutoff, dim=1)


class InteractionGroupTraj:
    """Padded near-shell trajectory storage and its U_ig evaluator."""

    def __init__(self, xs, box_diags, ligand_idxs, env_idxs, cutoff=1.2, verbose=True):
        self.cutoff = cutoff
        self.ligand_idxs = np.asarray(ligand_idxs)
        env_idxs = np.asarray(env_idxs)

        xs = np.asarray(xs)
        self.n_frames = xs.shape[0]
        self.box_diags = np.asarray(box_diags)
        self.xs_lig = xs[:, self.ligand_idxs]
        xs_env_full = xs[:, env_idxs]

        if verbose:
            print(
                f"precomputing neighborlist on ({len(self.ligand_idxs)}, {len(env_idxs)}) "
                f"interaction group, at cutoff={cutoff}"
            )

        # frame by frame, so the distance block stays (n_env, n_lig)
        shell = np.stack(
            [
                env_mask_within_cutoff(
                    torch.as_tensor(xs_env_full[f]), torch.as_tensor(self.xs_lig[f]),
                    torch.as_tensor(np.diag(self.box_diags[f])), cutoff,
                ).numpy()
                for f in range(self.n_frames)
            ]
        )
        per_frame = shell.sum(axis=1)
        width = int(per_frame.max())  # every frame padded to the widest shell

        if verbose:
            kept = width + len(self.ligand_idxs)
            print(
                f"saving {(xs.shape[1] / kept):.2f}x on storage (relative to storing all env atoms); "
                f"padding to max_nbrs = {width} (~{width / per_frame.mean():.2f}x larger than unpadded)"
            )

        # per frame the `width` atoms of highest mask: every atom in the shell
        # and some outside it, whose energy the pair function's cutoff zeroes
        if width:
            take = np.argpartition(shell, len(env_idxs) - width, axis=1)[:, -width:]
        else:
            take = np.empty((self.n_frames, 0), dtype=np.int64)
        self.selected_env_idxs = env_idxs[take].astype(np.uint32)
        self.xs_env = np.take_along_axis(xs_env_full, take[:, :, None], axis=1)

    def to_dict(self):
        return {name: np.asarray(getattr(self, name)) for name in _TRAJ_FIELDS}

    @classmethod
    def from_dict(cls, archive):
        traj = cls.__new__(cls)
        for name in _TRAJ_FIELDS:
            setattr(traj, name, archive[name])
        traj.n_frames = len(traj.xs_env)
        return traj

    def to_npz(self, fname):
        np.savez_compressed(fname, **self.to_dict())

    @classmethod
    def from_npz(cls, fname):
        return cls.from_dict(np.load(fname, allow_pickle=False))

    def make_U_fxn(self, pair_fxn: PairFxn):
        """U(nb_params) -> (n_frames,) U_ig of every frame under the (N, 4)
        nb_params tensor, on its device and in its dtype, differentiable
        in nb_params. pair_fxn(x_a, x_b, param_a, param_b, box) must
        broadcast over leading axes, as nb_pair_fxn does."""
        lig_idxs = torch.as_tensor(np.asarray(self.ligand_idxs, dtype=np.int64))
        env_idxs = torch.as_tensor(np.asarray(self.selected_env_idxs, dtype=np.int64))
        cache = {}

        def on(device, dtype):
            key = (device, dtype)
            if key not in cache:
                boxes = torch.diag_embed(torch.as_tensor(np.asarray(self.box_diags), device=device, dtype=dtype))
                cache[key] = (
                    torch.as_tensor(np.asarray(self.xs_lig), device=device, dtype=dtype),
                    torch.as_tensor(np.asarray(self.xs_env), device=device, dtype=dtype),
                    boxes[:, None, None],  # (F, 1, 1, 3, 3) against the (F, L, E) grid
                    lig_idxs.to(device), env_idxs.to(device),
                )
            return cache[key]

        def compute_Us(nb_params):
            xs_lig, xs_env, boxes, lig, env = on(nb_params.device, nb_params.dtype)
            u = pair_fxn(xs_lig[:, :, None], xs_env[:, None], nb_params[lig][None, :, None], nb_params[env][:, None], boxes)
            Us = torch.sum(u, dim=(1, 2))
            assert Us.shape == (self.n_frames,)
            return Us

        return compute_Us
