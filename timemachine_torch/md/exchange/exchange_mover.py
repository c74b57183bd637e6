"""Water exchange Monte Carlo: the biased deletion (BD) and targeted
insertion biased deletion (TIBD) prototypes and the weight math they share
with the Context mover (counterpart of
timemachine_tpu/md/exchange/exchange_mover.py).

A water's log weight is beta U_i, U_i its interaction energy with every
other atom under the sampler's nonbonded parameters: deletion is biased
toward waters that interact weakly (w_i = exp(+beta U_i)). The acceptance
ratio reads the normalizing sums before and after a move; after a move
they are updated from one (3, N) interaction block of the moved water at
its old and at its new place, not rebuilt (the "transposition trick").

`WaterWeights` holds that math over a leading replica axis: the full (W,)
rebuild in chunks of waters, and the incremental update, whose per-water
sums gather each water's three atom columns and add them in a fixed
order, so that a run is the same bits on any device (no atomics). The
prototypes draw every proposal from numpy's default_rng(seed) in the JAX
package's order, so from one seed they propose what JAX's propose; their
Metropolis uniform comes from the numpy Generator given as `rng`
(md/moves.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.special import logsumexp

from timemachine_torch.constants import BOLTZ
from timemachine_torch.device import resolve_device, working_dtype
from timemachine_torch.md import moves
from timemachine_torch.md.states import CoordsVelBox
from timemachine_torch.ops.nonbonded import nonbonded_block_unsummed


def get_water_idxs(mol_groups: list, ligand_idxs=None) -> list:
    """The molecule groups of three atoms, less a group that is the
    ligand's atoms exactly (a three-atom ligand)."""
    water_groups = [g for g in mol_groups if len(g) == 3]
    if ligand_idxs is not None and len(ligand_idxs) == 3:
        ligand_atom_set = set(np.asarray(ligand_idxs).tolist())
        water_groups = [g for g in water_groups if set(np.asarray(g).tolist()) != ligand_atom_set]
    return water_groups


def random_rotation_matrix(rng: np.random.Generator) -> np.ndarray:
    """A Haar-uniform rotation from a normalized Gaussian quaternion."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return quaternion_to_rotation(q)


def quaternion_to_rotation(q):
    """The rotation matrix (..., 3, 3) of unit quaternions q (..., 4) =
    (w, x, y, z); numpy or torch."""
    w, x, y, z = (q[..., i] for i in range(4))
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    if isinstance(q, torch.Tensor):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)
    return np.stack([np.stack(r, -1) for r in rows], -2)


def randomly_rotate_and_translate(coords, new_loc, rng: Optional[np.random.Generator] = None):
    """coords rotated at random about their centroid, which goes to new_loc."""
    rng = rng or np.random.default_rng()
    centroid = np.mean(coords, axis=0, keepdims=True)
    centered = coords - centroid
    rot = random_rotation_matrix(rng)
    return centered @ rot.T + new_loc


def translate_coordinates(coords, new_loc):
    centroid = np.mean(coords, axis=0, keepdims=True)
    return coords - centroid + new_loc


# -- the weight math shared by the prototypes and the Context mover -------------------------------


class WaterWeights:
    """Log weights beta U_i of the waters water_idxs (W, 3), over a leading
    replica axis K: params (K, N, 4), x (K, N, 3), box (K, 3, 3). Each
    water's interactions with its own atoms are left out; a NaN pair
    energy (coincident atoms) counts as +inf. Holds its index tensors on
    `device` (None: the card)."""

    def __init__(self, water_idxs, nb_beta: float, nb_cutoff: float, kT: float, n_atoms: int, weight_chunk: int = 128,
                 device=None):
        device = resolve_device(device)
        water_idxs = np.asarray(water_idxs, dtype=np.int64).reshape(-1, 3)
        self.num_waters = water_idxs.shape[0]
        self.beta, self.cutoff, self.beta_T, self.chunk = float(nb_beta), float(nb_cutoff), 1.0 / kT, weight_chunk
        atom_to_water = np.full(n_atoms, self.num_waters, dtype=np.int64)  # non-water atoms: W
        atom_to_water[water_idxs.ravel()] = np.repeat(np.arange(self.num_waters), 3)
        self.water_idxs = torch.as_tensor(water_idxs, device=device)
        self.atom_to_water = torch.as_tensor(atom_to_water, device=device)

    def _rows_block(self, rows, rows_x, rows_p, x, params, box):
        """(K, R, N) energies of the water atoms `rows` (K, R) placed at rows_x
        (K, R, 3) with every atom, each water's own columns 0, NaN -> +inf."""
        u = nonbonded_block_unsummed(rows_x, x, box, rows_p, params, self.beta, self.cutoff)
        u = torch.where(torch.isnan(u), torch.inf, u)
        own = self.atom_to_water[rows][..., None] == self.atom_to_water
        return torch.where(own, 0.0, u)

    def full(self, params, x, box):
        """(K, W) log weights, one chunk of waters at a time ((K, 3 chunk, N) temporaries)."""
        sums = []
        for c0 in range(0, self.num_waters, self.chunk):
            rows = self.water_idxs[c0 : c0 + self.chunk].reshape(-1).expand(x.shape[0], -1)
            u = self._rows_block(rows, _take_rows(x, rows), _take_rows(params, rows), x, params, box)
            sums.append(torch.sum(u.reshape(x.shape[0], -1, 3 * x.shape[1]), dim=-1))
        return self.beta_T * torch.cat(sums, dim=-1)

    def per_water(self, atom_nrg):
        """(K, W) sums of (K, N) per-atom energies over each water's three atoms, in atom order."""
        return torch.sum(atom_nrg[:, self.water_idxs], dim=-1)

    def moved(self, params, x, box, chosen, new_pos, weights):
        """(K, W) log weights after water chosen (K,) of each replica moves
        to new_pos (K, 3, 3): weights + beta (U_new - U_old) of every
        other water, and the moved water's own sum at its new place."""
        a_idxs = self.water_idxs[chosen]  # (K, 3)
        rows = torch.cat([a_idxs, a_idxs], dim=1)
        rows_x = torch.cat([_take_rows(x, a_idxs), new_pos], dim=1)
        u = self._rows_block(rows, rows_x, _take_rows(params, rows), x, params, box)  # (K, 6, N): old, new
        old_atom, new_atom = torch.sum(u[:, :3], dim=1), torch.sum(u[:, 3:], dim=1)
        after = weights + self.beta_T * (self.per_water(new_atom) - self.per_water(old_atom))
        return after.scatter(1, chosen[:, None], self.beta_T * torch.sum(new_atom, dim=-1, keepdim=True))

    def place(self, x, chosen, new_pos):
        """x with water chosen (K,) of each replica at new_pos (K, 3, 3)."""
        return x.scatter(1, self.water_idxs[chosen][..., None].expand(-1, -1, 3), new_pos)


def _take_rows(a, rows):
    """a (K, N, C) at rows (K, R): (K, R, C)."""
    return torch.take_along_dim(a, rows[..., None], dim=1)


def make_weight_fns_paramized(water_idxs, nb_beta, nb_cutoff, kT, n_atoms, weight_chunk: int = 128, device=None):
    """(batch_log_weights(nb_params, conf, box) -> (W,),
    batch_log_weights_incremental(nb_params, conf, box, water_idx, new_pos,
    initial_weights) -> (final_weights, new_conf)) of one system, the
    nonbonded parameters an argument of each call (JAX's function of this
    name); tensors on `device` (None: the card)."""
    ww = WaterWeights(water_idxs, nb_beta, nb_cutoff, kT, n_atoms, weight_chunk, device)
    dev = ww.water_idxs.device

    def batch_log_weights(nb_params, conf, box):
        p, x, b = _as_batch(nb_params, conf, box, device=dev)
        return ww.full(p, x, b)[0]

    def batch_log_weights_incremental(nb_params, conf, box, water_idx, new_pos, initial_weights):
        p, x, b, pos, w = _as_batch(nb_params, conf, box, new_pos, initial_weights, device=dev)
        chosen = torch.as_tensor(water_idx, device=dev).reshape(1)
        return ww.moved(p, x, b, chosen, pos, w)[0], ww.place(x, chosen, pos)[0]

    return batch_log_weights, batch_log_weights_incremental


def _as_batch(params, *arrays, device):
    """The arrays as tensors of params' dtype on device, each with a replica axis of 1."""
    params = _tensor(params, device)
    return [params[None]] + [_tensor(a, device, params.dtype)[None] for a in arrays]


def _tensor(a, device, dtype=None):
    """a as a tensor; numpy input copied (it may be read-only)."""
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.array(a), device=device, dtype=dtype)


def make_weight_fns(nb_params, water_idxs, nb_beta, nb_cutoff, kT, weight_chunk: int = 128, device=None, dtype=None):
    """make_weight_fns_paramized's functions with nb_params bound, as
    tensors of `dtype` (None: the device's working dtype) on `device`
    (None: the card)."""
    device = resolve_device(device)
    nb_params = torch.as_tensor(np.asarray(nb_params), device=device, dtype=working_dtype(device, dtype))
    blw, blwi = make_weight_fns_paramized(
        water_idxs, nb_beta, nb_cutoff, kT, nb_params.shape[0], weight_chunk=weight_chunk, device=device
    )

    def batch_log_weights(conf, box):
        return blw(nb_params, conf, box)

    def batch_log_weights_incremental(conf, box, water_idx, new_pos, initial_weights):
        return blwi(nb_params, conf, box, water_idx, new_pos, initial_weights)

    return batch_log_weights, batch_log_weights_incremental


# -- the numpy-driven prototypes ---------------------------------------------------------------------


class BDExchangeMove(moves.MonteCarloMove):
    """Biased deletion, insertion anywhere in the box. Proposals draw from
    default_rng(seed) (JAX's `self.rng`, here `proposal_rng`); the
    Metropolis uniform from `rng`. The weights run on `device` (None: the
    card) in its working dtype."""

    def __init__(self, nb_beta: float, nb_cutoff: float, nb_params, water_idxs, temperature: float,
                 seed: Optional[int] = None, rng: Optional[np.random.Generator] = None, device=None):
        super().__init__(rng)
        self.nb_beta = nb_beta
        self.nb_cutoff = nb_cutoff
        self.nb_params = np.array(nb_params)
        self.water_idxs_np = np.array(water_idxs)
        self.num_waters = len(water_idxs)
        assert self.num_waters > 0
        self.n_atoms = len(nb_params)
        kT = BOLTZ * temperature
        self.beta = 1 / kT
        self.proposal_rng = np.random.default_rng(seed)
        self.batch_log_weights_fn, self.batch_log_weights_incremental = make_weight_fns(
            nb_params, water_idxs, nb_beta, nb_cutoff, kT, device=device
        )
        self.last_conf = None
        self.last_bw = None

    def batch_log_weights(self, conf, box) -> np.ndarray:
        """The full weights, cached on conf."""
        if self.last_conf is None or not np.array_equal(self.last_conf, conf):
            self.last_conf = np.array(conf)
            self.last_bw = self.batch_log_weights_fn(conf, box).cpu().numpy()
        return self.last_bw

    def _incremental(self, coords, box, water_idx, new_coords, weights):
        after, trial = self.batch_log_weights_incremental(coords, box, water_idx, new_coords, weights)
        return after.cpu().numpy(), trial.cpu().numpy()

    def propose(self, x: CoordsVelBox) -> tuple:
        coords, box = x.coords, x.box
        log_weights_before = self.batch_log_weights(coords, box)
        log_probs_before = log_weights_before - logsumexp(log_weights_before)
        chosen_water = self.proposal_rng.choice(np.arange(self.num_waters), p=np.exp(log_probs_before))
        chosen_water_atoms = self.water_idxs_np[chosen_water]

        trial_translation = np.diag(box) * self.proposal_rng.random(3)
        moved_coords = randomly_rotate_and_translate(coords[chosen_water_atoms], trial_translation, self.proposal_rng)

        log_weights_after, trial_coords = self._incremental(coords, box, chosen_water, moved_coords, log_weights_before)
        log_acceptance_probability = np.minimum(logsumexp(log_weights_before) - logsumexp(log_weights_after), 0.0)
        return CoordsVelBox(trial_coords, x.velocities, x.box), log_acceptance_probability


def delta_r_np(ri, rj, box):
    diff = ri - rj
    if box is not None:
        box_diag = np.diag(box)
        diff -= box_diag * np.floor(diff / box_diag + 0.5)
    return diff


def inner_insertion(radius, center, box, rng: Optional[np.random.Generator] = None):
    """A uniform point in the sphere."""
    rng = rng or np.random.default_rng()
    xyz = rng.normal(size=3)
    xyz /= np.linalg.norm(xyz)
    c = np.cbrt(rng.random())
    new_xyz = xyz * c * radius + center
    assert np.linalg.norm(delta_r_np(new_xyz, center, box)) < radius
    return new_xyz


def outer_insertion(radius, center, box, rng: Optional[np.random.Generator] = None):
    """A uniform point in the box outside the sphere, by rejection."""
    rng = rng or np.random.default_rng()
    for _ in range(1_000_000):
        xyz = rng.random(3) * np.diag(box)
        if np.linalg.norm(delta_r_np(xyz, center, box)) >= radius:
            return xyz
    raise AssertionError("outer_insertion failed")


def get_water_groups(coords, box, center, water_idxs, radius):
    """(inner, outer) indices of the waters whose centroids lie within
    `radius` of center, and the rest."""
    mol_centroids = np.mean(coords[water_idxs], axis=1)
    dijs = np.linalg.norm(delta_r_np(mol_centroids, center, box), axis=1)
    inner_mols = np.argwhere(dijs < radius).reshape(-1)
    outer_mols = np.argwhere(dijs >= radius).reshape(-1)
    assert len(inner_mols) + len(outer_mols) == len(water_idxs)
    return inner_mols, outer_mols


def compute_proposal_probabilities_given_counts(n_a, n_b):
    assert n_a >= 0 and n_b >= 0
    if n_a > 0 and n_b > 0:
        return 0.5
    if n_a > 0 or n_b > 0:
        return 1.0
    raise AssertionError("invalid corner")


def compute_raw_ratio_given_weights(log_weights_before, log_weights_after, vi_mols, vj_mols, vol_i, vol_j):
    """The log acceptance ratio of moving a water of region i (weights
    before, over vi_mols) into region j (weights after, over the moved
    water and vj_mols)."""
    assert len(vi_mols) > 0
    fwd_n_i, fwd_n_j = len(vi_mols), len(vj_mols)
    g_fwd = compute_proposal_probabilities_given_counts(fwd_n_i, fwd_n_j)
    g_rev = compute_proposal_probabilities_given_counts(fwd_n_i - 1, fwd_n_j + 1)
    return (
        logsumexp(log_weights_before)
        - logsumexp(log_weights_after)
        + np.log(vol_j)
        - np.log(vol_i)
        + np.log(g_rev)
        - np.log(g_fwd)
    )


class TIBDExchangeMove(BDExchangeMove):
    """Targeted insertion into, and biased deletion from, a sphere about
    the ligand's centroid, or the reverse."""

    def __init__(self, nb_beta: float, nb_cutoff: float, nb_params, water_idxs, temperature: float, ligand_idxs,
                 radius: float, seed: Optional[int] = None, rng: Optional[np.random.Generator] = None, device=None):
        super().__init__(nb_beta, nb_cutoff, nb_params, water_idxs, temperature, seed=seed, rng=rng, device=device)
        self.ligand_idxs = np.array(ligand_idxs)
        self.radius = radius

    def swap_vi_into_vj(self, vi_mols, vj_mols, x: CoordsVelBox, vj_site, vol_i, vol_j):
        coords, box = x.coords, x.box
        log_weights_before_full = self.batch_log_weights(coords, box)
        log_weights_before = log_weights_before_full[vi_mols]
        probs_before = np.exp(log_weights_before - logsumexp(log_weights_before))
        water_idx = self.proposal_rng.choice(vi_mols, p=probs_before)

        chosen_water_atoms = self.water_idxs_np[water_idx]
        new_coords = randomly_rotate_and_translate(coords[chosen_water_atoms], vj_site, self.proposal_rng)

        vj_plus_one_idxs = np.concatenate([[water_idx], vj_mols])
        log_weights_after_full, trial_coords = self._incremental(
            coords, box, water_idx, new_coords, log_weights_before_full
        )
        log_weights_after = log_weights_after_full[vj_plus_one_idxs]

        raw_log_p = compute_raw_ratio_given_weights(log_weights_before, log_weights_after, vi_mols, vj_mols, vol_i, vol_j)
        return CoordsVelBox(trial_coords, x.velocities, x.box), min(0.0, raw_log_p)

    def propose(self, x: CoordsVelBox) -> tuple:
        coords, box = x.coords, x.box
        center = np.mean(coords[self.ligand_idxs], axis=0)
        inner_mols, outer_mols = get_water_groups(coords, box, center, self.water_idxs_np, self.radius)
        n1, n2 = len(inner_mols), len(outer_mols)

        vol_1 = (4 / 3) * np.pi * self.radius**3
        vol_2 = np.prod(np.diag(box)) - vol_1

        v1_site = inner_insertion(self.radius, center, box, self.proposal_rng)
        v2_site = outer_insertion(self.radius, center, box, self.proposal_rng)

        if n1 > 0 and n2 == 0:
            return self.swap_vi_into_vj(inner_mols, outer_mols, x, v2_site, vol_1, vol_2)
        if n1 == 0 and n2 > 0:
            return self.swap_vi_into_vj(outer_mols, inner_mols, x, v1_site, vol_2, vol_1)
        if n1 > 0 and n2 > 0:
            if self.proposal_rng.random() < 0.5:
                return self.swap_vi_into_vj(inner_mols, outer_mols, x, v2_site, vol_1, vol_2)
            return self.swap_vi_into_vj(outer_mols, inner_mols, x, v1_site, vol_2, vol_1)
        raise AssertionError("no waters to swap")
