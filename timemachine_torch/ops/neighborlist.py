"""O(N) nonbonded energy over a cell list with static shapes (counterpart
of timemachine_tpu/ops/neighborlist.py), in plain torch on the caller's
device.

Atoms are binned into a fixed 3-D grid of cells at least a cutoff wide,
held as a (n_cells, capacity) table padded with the index n, and every cell
meets its 27-cell stencil. A cell with more atoms than `capacity` drops the
rest, and the count of dropped atoms comes back as `overflow`.

The pair math is ops/nonbonded.py's: 4-D lifted LJ and the switched erfc
Coulomb term. The port's MD and free-energy paths do not go through this
module: its `Nonbonded` terms serve JAX's "tiled" form with their own
configuration (ROADMAP P11).
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.ops.nonbonded import lennard_jones, switched_direct_space_pme


def choose_grid(box_diag, cutoff: float, padding: float = 0.0) -> tuple[int, int, int]:
    """Cells per dimension, so that a cell is at least cutoff + padding wide."""
    box_diag = np.asarray(box_diag)
    dims = np.maximum(1, np.floor(box_diag / (cutoff + padding)).astype(int))
    return tuple(int(d) for d in dims)


def choose_capacity(num_atoms: int, grid_dims, headroom: float = 3.0, conf=None, box=None) -> int:
    """Cell capacity with headroom: from the fullest cell of conf in box where
    both are given, else from the mean occupancy; a multiple of 8."""
    n_cells = int(np.prod(grid_dims))
    if conf is not None and box is not None:
        box_diag = np.diagonal(np.asarray(box))
        dims = np.asarray(grid_dims)
        frac = np.asarray(conf)[:, :3] / box_diag
        frac = frac - np.floor(frac)
        cell_xyz = np.minimum((frac * dims).astype(int), dims - 1)
        cid = (cell_xyz[:, 0] * grid_dims[1] + cell_xyz[:, 1]) * grid_dims[2] + cell_xyz[:, 2]
        occ = np.bincount(cid, minlength=n_cells)
        cap = int(np.ceil(occ.max() * 1.25)) + 4
    else:
        mean = num_atoms / n_cells
        cap = int(np.ceil(mean * headroom)) + 8
    return int(np.ceil(cap / 8) * 8)


def build_cell_list(conf, box, grid_dims: tuple[int, int, int], capacity: int):
    """Bin atoms into a (n_cells, capacity) index table, padded with n_atoms.

    Returns (cell_table, cell_of_atom, overflow_count).
    """
    n = conf.shape[0]
    box_diag = torch.diagonal(box)
    dims = torch.tensor(grid_dims, device=conf.device)
    frac = conf[:, :3] / box_diag
    frac = frac - torch.floor(frac)
    cell_xyz = torch.minimum((frac * dims).to(torch.int32), dims - 1)
    cell_of_atom = (cell_xyz[:, 0] * grid_dims[1] + cell_xyz[:, 1]) * grid_dims[2] + cell_xyz[:, 2]

    n_cells = grid_dims[0] * grid_dims[1] * grid_dims[2]
    order = torch.argsort(cell_of_atom, stable=True)
    sorted_cells = cell_of_atom[order].contiguous()
    cells = torch.arange(n_cells, device=conf.device, dtype=sorted_cells.dtype)
    start = torch.searchsorted(sorted_cells, cells)
    end = torch.searchsorted(sorted_cells, cells, right=True)
    overflow = torch.clamp(end - start - capacity, min=0).sum()
    pos = start[:, None] + torch.arange(capacity, device=conf.device)[None, :]
    table = torch.where(pos < end[:, None], order[pos.clamp(0, n - 1)], n)
    return table, cell_of_atom, overflow


def _stencil_offsets(grid_dims):
    """(27, 3) neighbour cell offsets; a dimension of fewer than 3 cells has a
    smaller stencil, so that no cell is met twice through the periodic wrap."""
    ranges = []
    for d in grid_dims:
        if d >= 3:
            ranges.append((-1, 0, 1))
        elif d == 2:
            ranges.append((0, 1))
        else:
            ranges.append((0,))
    return np.array([(i, j, k) for i in ranges[0] for j in ranges[1] for k in ranges[2]], dtype=np.int64)


def nonbonded_cell_list_energy(conf, params, box, grid_dims, capacity, beta, cutoff, atom_mask=None, cell_chunk=None):
    """Total LJ and switched Coulomb energy over the cell-list stencil, and the
    overflow count of the binning.

    Padded table entries point at a sentinel row with zero parameters, far
    away, so they add nothing. The cells are taken `cell_chunk` at a time,
    which bounds the memory to cell_chunk * capacity^2 * stencil pairs.
    """
    n = conf.shape[0]
    grid_dims = tuple(int(d) for d in grid_dims)
    table, _, overflow = build_cell_list(conf, box, grid_dims, capacity)

    # a masked atom gets zero charge and zero epsilon, so its pairs add exactly 0
    if atom_mask is not None:
        m = torch.as_tensor(atom_mask, dtype=params.dtype, device=params.device)
        params = torch.stack([params[:, 0] * m, params[:, 1], params[:, 2] * m, *params[:, 3:].unbind(1)], dim=1)

    conf_ext = torch.cat([conf, torch.full((1, 3), 2e5, dtype=conf.dtype, device=conf.device)])
    params_ext = torch.cat([params, params.new_zeros((1, params.shape[1]))])

    offsets = torch.as_tensor(_stencil_offsets(grid_dims), device=conf.device)
    dims = torch.tensor(grid_dims, device=conf.device)
    n_cells = grid_dims[0] * grid_dims[1] * grid_dims[2]
    cell_ids = torch.arange(n_cells, device=conf.device)
    cell_xyz = torch.stack(
        [cell_ids // (grid_dims[1] * grid_dims[2]), (cell_ids // grid_dims[2]) % grid_dims[1], cell_ids % grid_dims[2]],
        dim=1,
    )
    nbr_xyz = (cell_xyz[:, None, :] + offsets[None, :, :]) % dims
    nbr_ids = (nbr_xyz[..., 0] * grid_dims[1] + nbr_xyz[..., 1]) * grid_dims[2] + nbr_xyz[..., 2]
    box_diag = torch.diagonal(box)
    col_all = table[nbr_ids].reshape(n_cells, -1)  # (C, S * capacity)

    if cell_chunk is None:
        cell_chunk = max(1, min(n_cells, 4096 // capacity))
    total = conf.new_zeros(())
    for c0 in range(0, n_cells, cell_chunk):
        row_idx, col_idx = table[c0 : c0 + cell_chunk], col_all[c0 : c0 + cell_chunk]
        xi, xj = conf_ext[row_idx], conf_ext[col_idx]
        pi, pj = params_ext[row_idx], params_ext[col_idx]
        dr = xi[:, :, None, :] - xj[:, None, :, :]
        dr = dr - box_diag * torch.floor(dr / box_diag + 0.5)
        dw = pi[..., 3][:, :, None] - pj[..., 3][:, None, :]
        d2 = torch.sum(dr * dr, dim=-1) + dw * dw

        valid = (row_idx[:, :, None] < n) & (col_idx[:, None, :] < n) & (row_idx[:, :, None] != col_idx[:, None, :])
        in_range = valid & (d2 < cutoff * cutoff)
        dij = torch.sqrt(torch.where(in_range, d2, 1.0))

        sig_ij = pi[..., 1][:, :, None] + pj[..., 1][:, None, :]
        eps_eff = torch.where(in_range, pi[..., 2][:, :, None] * pj[..., 2][:, None, :], 0.0)
        lj = torch.where(eps_eff != 0, lennard_jones(dij, sig_ij, eps_eff), 0.0)
        qij = torch.where(in_range, pi[..., 0][:, :, None] * pj[..., 0][:, None, :], 0.0)
        es = torch.where(in_range, switched_direct_space_pme(dij, qij, beta), 0.0)
        total = total + torch.sum(lj + es)
    return 0.5 * total, overflow


class CellListOverflow(RuntimeError):
    pass


def nonbonded_all_pairs_tiled(conf, params, box, beta, cutoff, atom_mask=None, padding=0.2, grid_dims=None, capacity=None):
    """The all-pairs energy over a cell list. Without grid_dims and capacity
    they follow from the box. Where a cell overflowed the energy is NaN, as
    the port's other list-based energies give it (ROADMAP R4)."""
    if grid_dims is None or capacity is None:
        grid_dims = choose_grid(np.diagonal(box.detach().cpu().numpy()), cutoff)
        capacity = choose_capacity(conf.shape[0], grid_dims)
    energy, overflow = nonbonded_cell_list_energy(
        conf, params, box, tuple(grid_dims), int(capacity), float(beta), float(cutoff), atom_mask
    )
    return torch.where(overflow > 0, torch.nan, energy)
