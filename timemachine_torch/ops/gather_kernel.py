"""Gather pair sweep: the rowscan pair function over atom-exact full
neighbour lists (counterpart of timemachine_tpu/ops/pallas/gather_kernel.py,
the `kernel="gather"` configuration).

Atoms are sorted along a snake path through 0.65 nm cells and cut into
32-atom row chunks. Each row chunk lists, in ascending sorted order, every
sorted slot whose distance to the chunk's bounding box is below the list
cutoff (cutoff + skin for MD): a FULL list, so every pair is seen from both
of its atoms and the row sums are complete without any reaction scatter
(u is halved). The self pair and padding slots are in the lists; the gate
(r^2 < cutoff^2) & (r^2 > 1e-7) and their q = eps = 0 rows remove them.

`gather_sweep` launches the hand-written CUDA kernel (`csrc/gather.cu`) on
CUDA tensors and uses `gather_sweep_plain`, the same function in plain
PyTorch over the full lists, on CPU tensors. The kernel sweeps each pair
once: only the suffix of row chunk r's list from its first slot >= 32 r
(`tri_start`, which holds every pair of r's atoms with a later atom), each
pair's force on both atoms and half its energy on each; it culls at every
sweep, at the bare cutoff + CULL_SLACK, the column atoms that do not come
near the box of the row chunk's atoms (at their images nearest its first
atom), and sweeps each warp's live columns in chunks of 32. `cull_mask`
and `cull_census` give the same cull and slot counts in plain PyTorch.

The list builder and the providers are plain tensor code, as they are plain
XLA in the JAX package. The JAX builder extracts each row's runs of slots
with top_k; the port compacts the mask with a cumulative sum, which gives
the same lists with no cap on the number of runs (ROADMAP P3).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from timemachine_torch.ops import _build
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.ops.nonbonded_kernel import (
    CULL_SLACK,
    ListState,
    StashedGradEnergy,
    make_list_md_provider,
    poison_on_overflow,
    run_dp,
    snake_order,
)

ROW = 32  # atoms per row chunk
SLAB = 512  # list capacities are rounded up to this (the JAX kernel's 4 x 128-lane step)
FORCE, FORCE_ENERGY = rs.FORCE, rs.FORCE_ENERGY  # sweep modes, as in csrc/gather.cu
CELL_SIZE = 0.65  # nm, the sort cells of the snake path
MASK_ELEMENTS = 1 << 22  # (rows, Npad) atom-vs-box entries built at once
# the kernel's work items, constants of csrc/gather.cu mirrored here for
# cull_census: SPLITS blocks of WARPS warps per row chunk, each warp a
# near-equal piece of the row's suffix
WARPS, SPLITS = 4, 2


def padded_size(n: int) -> int:
    """Sorted-array length: whole row chunks plus at least one padding slot,
    so that slot Npad - 1, the list padding, is never a real atom."""
    return (n // ROW + 1) * ROW


class GatherLists(NamedTuple):
    pad_order: torch.Tensor  # (Npad,) int64: sorted slot -> atom (padding slots -> atom 0)
    counts: torch.Tensor  # (nR,) int32: listed slots of each row chunk
    nbr: torch.Tensor  # (nR, max_nbrs) int32: sorted slots, ascending, padded with Npad - 1
    overflow: torch.Tensor  # () int64: slots of the longest list past max_nbrs
    tri_start: torch.Tensor  # (nR,) int32: listed slots below 32 r, where row chunk r's suffix starts


def build_gather_neighbors(
    conf, box, cutoff: float, max_nbrs: int, cell_size: float = CELL_SIZE, atom_mask=None,
) -> GatherLists:
    """Snake sort and, per 32-atom row chunk, the full list of sorted slots
    whose minimum-image distance to the chunk's bounding box is below
    `cutoff` (exact atom-vs-box culling). Padding slots sit on atom 0 and
    stay in the lists like any slot. Runs in f32 whatever conf's dtype; the
    (rows, Npad) mask is built MASK_ELEMENTS entries at a time. tri_start[r]
    counts the listed slots below 32 r (capped at max_nbrs): the suffix
    from there holds every pair of r's atoms with a later atom.

    atom_mask (N,) bool, where given, keeps only its atoms in the chunk
    boxes, as JAX's builder does, and in the lists, where JAX's keeps the
    others with zero parameters: a masked atom, or a padding slot, is
    listed by no row (its own row chunk still sweeps it against its list,
    where its zero q and eps make every pair vanish)."""
    n = conf.shape[0]
    dev = conf.device
    n_pad = padded_size(n)
    n_rows = n_pad // ROW
    box_diag = torch.diagonal(box).to(torch.float32)
    x32 = conf[:, :3].to(torch.float32)
    wrapped = x32 - box_diag * torch.floor(x32 / box_diag)
    order = snake_order(wrapped, box_diag, cell_size)
    pad_order = torch.cat([order, order.new_zeros(n_pad - n)])

    xs = wrapped[pad_order]
    valid = (torch.arange(n_pad, device=dev) < n)[:, None]
    if atom_mask is not None:
        valid = valid & atom_mask[pad_order][:, None]
    listable = None if atom_mask is None else valid[:, 0]
    rmin = torch.where(valid, xs, 1e9).view(n_rows, ROW, 3).amin(1)
    rmax = torch.where(valid, xs, -1e9).view(n_rows, ROW, 3).amax(1)
    rcen = 0.5 * (rmin + rmax)
    rhal = torch.clamp(0.5 * (rmax - rmin), min=0.0)
    r_has = valid.view(n_rows, ROW).any(1)

    counts = torch.empty(n_rows, dtype=torch.int64, device=dev)
    tri_start = torch.empty(n_rows, dtype=torch.int64, device=dev)
    nbr = torch.full((n_rows, max_nbrs + 1), n_pad - 1, dtype=torch.int32, device=dev)  # last column: dump
    slots = torch.arange(n_pad, dtype=torch.int32, device=dev)
    batch = max(1, MASK_ELEMENTS // n_pad)
    for r0 in range(0, n_rows, batch):
        r1 = min(r0 + batch, n_rows)
        dcl = rcen[r0:r1, None, :] - xs[None, :, :]
        dcl = dcl - box_diag * torch.floor(dcl / box_diag + 0.5)
        gap = torch.clamp(torch.abs(dcl) - rhal[r0:r1, None, :], min=0.0)
        d2 = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] + gap[..., 2] * gap[..., 2]
        inside = (d2 < cutoff * cutoff) & r_has[r0:r1, None]
        if listable is not None:
            inside &= listable[None, :]
        rank = torch.cumsum(inside, dim=1) - 1
        counts[r0:r1] = rank[:, -1] + 1
        rows = torch.arange(r0, r1, device=dev)
        tri_start[r0:r1] = torch.where(rows > 0, rank[rows - r0, torch.clamp(rows * ROW - 1, min=0)] + 1, 0)
        target = torch.where(inside & (rank < max_nbrs), rank, max_nbrs)
        nbr[r0:r1].scatter_(1, target, slots.expand(r1 - r0, n_pad))
    nbr[:, max_nbrs] = n_pad - 1
    return GatherLists(
        pad_order=pad_order,
        counts=torch.clamp(counts, max=max_nbrs).to(torch.int32),
        nbr=nbr[:, :max_nbrs].contiguous(),
        overflow=torch.clamp(counts.max() - max_nbrs, min=0),
        tri_start=torch.clamp(tri_start, max=max_nbrs).to(torch.int32),
    )


def suggest_max_nbrs(conf, box, cutoff: float, margin: float = 1.25, atom_mask=None) -> int:
    """Host-side capacity: the longest row list at this geometry (under
    atom_mask where given), times margin for diffusion between rebuilds,
    rounded up to SLAB."""
    n_pad = padded_size(conf.shape[0])
    lists = build_gather_neighbors(conf, box, cutoff, -(-n_pad // SLAB) * SLAB, atom_mask=atom_mask)
    peak = int(lists.counts.max())
    return max(int(np.ceil(peak * margin / SLAB) * SLAB), SLAB)


def gather_sweep_plain(atoms, counts, nbr, scalars, series, mode: int):
    """The sweep in plain PyTorch, in atoms' dtype: each batch of row chunks
    gathers its listed atoms into (rows, 32, L) pair tensors masked by
    counts, with L the batch's longest list. A batch holds at most about
    2^18 pair slots on the CPU and 2^24 on a card. Returns (Npad, 4)
    [u_i, dU/dx_i] like the kernel; u_i is half of atom i's pair energies."""
    gather_sweep_plain.calls += 1
    block_pairs = 1 << 18 if atoms.device.type == "cpu" else 1 << 24
    n_pad = atoms.shape[0]
    n_rows = n_pad // ROW
    out = atoms.new_zeros((n_pad, 4))
    count_list = counts.tolist()
    batch = max(1, block_pairs // (max(max(count_list), 1) * ROW))
    rows = atoms.view(n_rows, ROW, 8)
    box = scalars[:3]
    inv_box = 1.0 / box
    cut2 = scalars[3] * scalars[3]
    for r0 in range(0, n_rows, batch):
        r1 = min(r0 + batch, n_rows)
        length = max(count_list[r0:r1])
        if length == 0:
            continue
        listed = (torch.arange(length, device=atoms.device) < counts[r0:r1, None])[:, None, :]  # (b, 1, L)
        cj = atoms[nbr[r0:r1, :length].long()].permute(2, 0, 1).unsqueeze(2)  # (8, b, 1, L)
        ri = rows[r0:r1].permute(2, 0, 1).unsqueeze(3)  # (8, b, 32, 1)
        d = [ri[a] - cj[a] for a in range(3)]  # each (b, 32, L)
        d = [da - box[a] * torch.round(da * inv_box[a]) for a, da in enumerate(d)]
        dw = ri[3] - cj[3]
        de_r, e = rs.pair_terms(d, dw, ri[4] * cj[4], ri[5] + cj[5], ri[6] * cj[6], cut2, listed, series, mode)
        sl = slice(r0 * ROW, r1 * ROW)
        for a in range(3):
            out[sl, 1 + a] = (de_r * d[a]).sum(2).reshape(-1)
        if mode == FORCE_ENERGY:
            out[sl, 0] = 0.5 * e.sum(2).reshape(-1)
    return out


gather_sweep_plain.calls = 0


class GatherCull(NamedTuple):
    rows: torch.Tensor  # (E,) row chunk of each suffix slot, in row and list order
    piece: torch.Tensor  # (E,) the kernel's list piece (warp) of the slot within its row
    slot: torch.Tensor  # (E,) the column atom's sorted slot
    column: torch.Tensor  # (E,) bool: column atoms the cull keeps


def cull_mask(atoms, counts, nbr, tri_start, scalars) -> GatherCull:
    """The kernel's cull over each row chunk's suffix nbr[r, tri_start[r] :
    counts[r]], at the bare cutoff + CULL_SLACK (scalars[3] is the cutoff):
    a column atom is kept where its per-axis minimum image from the center of
    the row chunk's box, less the box's half-extent, leaves a gap within
    the cull radius. The box holds the row atoms (padding included) at their
    images nearest the chunk's first atom. On each axis the gap is at most
    the pair function's own minimum-image difference, and w only adds to
    r^2, so no pair within the cutoff is dropped."""
    dev = atoms.device
    n_rows = counts.shape[0]
    count = torch.clamp(counts.long(), max=nbr.shape[1])
    start = torch.minimum(tri_start.long(), count)
    length = count - start
    rows = torch.repeat_interleave(torch.arange(n_rows, device=dev), length)
    k = torch.arange(rows.shape[0], device=dev) - torch.repeat_interleave(torch.cumsum(length, 0) - length, length)
    slot = nbr[rows, start[rows] + k].long()
    pieces = SPLITS * WARPS
    bounds = length[:, None] * torch.arange(pieces + 1, device=dev) // pieces  # (nR, pieces + 1)
    piece = torch.searchsorted(bounds[rows], k[:, None], right=True)[:, 0] - 1
    box, inv_box = scalars[:3], 1.0 / scalars[:3]
    x = atoms[:, :3].reshape(n_rows, ROW, 3)
    near = x - box * torch.round((x - x[:, :1]) * inv_box)  # at the images nearest each chunk's first atom
    lo, hi = near.amin(1), near.amax(1)
    center, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    v = atoms[slot, :3] - center[rows]
    gap = torch.clamp(torch.abs(v - box * torch.round(v * inv_box)) - half[rows], min=0.0)
    cull = scalars[3] + CULL_SLACK
    d2 = gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1] + gap[:, 2] * gap[:, 2]
    return GatherCull(rows, piece, slot, d2 < cull * cull)


class CullCensus(NamedTuple):
    """Pair slots of the gather kernel on one set of lists."""

    listed: int  # 32 rows x the listed slots of the full lists (the first design's sweep)
    suffix: int  # 32 rows x the slots of the Newton-triangular suffixes
    columns: int  # 32 rows x the suffix slots the cull keeps
    swept: int  # what the kernel sweeps: each warp's live columns in chunks of 32


def cull_census(atoms, counts, nbr, tri_start, scalars) -> CullCensus:
    """Slot counts of the kernel's suffix, cull and chunking, counted by the
    plain copy of them (cull_mask; each warp's piece of a row's suffix is
    swept in chunks of 32 columns), not by the kernel."""
    c = cull_mask(atoms, counts, nbr, tri_start, scalars)
    pieces = SPLITS * WARPS
    live = torch.zeros(counts.shape[0] * pieces, dtype=torch.int64, device=atoms.device)
    live.index_add_(0, c.rows * pieces + c.piece, c.column.long())
    return CullCensus(
        listed=int(torch.clamp(counts.long(), max=nbr.shape[1]).sum()) * ROW,
        suffix=c.rows.shape[0] * ROW,
        columns=int(c.column.sum()) * ROW,
        swept=int(((live + ROW - 1) // ROW).sum()) * ROW * ROW,
    )


def _launcher():
    fn = _build.load_library("gather").gather_sweep_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def gather_sweep(atoms, counts, nbr, tri_start, scalars, series, mode: int, first_design: bool = False):
    """(Npad, 4) [u_i, dU/dx_i] of the sweep over each row chunk's list.

    atoms (Npad, 8) f32 sorted rows [x y z w q sigma/2 2 sqrt(eps) 0], counts
    (nR,), nbr (nR, max_nbrs) and tri_start (nR,) int32 (GatherLists),
    scalars (4,) f32 [bx by bz cutoff], series the (h, P) coefficient tuples
    of es_energy_force_series, mode FORCE or FORCE_ENERGY (the energy column
    is zero in FORCE). A CUDA tensor launches the kernel of csrc/gather.cu
    on the current stream, over each row's suffix from tri_start, with an
    int64 fixed-point scratch for the sums (NaN wherever a sum leaves its
    range); first_design launches the first design's kernel over the full
    lists instead (F mode only: the yardstick the redesign is timed
    against). A CPU tensor runs gather_sweep_plain over the full lists."""
    if atoms.device.type == "cpu":
        return gather_sweep_plain(atoms, counts, nbr, scalars, series, mode)
    if atoms.device.type != "cuda":
        raise ValueError(f"gather_sweep: no kernel for device {atoms.device}")
    if mode not in (FORCE, FORCE_ENERGY):
        raise ValueError(f"gather_sweep: unknown mode {mode}")
    if first_design and mode != FORCE:
        raise ValueError("gather_sweep: the first design is built in F mode only")
    dev = atoms.device
    n_pad = atoms.shape[0]
    if n_pad % ROW:
        raise ValueError(f"gather_sweep: {n_pad} atom rows is not a multiple of {ROW}")
    n_rows = n_pad // ROW
    rs.check_tensor("atoms", atoms, torch.float32, dev, (n_pad, 8))
    rs.check_tensor("counts", counts, torch.int32, dev, (n_rows,))
    if nbr.dim() != 2 or nbr.shape[0] != n_rows:
        raise ValueError(f"nbr: want shape ({n_rows}, max_nbrs), got {tuple(nbr.shape)}")
    rs.check_tensor("nbr", nbr, torch.int32, dev)
    rs.check_tensor("tri_start", tri_start, torch.int32, dev, (n_rows,))
    rs.check_tensor("scalars", scalars, torch.float32, dev, (4,))
    h_arg, p_arg = rs.series_args(series)
    out = torch.empty((n_pad, 4), dtype=torch.float32, device=dev)
    acc = torch.zeros(0 if first_design else 4 * n_pad + 1, dtype=torch.int64, device=dev)  # the sums, then the flag
    rc = _launcher()(
        atoms.data_ptr(), counts.data_ptr(), nbr.data_ptr(), tri_start.data_ptr(), scalars.data_ptr(), out.data_ptr(),
        acc.data_ptr(), n_rows, nbr.shape[1], mode, int(first_design), h_arg, p_arg,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gather_sweep: kernel launch failed with CUDA error {rc}")
    gather_sweep.launches += 1
    return out


gather_sweep.launches = 0


def make_nonbonded_gather_md(
    beta: float, cutoff: float, max_nbrs: int, skin: float = 0.1, rebuild_interval: int = 20, atom_mask=None,
):
    """MD force provider over full neighbour lists: an F sweep per step, an
    F+U sweep for the energy; see nonbonded_kernel.make_list_md_provider.
    The JAX provider has no energy; its barostat evaluates the energy with
    lists built for the call at the bare cutoff: the same pairs pass the
    same gate (ROADMAP P3). atom_mask (N,) bool, where given, restricts the
    term to its atoms (build_gather_neighbors, param_rows)."""
    series = rs.es_energy_force_series(beta, cutoff)

    def build(conf, params, box):
        lists = build_gather_neighbors(conf, box, cutoff + skin, max_nbrs, atom_mask=atom_mask)
        n = conf.shape[0]
        prows = rs.param_rows(params.to(conf.dtype), lists.pad_order, n, atom_mask)
        return ListState(lists, torch.argsort(lists.pad_order[:n]), prows, lists.overflow)

    def sweep(state, conf, box, mode):
        atoms = rs.assemble_atoms(conf, box, state.lists.pad_order, state.prows)
        lists = state.lists
        scalars = rs.sweep_scalars(box, cutoff)
        return gather_sweep(atoms, lists.counts, lists.nbr, lists.tri_start, scalars, series, mode)

    return make_list_md_provider(build, sweep, FORCE, FORCE_ENERGY, rebuild_interval, prows_fn=rs.param_rows_of(atom_mask))


def make_nonbonded_gather_energy_force(beta: float, cutoff: float, max_nbrs: int, atom_mask=None):
    """(conf, params, box) -> (u, force) in one F+U sweep over lists built
    for this call at the bare cutoff (use the MD provider in a step loop),
    only the pairs of atom_mask (N,) bool where given."""
    series = rs.es_energy_force_series(beta, cutoff)

    def energy_force(conf, params, box):
        lists = build_gather_neighbors(conf, box, cutoff, max_nbrs, atom_mask=atom_mask)
        n = conf.shape[0]
        prows = rs.param_rows(params.to(conf.dtype), lists.pad_order, n, atom_mask)
        atoms = rs.assemble_atoms(conf, box, lists.pad_order, prows)
        out = gather_sweep(
            atoms, lists.counts, lists.nbr, lists.tri_start, rs.sweep_scalars(box, cutoff), series, FORCE_ENERGY
        )
        force = -out[torch.argsort(lists.pad_order[:n]), 1:4]
        return poison_on_overflow(lists.overflow, torch.sum(out[:, 0])), poison_on_overflow(lists.overflow, force)

    return energy_force


def make_nonbonded_gather(
    beta: float, cutoff: float, max_nbrs: int, dp_max_tiles: int, dp_cb: int = 2, atom_mask=None,
):
    """Differentiable energy(conf, params, box): the forward runs one F+U
    gather sweep and stashes dU/dx; dU/dp comes from the block-tile kernel's
    DP pass (exact electrostatics), as the JAX custom VJP uses _run_dp;
    both over the atoms of atom_mask (N,) bool where given."""
    ef = make_nonbonded_gather_energy_force(beta, cutoff, max_nbrs, atom_mask=atom_mask)

    def energy_grad(conf, params, box):
        u, force = ef(conf, params, box)
        return u, -force

    def dp(conf, params, box):
        return run_dp(conf, params, box, beta, cutoff, dp_max_tiles, cb=dp_cb, atom_mask=atom_mask)

    def energy(conf, params, box):
        return StashedGradEnergy.apply(conf, params, box, energy_grad, dp)

    return energy
