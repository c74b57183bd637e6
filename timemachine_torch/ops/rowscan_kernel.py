"""Rowscan pair sweep: the all-pairs nonbonded term of the MD main path
(counterpart of timemachine_tpu/ops/pallas/rowscan_kernel.py).

Atoms are sorted along a snake path through spatial cells and cut into
32-atom row chunks and 128-atom column chunks. Each row chunk lists the
column chunks whose bounding boxes come within the cutoff (plus skin), in
ascending order of that gap. The sweep visits every listed (row chunk,
column chunk) tile and sums, per row atom,

    LJ   4 eps ((sigma/r)^12 - (sigma/r)^6)   on rows [x y z w q sigma/2 2 sqrt(eps) 0]
    ES   qq h(t) / r,  force factor qq P(t) / r^3,  t = 2 r / 1.2 - 1

with the gate (r^2 < cutoff^2) & (r^2 > 1e-7), in the forms of JAX's
rowscan_sweep:

  symmetric / triangular   every pair seen from both atoms, energy halved;
                           or Newton-triangular lists, each row chunk's
                           covering column chunk swept first with the gate
                           row atom < column atom, each pair's energy to its
                           row atom and its force to both (none to the
                           column in ENERGY mode, JAX's u_only)
  minimum image / preshift per-pair minimum image; or every atom mapped to
                           its image nearest its row chunk's periodic center
                           (`rcen_q` of dotscan_kernel.build_dotscan_tiles,
                           which rechecks the image bound at every rebuild)
  has_w                    the 4D w lift in r^2, or none (all w zero)

The main path runs JAX's default DHFR form: triangular, preshift, no w.

`rowscan_sweep` launches the hand-written CUDA kernel (`csrc/rowscan.cu`) on
CUDA tensors and uses `rowscan_sweep_plain`, the same function in plain
PyTorch, on CPU tensors. The tile builder, the per-step count chop and the
MD provider are plain tensor code, as they are plain XLA in the JAX package.
Each launching wrapper counts its launches (`launches`) and, by form,
`launches_by_form`.

A sweep may cover a row slab, the row chunks [row_base, row_base +
n_rows_local) of whole lists (JAX's `row_base`): `rowscan_sweep_sharded`
gives each rank of a mesh its slab and sums the slabs over the mesh before
the store, as spatially decomposed MD (parallel/spatial_md.py) does every
step. Slab launches are also counted in `rowscan_sweep.launches_slabs`.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from timemachine_torch.ops import _build
from timemachine_torch.ops.nonbonded import SWITCH_CUTOFF, polyval_t
from timemachine_torch.ops.nonbonded_kernel import (
    ListState,
    StashedGradEnergy,
    hilbert_order,
    make_batched_list_md_provider,
    make_list_md_provider,
    poison_on_overflow,
    run_dp,
    snake_order,
)
from timemachine_torch.parallel import mesh as mesh_ops

ROW = 32  # atoms per row chunk
COL = 128  # atoms per column chunk
FORCE, FORCE_ENERGY, ENERGY = 0, 1, 2  # sweep modes, as in csrc/rowscan.cu
CEN_SCALE = 1e-4  # nm per unit of the quantized row centers (rcen_q)
_K1 = 2.0 / SWITCH_CUTOFF  # t = _K1 * r - 1
# the Newton-triangular sweeps (rowscan, quadscan, dotscan) sum column
# reactions (rowscan also its row sums and energies) in int64 fixed point at
# this many units per kJ/mol/nm (csrc/fixed_point.cuh): range +-2^31 =
# 2.1e9 (DHFR's largest all-pairs |dU/dx|: 3.1e7 at the start, 3.5e7-5.2e7 at NPT end states)
FIXED_SCALE = 2.0**32

_poly_cache: dict = {}


def es_energy_force_series(beta: float, cutoff: float, deg: int = 10):
    """Monomial series in t = 2(r/cutoff) - 1 on [-1, 1] for

        h(u) = erfc(beta c u) * cos^3((pi/2) u^8)     [energy:  E = qq h(u)/r]
        P(u) = u h'(u) - h(u)                         [force:   dE/dr / r = qq P(u)/r^3]

    h is FIT (Chebyshev least squares in f64); P is derived from the fitted h
    by exact Chebyshev coefficient algebra (derivative + multiply-by-u), so
    the force is the exact analytic gradient of the polynomial energy. Both
    are then converted (exactly, in f64) to the MONOMIAL basis in t = 2u - 1:
    on that symmetric domain max|coef| < 1, so f32 Horner evaluates to
    ~1.6e-7 max abs error (measured vs the f64 Chebyshev reference — at or
    below Clenshaw's error) at HALF the op count (1 fma/degree vs 2)."""
    key = (float(beta), float(cutoff), deg)
    if key not in _poly_cache:
        from scipy.special import erfc as _erfc

        u = np.linspace(0.0, 1.0, 8001)
        bc = beta * cutoff
        h = _erfc(bc * u) * np.cos(np.pi / 2 * u**8) ** 3
        ch = np.polynomial.chebyshev.Chebyshev.fit(u, h, deg, domain=[0.0, 1.0])
        # work on [-1, 1] coefficients: u = (t + 1) / 2  =>  d/du = 2 d/dt
        c = ch.coef
        dc = np.polynomial.chebyshev.chebder(c) * 2.0  # h'(u) in t-basis
        # u * h'(u) = ((t + 1)/2) * h'(u): multiply by t via T-recurrence then average
        tc = np.polynomial.chebyshev.chebmulx(dc)  # t * h'
        n = max(len(c), len(tc) + 0)
        P = np.zeros(n)
        P[: len(tc)] += 0.5 * tc
        P[: len(dc)] += 0.5 * dc
        P[: len(c)] -= c
        mono_h = np.polynomial.chebyshev.cheb2poly(c)
        mono_P = np.polynomial.chebyshev.cheb2poly(P)
        _poly_cache[key] = (tuple(float(v) for v in mono_h), tuple(float(v) for v in mono_P))
    return _poly_cache[key]


def padded_size(n: int) -> int:
    """Sorted-array length: whole column chunks plus one all-padding chunk."""
    return (-(-n // COL) + 1) * COL


class RowscanTiles(NamedTuple):
    pad_order: torch.Tensor  # (Npad,) int64: sorted slot -> atom (padding slots -> atom 0)
    row_start: torch.Tensor  # (nR,) int32: first col_ids entry of each row chunk
    row_count: torch.Tensor  # (nR,) int32: listed column chunks of each row chunk
    col_ids: torch.Tensor  # (max_pairs,) int32: column chunk ids, gap-ascending per row
    rank_mat: torch.Tensor  # (nR, nC) int32: rank of chunk c in row r's list, -1 if unlisted
    overflow: torch.Tensor  # () int64: entries that did not fit in max_pairs


def _bbox_gap2(rmin, rmax, cmin, cmax, box_diag):
    """(..., nR, nC) squared minimum-image gap between row and column chunk
    boxes (..., nR | nC, 3), box_diag (..., 3)."""
    rcen, rhal = 0.5 * (rmin + rmax), 0.5 * (rmax - rmin)
    ccen, chal = 0.5 * (cmin + cmax), 0.5 * (cmax - cmin)
    dc = rcen[..., :, None, :] - ccen[..., None, :, :]
    box_diag = box_diag[..., None, None, :]
    dc = dc - box_diag * torch.floor(dc / box_diag + 0.5)
    gap = torch.clamp(torch.abs(dc) - (rhal[..., :, None, :] + chal[..., None, :, :]), min=0.0)
    return torch.sum(gap * gap, dim=-1)


def _wrap(xyz, box_diag):
    return xyz - box_diag * torch.floor(xyz / box_diag)


def build_rowscan_tiles(
    conf, box, cutoff: float, max_pairs: int, cell_size: float = 0.65, triangular: bool = False, sort: str = "snake",
    atom_mask=None,
) -> RowscanTiles:
    """Spatial sort + per-row-chunk column lists culled at `cutoff` by
    bounding-box gap, ordered by that gap so that `chop_row_counts` can cut
    the skin shell off their tails. Runs in f32 whatever conf's dtype.

    sort="snake" walks cells of cell_size nm; "hilbert" follows the Hilbert
    curve of quadscan's keys (compact chunks at any density). Symmetric
    lists (the default) list every interacting chunk pair for both of its
    rows; triangular lists hold, for row chunk r, only the column chunks
    strictly after the one that covers r, as JAX's do: a Newton-triangular
    sweep peels the covering chunk itself. Unlike JAX's, the lists are not
    padded per row to a multiple of 4 (the TPU kernel's unroll).

    atom_mask (N,) bool, where given, keeps only its atoms in the chunk
    boxes, as JAX's builder does: a chunk with no atom of the subset lists
    nothing (its rows still sweep their covering chunk in triangular form,
    where the masked atoms' zero q and eps make every pair vanish)."""
    if sort not in ("snake", "hilbert"):
        raise ValueError(f"sort must be 'snake' or 'hilbert', got {sort!r}")
    n = conf.shape[0]
    dev = conf.device
    n_pad = padded_size(n)
    n_rows, n_cols = n_pad // ROW, n_pad // COL
    box_diag = torch.diagonal(box).to(torch.float32)
    wrapped = _wrap(conf[:, :3].to(torch.float32), box_diag)

    order = snake_order(wrapped, box_diag, cell_size) if sort == "snake" else hilbert_order(wrapped, box_diag)
    pad_order = torch.cat([order, order.new_zeros(n_pad - n)])

    xs = wrapped[pad_order]
    valid = (torch.arange(n_pad, device=dev) < n)[:, None]
    if atom_mask is not None:
        valid = valid & atom_mask[pad_order][:, None]
    lo = torch.where(valid, xs, 1e9)
    hi = torch.where(valid, xs, -1e9)
    d2 = _bbox_gap2(
        lo.view(n_rows, ROW, 3).amin(1), hi.view(n_rows, ROW, 3).amax(1),
        lo.view(n_cols, COL, 3).amin(1), hi.view(n_cols, COL, 3).amax(1), box_diag,
    )
    has_r = valid.view(n_rows, ROW).any(1)
    has_c = valid.view(n_cols, COL).any(1)
    inter = (d2 < cutoff * cutoff) & has_r[:, None] & has_c[None, :]
    if triangular:
        covering = torch.arange(n_rows, device=dev) * ROW // COL
        inter &= torch.arange(n_cols, device=dev)[None, :] > covering[:, None]

    counts = inter.sum(1)
    sorted_cols = torch.argsort(torch.where(inter, torch.sqrt(d2), torch.inf), dim=1, stable=True)
    row_start = torch.cumsum(counts, 0) - counts
    k = torch.arange(n_cols, device=dev)
    target = row_start[:, None] + k
    ok = (k < counts[:, None]) & (target < max_pairs)
    # entries that are not written go to distinct slots past max_pairs
    slot = torch.where(ok, target, max_pairs + torch.arange(n_rows * n_cols, device=dev).view(n_rows, n_cols))
    cols = torch.full((max_pairs + n_rows * n_cols,), n_cols - 1, dtype=torch.int32, device=dev)
    cols[slot.reshape(-1)] = sorted_cols.reshape(-1).to(torch.int32)
    rank_mat = torch.full((n_rows, n_cols), -1, dtype=torch.int32, device=dev)
    rank_mat.scatter_(1, sorted_cols, torch.where(ok, k, -1).to(torch.int32))
    return RowscanTiles(
        pad_order=pad_order,
        row_start=torch.clamp(row_start, max=max_pairs - 1).to(torch.int32),
        # an overflowing tail is cut, never read out of bounds; overflow > 0 poisons the result
        row_count=torch.minimum(counts, torch.clamp(max_pairs - row_start, min=0)).to(torch.int32),
        col_ids=cols[:max_pairs],
        rank_mat=rank_mat,
        overflow=torch.clamp(counts.sum() - max_pairs, min=0),
    )


def chop_row_counts(xyz, rank_mat, row_count, box, cutoff: float):
    """Per-step list truncation: from the current sorted coordinates (Npad,
    3), drop every listed tile past the last one whose bounding-box gap is
    within the bare cutoff. Leading dimensions of xyz (..., Npad, 3),
    rank_mat, row_count and box (..., 3, 3) chop a batch of systems. Exact: a tile whose current gap exceeds the
    cutoff holds no pair within it. Padding slots duplicate atom 0, which
    only widens boxes.

    Each chunk's box is taken over its atoms at their images nearest the
    chunk's first atom, so an atom that crosses a box face between rebuilds
    does not stretch its chunk's box across the box (JAX's chop boxes the
    wrapped coordinates, where one such atom keeps every list that meets
    its chunk whole). Any images give a lower bound on each pair's
    distance, so the chop stays exact."""
    n_pad = xyz.shape[-2]
    box_diag = torch.diagonal(box, dim1=-2, dim2=-1).to(xyz.dtype)

    def boxes(size):
        x = xyz.reshape(*xyz.shape[:-2], n_pad // size, size, 3)
        diag = box_diag[..., None, None, :]
        x = x - diag * torch.round((x - x[..., :1, :]) / diag)
        return x.amin(-2), x.amax(-2)

    d2 = _bbox_gap2(*boxes(ROW), *boxes(COL), box_diag)
    keep_rank = torch.where(d2 < cutoff * cutoff, rank_mat, -1)
    return torch.minimum(row_count, keep_rank.amax(-1) + 1)


def suggest_max_pairs(
    conf, box, cutoff: float, margin: float = 1.3, cell_size: float = 0.65, triangular: bool = False,
    sort: str = "snake", atom_mask=None,
) -> int:
    """Host-side capacity: the listed (row chunk, column chunk) count at this
    geometry, times margin for diffusion between rebuilds."""
    n_pad = padded_size(conf.shape[0])
    cap = (n_pad // ROW) * (n_pad // COL)
    tiles = build_rowscan_tiles(conf, box, cutoff, cap, cell_size, triangular, sort, atom_mask)
    total = int(tiles.row_count.sum())
    want = int(np.ceil(total * margin / 128) * 128)
    return min(max(want, 128), cap)


def census_swept_slots(conf, box, cutoff: float, skin: float, cell_size: float) -> int:
    """Host-side per-step pair-slot count of the MD provider's triangular
    sweep at one sort-cell size: lists built at cutoff + skin (as at each
    rebuild), chopped at the bare cutoff (as every step does), plus each row
    chunk's covering tile (as JAX's census, without its padding of lists to
    fours)."""
    n_pad = padded_size(conf.shape[0])
    cap = (n_pad // ROW) * (n_pad // COL)
    tiles = build_rowscan_tiles(conf, box, cutoff + skin, cap, cell_size, triangular=True)
    box_diag = torch.diagonal(box).to(torch.float32)
    xyz = _wrap(conf[:, :3].to(torch.float32), box_diag)[tiles.pad_order]
    chopped = chop_row_counts(xyz, tiles.rank_mat, tiles.row_count, box.to(torch.float32), cutoff)
    return (int(chopped.sum()) + n_pad // ROW) * ROW * COL


def suggest_cell_size(conf, box, cutoff: float, skin: float = 0.1, candidates=(0.65, 0.9, 1.15, 1.4)) -> float:
    """The sort-cell size with the fewest swept pair slots per step. Any size
    is correct; candidates above box_min / 3 are skipped."""
    box_min = float(torch.diagonal(box).min())
    best, best_slots = candidates[0], None
    for cell in candidates:
        if cell > box_min / 3.0 and best_slots is not None:
            continue
        slots = census_swept_slots(conf, box, cutoff, skin, cell)
        if best_slots is None or slots < best_slots:
            best, best_slots = cell, slots
    return best


def param_rows(params, pad_order, n: int, atom_mask=None):
    """(Npad, 4) sorted rows [w, q, sigma/2, 2 sqrt(eps)]; padding slots,
    and atoms outside atom_mask (N,) bool where given, carry q = eps = 0 so
    their pairs vanish arithmetically. Leading dimensions of params (...,
    N, 4) and pad_order (..., Npad), which must match, give a batch."""
    valid = torch.arange(pad_order.shape[-1], device=params.device) < n
    if atom_mask is not None:
        valid = valid & atom_mask[pad_order]
    valid = valid.to(params.dtype)
    pr = torch.take_along_dim(params, pad_order[..., None], dim=-2)
    return torch.stack([pr[..., 3], pr[..., 0] * valid, pr[..., 1], 2.0 * pr[..., 2] * valid], dim=-1)


def param_rows_of(atom_mask=None):
    """The list providers' prows_fn: (params (..., N, 4), pad_order (...,
    Npad)) -> param_rows under atom_mask."""
    return lambda params, pad_order: param_rows(params, pad_order, params.shape[-2], atom_mask)


def assemble_atoms(conf, box, pad_order, prows):
    """(Npad, 8) sweep rows [x y z w q sigma/2 2 sqrt(eps) 0], coordinates
    wrapped into the box and sorted. Leading dimensions of conf (..., N, 3),
    box (..., 3, 3), pad_order and prows give a batch."""
    box_diag = torch.diagonal(box, dim1=-2, dim2=-1)[..., None, :]
    xyz = torch.take_along_dim(_wrap(conf[..., :3], box_diag), pad_order[..., None], dim=-2)
    return torch.cat([xyz, prows, prows.new_zeros((*prows.shape[:-1], 1))], dim=-1)


def sweep_scalars(box, cutoff: float):
    """(..., 4) [box_x, box_y, box_z, cutoff] of box (..., 3, 3) on its
    device, without a host copy."""
    return F.pad(torch.diagonal(box, dim1=-2, dim2=-1), (0, 1), value=cutoff)


def pair_terms(d, dw, qq, sg, e4, cut2, listed, series, mode: int):
    """(dU/dr / r, pair energy) of the sweeps' pair function on pair
    tensors: d the three imaged coordinate differences, dw the w offset
    difference (None: no w lift), qq, sg = sigma_i/2 + sigma_j/2 and e4 =
    4 eps_ij the pair parameters, `listed` a mask of the slots that hold a
    pair. Both terms are zero outside the gate (r^2 < cut2) & (r^2 > 1e-7) &
    listed; de_r is None in ENERGY mode and e None in FORCE mode."""
    h_coeffs, p_coeffs = series
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    if dw is not None:
        r2 = r2 + dw * dw
    r2s = torch.clamp(r2, min=1e-8)
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    s2 = sg * sg * inv_r2
    t6 = s2 * s2 * s2
    et6 = e4 * t6  # before t6^2: e4 = 0 zeroes padding pairs that sit at r2 = 1e-8
    t = _K1 * (r2s * inv_r) - 1.0
    gate = (r2 < cut2) & (r2 > 1e-7) & listed
    de_r = e = None
    if mode != ENERGY:
        de_r = torch.where(gate, (et6 * (6.0 - 12.0 * t6) + qq * polyval_t(t, p_coeffs) * inv_r) * inv_r2, 0.0)
    if mode != FORCE:
        e = torch.where(gate, et6 * (t6 - 1.0) + qq * polyval_t(t, h_coeffs) * inv_r, 0.0)
    return de_r, e


def _row_frame(rows, cen, box, inv_box):
    """Row atoms (8, b, ROW) -> [x' y' z' w], each (b, ROW), at the image nearest their chunk's center cen (b, 3)."""
    out = []
    for a in range(3):
        raw = rows[a] - cen[:, a, None]
        out.append(raw - box[a] * torch.round(raw * inv_box[a]))
    return out + [rows[3]]


def _col_frame(cols, cen, box, inv_box):
    """Column atoms (8, b, L, COL) -> [x' y' z' w], each (b, L, COL), at the image nearest their row chunk's center."""
    out = []
    for a in range(3):
        c = cen[:, a, None, None]
        out.append((cols[a] - c) + box[a] * torch.round(c * inv_box[a] - cols[a] * inv_box[a]))
    return out + [cols[3]]


def rowscan_sweep_plain(
    atoms, row_start, row_count, col_ids, scalars, series, mode: int, triangular: bool = False, rcen_q=None,
    has_w: bool = True, row_base: int = 0, n_rows_local=None,
):
    """The sweep in plain PyTorch, in atoms' dtype: each batch of row chunks
    gathers its tiles (in triangular form the covering chunk first) into
    (rows, L, 32, 128) pair blocks, one tensor per coordinate, masked by
    row_count, with L the batch's longest list. A batch holds at most about
    2^18 pair slots on the CPU (cache-sized temporaries) and 2^24 on a card.
    Returns (Npad, 4) [u_i, dU/dx_i] like the kernel; the triangular form's
    column reactions are scattered with index_add_. With n_rows_local it
    sweeps the slab of row chunks [row_base, row_base + n_rows_local) of the
    whole lists: the other rows' sums are zero, column reactions land
    wherever their atoms are."""
    rowscan_sweep_plain.calls += 1
    dev, dt = atoms.device, atoms.dtype
    block_pairs = 1 << 18 if dev.type == "cpu" else 1 << 24
    n_pad = atoms.shape[0]
    n_rows, n_cols = n_pad // ROW, n_pad // COL
    row_end = n_rows if n_rows_local is None else row_base + n_rows_local
    out = atoms.new_zeros((n_pad, 4))
    react = atoms.new_zeros((n_pad, 3)) if triangular and mode != ENERGY else None
    counts_t = row_count.long() + int(triangular)
    counts = counts_t.tolist()
    batch = max(1, block_pairs // (max(max(counts[row_base:row_end], default=0), 1) * ROW * COL))
    comp = atoms.T.contiguous()  # one contiguous row per column of the atom rows
    rows_all = comp.view(8, n_rows, ROW)
    cols_all = comp.view(8, n_cols, COL)
    box = scalars[:3]
    inv_box = 1.0 / box
    cut2 = scalars[3] * scalars[3]
    cen_all = None if rcen_q is None else rcen_q.view(n_rows, 4)[:, :3].to(dt) * CEN_SCALE
    row_ids = torch.arange(n_rows, device=dev)
    lane_r = torch.arange(ROW, device=dev)
    lane_c = torch.arange(COL, device=dev)
    for r0 in range(row_base, row_end, batch):
        r1 = min(r0 + batch, row_end)
        length = max(counts[r0:r1])
        if length == 0:
            continue
        k = torch.arange(length, device=dev)
        listed = k < counts_t[r0:r1, None]  # (b, L)
        if triangular:
            covering = torch.clamp(row_ids[r0:r1] * ROW // COL, max=n_cols - 1)
            slot = torch.where(listed & (k > 0), row_start[r0:r1, None] + k - 1, 0)
            cid = torch.where(k == 0, covering[:, None], col_ids[slot].long())
        else:
            slot = torch.where(listed, row_start[r0:r1, None] + k, 0)
            cid = col_ids[slot].long()
        rows = rows_all[:, r0:r1]  # (8, b, ROW)
        cols = cols_all[:, cid]  # (8, b, L, COL)
        if cen_all is None:
            d = [rows[a][:, None, :, None] - cols[a][:, :, None, :] for a in range(3)]  # each (b, L, ROW, COL)
            d = [da - box[a] * torch.round(da * inv_box[a]) for a, da in enumerate(d)]
        else:
            cen = cen_all[r0:r1]
            rd, cd = _row_frame(rows, cen, box, inv_box), _col_frame(cols, cen, box, inv_box)
            d = [rd[a][:, None, :, None] - cd[a][:, :, None, :] for a in range(3)]
        dw = rows[3][:, None, :, None] - cols[3][:, :, None, :] if has_w else None
        keep = listed[:, :, None, None]
        if triangular:
            row_gid = (row_ids[r0:r1, None] * ROW + lane_r)[:, None, :, None]
            keep = keep & (row_gid < (cid[:, :, None] * COL + lane_c)[:, :, None, :])
        qq = rows[4][:, None, :, None] * cols[4][:, :, None, :]
        sg = rows[5][:, None, :, None] + cols[5][:, :, None, :]
        e4 = rows[6][:, None, :, None] * cols[6][:, :, None, :]
        de_r, e = pair_terms(d, dw, qq, sg, e4, cut2, keep, series, mode)
        sl = slice(r0 * ROW, r1 * ROW)
        if mode != ENERGY:
            for a in range(3):
                out[sl, 1 + a] = (de_r * d[a]).sum((1, 3)).reshape(-1)
            if react is not None:
                parts = torch.stack([-(de_r * d[a]).sum(2) for a in range(3)], -1)  # (b, L, COL, 3)
                react.index_add_(0, (cid[:, :, None] * COL + lane_c).reshape(-1), parts.reshape(-1, 3))
        if mode != FORCE:
            u = e.sum((1, 3))
            out[sl, 0] = (u if triangular else 0.5 * u).reshape(-1)
    if react is not None:
        out[:, 1:4] += react
    return out


rowscan_sweep_plain.calls = 0

_series_args: dict = {}


def _launcher():
    fn = _build.load_library("rowscan").rowscan_sweep_slab_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _store_launcher():
    fn = _build.load_library("rowscan").rowscan_store_checked_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def series_args(series):
    """The (h, P) coefficient tuples as ctypes float arrays, made once per series."""
    if series not in _series_args:
        _series_args[series] = tuple((ctypes.c_float * len(c))(*c) for c in series)
    return _series_args[series]


def check_tensor(name, t, dtype, device, shape=None):
    """Raise ValueError unless t is a contiguous `dtype` tensor on `device` (of `shape`)."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on {device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: want shape {shape}, got {tuple(t.shape)}")


def check_slab(n_rows: int, row_base: int, n_rows_local):
    """Raise ValueError unless [row_base, row_base + n_rows_local) is a
    nonempty slab of the n_rows row chunks (n_rows_local None: the whole)."""
    if n_rows_local is None:
        if row_base != 0:
            raise ValueError(f"rowscan_sweep: row_base {row_base} without n_rows_local")
        return
    if not (0 <= row_base and 1 <= n_rows_local and row_base + n_rows_local <= n_rows):
        raise ValueError(f"rowscan_sweep: slab [{row_base}, {row_base} + {n_rows_local}) is not within {n_rows} row chunks")


def rowscan_sweep(
    atoms, row_start, row_count, col_ids, scalars, series, mode: int, triangular: bool = False, rcen_q=None,
    has_w: bool = True, row_base: int = 0, n_rows_local=None, reduce=None,
):
    """(Npad, 4) [u_i, dU/dx_i] of the sweep over the listed tiles.

    atoms (Npad, 8) f32 sorted rows, row_start/row_count (nR,) and col_ids
    (max_pairs,) int32, scalars (4,) f32 [bx by bz cutoff], series the (h, P)
    coefficient tuples of es_energy_force_series, mode FORCE, FORCE_ENERGY
    or ENERGY (unused columns are zero); lists symmetric or triangular,
    rcen_q (nR * 4,) int32 row centers for preshift (None: minimum image),
    has_w False to leave w out of r^2. A CUDA tensor launches the kernel of
    csrc/rowscan.cu on the current stream, in triangular form with an int64
    fixed-point scratch for the sums (NaN wherever a sum leaves its range).
    The kernel is built for the forms a configuration launches: triangular
    F and U in every form, triangular F+U with minimum image and w,
    symmetric F with minimum image and w; any other form raises
    RuntimeError (CUDA error 1). A CPU tensor runs rowscan_sweep_plain, in
    every form.

    n_rows_local sweeps the slab of row chunks [row_base, row_base +
    n_rows_local) of the whole lists and atoms: the rows outside it come
    back zero but for the triangular form's column reactions, and a slab
    outside the row chunks raises ValueError before any launch. reduce, where
    given, is applied in place to the partial sums before they are stored
    (an all-reduce over the ranks of a mesh, rowscan_sweep_sharded): on the
    card the triangular form's int64 accumulator, flag included, so that
    the stored slabs are bitwise the whole launch; elsewhere the output."""
    if atoms.device.type == "cpu":
        check_slab(atoms.shape[0] // ROW, row_base, n_rows_local)
        out = rowscan_sweep_plain(
            atoms, row_start, row_count, col_ids, scalars, series, mode, triangular, rcen_q, has_w, row_base, n_rows_local
        )
        if reduce is not None:
            reduce(out)
        return out
    if atoms.device.type != "cuda":
        raise ValueError(f"rowscan_sweep: no kernel for device {atoms.device}")
    if mode not in (FORCE, FORCE_ENERGY, ENERGY):
        raise ValueError(f"rowscan_sweep: unknown mode {mode}")
    dev = atoms.device
    n_pad = atoms.shape[0]
    if n_pad % COL:
        raise ValueError(f"rowscan_sweep: {n_pad} atom rows is not a multiple of {COL}")
    n_rows = n_pad // ROW
    check_slab(n_rows, row_base, n_rows_local)
    check_tensor("atoms", atoms, torch.float32, dev, (n_pad, 8))
    check_tensor("row_start", row_start, torch.int32, dev, (n_rows,))
    check_tensor("row_count", row_count, torch.int32, dev, (n_rows,))
    check_tensor("col_ids", col_ids, torch.int32, dev)
    check_tensor("scalars", scalars, torch.float32, dev, (4,))
    if rcen_q is not None:
        check_tensor("rcen_q", rcen_q, torch.int32, dev, (4 * n_rows,))
    slab = n_rows_local is not None
    h_arg, p_arg = series_args(series)
    # a symmetric slab writes its own rows only
    out = (torch.zeros if slab and not triangular else torch.empty)((n_pad, 4), dtype=torch.float32, device=dev)
    acc = torch.zeros((4 * n_pad + 1) if triangular else 0, dtype=torch.int64, device=dev)  # the sums, then the flag
    store_later = triangular and reduce is not None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(
        atoms.data_ptr(), row_start.data_ptr(), row_count.data_ptr(), col_ids.data_ptr(),
        None if rcen_q is None else rcen_q.data_ptr(), scalars.data_ptr(), out.data_ptr(), acc.data_ptr(), n_rows,
        row_base, n_rows if n_rows_local is None else n_rows_local, mode, int(triangular), int(rcen_q is not None),
        int(has_w), int(not store_later), h_arg, p_arg, stream,
    )
    if rc != 0:
        raise RuntimeError(f"rowscan_sweep: kernel launch failed with CUDA error {rc}")
    rowscan_sweep.launches += 1
    rowscan_sweep.launches_by_form[mode, bool(triangular), rcen_q is not None, bool(has_w)] += 1
    rowscan_sweep.launches_slabs += int(slab)
    if reduce is not None:
        reduce(acc if store_later else out)
    return rowscan_store_checked(acc, out) if store_later else out


def rowscan_store_checked(acc, out=None):
    """(Npad, 4) f32 [u_i, dU/dx_i] of a triangular sweep's int64
    accumulator acc (4 Npad + 1,) on the card (the sums, then the flag), as
    the launch's own store converts it: NaN everywhere if the flag is up,
    NaN for a sum past the fixed-point range. out, where given, is written."""
    n_pad = (acc.shape[0] - 1) // 4
    check_tensor("acc", acc, torch.int64, acc.device, (4 * n_pad + 1,))
    if out is None:
        out = torch.empty((n_pad, 4), dtype=torch.float32, device=acc.device)
    rc = _store_launcher()(out.data_ptr(), acc.data_ptr(), n_pad, torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rowscan_store_checked: store failed with CUDA error {rc}")
    return out


rowscan_sweep.launches = 0
rowscan_sweep.launches_by_form = Counter()  # (mode, triangular, preshift, has_w) -> launches
rowscan_sweep.launches_slabs = 0  # launches given n_rows_local, counted in the two above as well


def rowscan_sweep_sharded(
    atoms, row_start, row_count, col_ids, scalars, series, mode: int, mesh, axis_name: str = "rows",
    triangular: bool = False, rcen_q=None, has_w: bool = True,
):
    """rowscan_sweep over a mesh (counterpart of JAX's rowscan_sweep_sharded):
    the n_rows row chunks of whole lists are cut into one contiguous slab a
    rank (rank r sweeps [r L, (r + 1) L), L = n_rows / ranks; atoms and
    lists are whole on every rank, as JAX replicates its columns), and one
    all-reduce over the mesh's `axis_name` sums the slabs before the store:
    on the card the int64 accumulator of the triangular form (its column
    reactions and flag too), which gives the whole launch bitwise; the
    symmetric form's rows, which are zero outside their slab; on the CPU the
    plain slabs' outputs. Every rank returns the whole (Npad, 4) output.
    mesh None sweeps everything locally. n_rows must divide over the
    ranks, as in JAX."""
    if mesh is None:
        return rowscan_sweep(atoms, row_start, row_count, col_ids, scalars, series, mode, triangular, rcen_q, has_w)
    n_rows = atoms.shape[0] // ROW
    ranks, rank = mesh_ops.mesh_size(mesh, axis_name), mesh_ops.mesh_rank(mesh, axis_name)
    if n_rows % ranks:
        raise ValueError(f"rowscan_sweep_sharded: {n_rows} row chunks do not divide over {ranks} ranks")
    local = n_rows // ranks
    return rowscan_sweep(
        atoms, row_start, row_count, col_ids, scalars, series, mode, triangular, rcen_q, has_w, rank * local, local,
        lambda t: mesh_ops.all_reduce_sum(t, mesh, axis_name),
    )


def rowscan_sweep_batched_plain(atoms, row_start, row_count, col_ids, list_of_system, scalars, series, mode: int,
                                has_w: bool = True):
    """rowscan_sweep_batched in plain PyTorch: rowscan_sweep_plain of each
    system in the masked form (triangular, minimum image), stacked."""
    rowscan_sweep_batched_plain.calls += 1
    return torch.stack([
        rowscan_sweep_plain(atoms[b], row_start[k], row_count[k], col_ids[k], scalars[b], series, mode, True, None, has_w)
        for b, k in enumerate(list_of_system.tolist())
    ])


rowscan_sweep_batched_plain.calls = 0


def _batched_launcher():
    fn = _build.load_library("rowscan").rowscan_sweep_batched_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rowscan_sweep_batched(atoms, row_start, row_count, col_ids, list_of_system, scalars, series, mode: int,
                          has_w: bool = True):
    """(B, Npad, 4) [u_i, dU/dx_i] of B systems in one sweep, in the masked
    form (Newton-triangular lists, minimum image; with w unless has_w is
    False), mode FORCE or ENERGY.

    atoms (B, Npad, 8) f32 and scalars (B, 4) f32 are each system's own;
    the lists row_start/row_count (L, nR) and col_ids (L, max_pairs) int32
    hold L replicas' lists, and list_of_system (B,) int32, each in [0, L),
    names the lists each system sweeps (several parameter sets of one
    replica share its lists). A CUDA tensor launches the kernel of
    csrc/rowscan.cu once for all B systems on the current stream (each
    system's output bitwise its rowscan_sweep launch, NaN past the
    fixed-point range per system); a CPU tensor runs
    rowscan_sweep_batched_plain."""
    if atoms.device.type == "cpu":
        return rowscan_sweep_batched_plain(atoms, row_start, row_count, col_ids, list_of_system, scalars, series, mode, has_w)
    if atoms.device.type != "cuda":
        raise ValueError(f"rowscan_sweep_batched: no kernel for device {atoms.device}")
    if mode not in (FORCE, ENERGY):
        raise ValueError(f"rowscan_sweep_batched: mode must be FORCE or ENERGY, got {mode}")
    dev = atoms.device
    if atoms.dim() != 3 or atoms.shape[1] % COL:
        raise ValueError(f"rowscan_sweep_batched: atoms must be (B, Npad, 8) with Npad a multiple of {COL}")
    n_sys, n_pad = atoms.shape[:2]
    n_rows = n_pad // ROW
    n_lists = row_start.shape[0]
    check_tensor("atoms", atoms, torch.float32, dev, (n_sys, n_pad, 8))
    check_tensor("row_start", row_start, torch.int32, dev, (n_lists, n_rows))
    check_tensor("row_count", row_count, torch.int32, dev, (n_lists, n_rows))
    check_tensor("col_ids", col_ids, torch.int32, dev)
    if col_ids.dim() != 2 or col_ids.shape[0] != n_lists:
        raise ValueError(f"col_ids: want ({n_lists}, max_pairs), got {tuple(col_ids.shape)}")
    check_tensor("list_of_system", list_of_system, torch.int32, dev, (n_sys,))
    check_tensor("scalars", scalars, torch.float32, dev, (n_sys, 4))
    h_arg, p_arg = series_args(series)
    out = torch.empty((n_sys, n_pad, 4), dtype=torch.float32, device=dev)
    acc = torch.zeros(n_sys * (4 * n_pad + 1), dtype=torch.int64, device=dev)  # a system's sums, then its flag
    rc = _batched_launcher()(
        atoms.data_ptr(), row_start.data_ptr(), row_count.data_ptr(), col_ids.data_ptr(), list_of_system.data_ptr(),
        scalars.data_ptr(), out.data_ptr(), acc.data_ptr(), n_rows, n_sys, col_ids.shape[1], mode, int(has_w),
        h_arg, p_arg, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"rowscan_sweep_batched: kernel launch failed with CUDA error {rc}")
    rowscan_sweep_batched.launches += 1
    rowscan_sweep_batched.launches_by_form[mode, bool(has_w)] += 1
    return out


rowscan_sweep_batched.launches = 0
rowscan_sweep_batched.launches_by_form = Counter()  # (mode, has_w) -> launches


def _md_build(cutoff: float, max_pairs: int, skin: float, cell_size: float, preshift: bool, has_w: bool, atom_mask):
    """The rowscan MD providers' build(conf, params, box) -> ListState."""

    def build(conf, params, box):
        if preshift:
            from timemachine_torch.ops.dotscan_kernel import build_dotscan_tiles  # dotscan imports this module

            tiles = build_dotscan_tiles(conf, box, cutoff + skin, max_pairs, cell_size, triangular=True)
            invalid = tiles.invalid
        else:
            tiles = build_rowscan_tiles(
                conf, box, cutoff + skin, max_pairs, cell_size, triangular=True, atom_mask=atom_mask
            )
            invalid = tiles.overflow
        if not has_w:
            invalid = invalid + (params[:, 3] != 0).any().to(invalid.dtype)
        n = conf.shape[0]
        prows = param_rows(params.to(conf.dtype), tiles.pad_order, n, atom_mask)
        return ListState(tiles, torch.argsort(tiles.pad_order[:n]), prows, invalid)

    return build


def make_nonbonded_rowscan_md(
    beta: float, cutoff: float, max_pairs: int, skin: float = 0.1, rebuild_interval: int = 20,
    cell_size: float = 0.65, preshift: bool = False, has_w: bool = True, atom_mask=None,
):
    """MD force provider over Newton-triangular rowscan tiles (counterpart
    of JAX's make_nonbonded_rowscan_md with its default triangular=True),
    chopped to the bare cutoff at every sweep: an F sweep per step, a U
    sweep for the energy, and the energy under other parameters through the
    same lists; see nonbonded_kernel.make_list_md_provider. Size max_pairs
    with suggest_max_pairs at cutoff + skin, triangular, at the same cell
    size.

    preshift takes the lists and row centers from build_dotscan_tiles, which
    rechecks the image bound at every rebuild; configure it only where
    dotscan_valid holds. has_w=False is the caller's promise that every w
    offset is zero. The result is NaN on overflow, where a rebuild breaks
    the image bound, and where a rebuild finds a nonzero w without has_w.
    atom_mask (N,) bool restricts the term to a subset of the atoms, as
    build_rowscan_tiles and param_rows take it; it excludes preshift, as in
    JAX's configuration."""
    if preshift and atom_mask is not None:
        raise ValueError("make_nonbonded_rowscan_md: preshift takes no atom subset")
    sweep_atoms = _md_sweep(beta, cutoff, preshift, has_w)

    def sweep(state, conf, box, mode):
        return sweep_atoms(state, assemble_atoms(conf, box, state.lists.pad_order, state.prows), box, mode)

    build = _md_build(cutoff, max_pairs, skin, cell_size, preshift, has_w, atom_mask)
    return make_list_md_provider(build, sweep, FORCE, ENERGY, rebuild_interval, prows_fn=param_rows_of(atom_mask))


def _md_sweep(beta: float, cutoff: float, preshift: bool, has_w: bool):
    """sweep_atoms(state, atoms, box, mode) -> (Npad, 4): the MD providers'
    chop and launch on sorted sweep rows `atoms` (Npad, 8)."""
    series = es_energy_force_series(beta, cutoff)

    def sweep_atoms(state, atoms, box, mode):
        t = state.lists
        row_count = chop_row_counts(atoms[:, :3], t.rank_mat, t.row_count, box, cutoff)
        return rowscan_sweep(
            atoms, t.row_start, row_count, t.col_ids, sweep_scalars(box, cutoff), series, mode, True,
            t.rcen_q if preshift else None, has_w,
        )

    return sweep_atoms


class SortedSweepProtocol(NamedTuple):
    """The sorted-state step's view of a rowscan MD provider (JAX's protocol
    of this name): `sweep(state, x_sorted, box, mode)` runs the provider's
    sweep on coordinates already in the state's pad order; `pad_order(state)`
    and `inv(state)` give the state's permutation (pad slot -> atom, atom ->
    slot), so that the Context owns the round trips; `rebuild_interval` is
    the provider's rebuild period."""

    sweep: object
    pad_order: object
    inv: object
    rebuild_interval: int


def make_rowscan_sorted_protocol(
    beta: float, cutoff: float, rebuild_interval: int = 20, preshift: bool = False, has_w: bool = True,
) -> SortedSweepProtocol:
    """The SortedSweepProtocol of make_nonbonded_rowscan_md's provider of the
    same settings (every rowscan form: the main form with preshift and no w,
    the masked form with minimum image and w). Its sweep wraps the
    pad-ordered coordinates (Npad, 3) into the box, joins the state's
    parameter rows and launches the same csrc/rowscan.cu kernel as the
    provider's apply, with no gather: it returns the (Npad, 4) output [u_i,
    dU/dx_i] in pad order, NaN where the state is invalid. The wrap is
    elementwise, so on x[pad_order] it gives the apply's rows bitwise."""
    sweep_atoms = _md_sweep(beta, cutoff, preshift, has_w)

    def sweep_sorted(state, x_sorted, box, mode: int = FORCE):
        box_diag = torch.diagonal(box, dim1=-2, dim2=-1)[..., None, :]
        prows = state.prows
        atoms = torch.cat([_wrap(x_sorted[:, :3], box_diag), prows, prows.new_zeros((prows.shape[0], 1))], dim=-1)
        return poison_on_overflow(state.invalid, sweep_atoms(state, atoms, box, mode))

    return SortedSweepProtocol(
        sweep=sweep_sorted, pad_order=lambda state: state.lists.pad_order, inv=lambda state: state.inv,
        rebuild_interval=rebuild_interval,
    )


def batched_sweep_inputs(lists, xs, prows, boxes, lists_of, cutoff: float):
    """rowscan_sweep_batched's inputs up to the series: (atoms, row_start,
    row_count, col_ids, list_of_system, scalars) of B systems from K
    replicas' stacked lists (RowscanTiles, each field (K, ...)), their
    coordinates xs (K, N, 3) and boxes (K, 3, 3), the systems' parameter
    rows prows (B, Npad, 4) and the replica each reads, lists_of (B,).
    Every replica's tiles are chopped once, at its own coordinates."""
    box_diag = torch.diagonal(boxes, dim1=-2, dim2=-1)[..., None, :]
    xyz = torch.take_along_dim(_wrap(xs[..., :3], box_diag), lists.pad_order[..., None], dim=-2)
    row_count = chop_row_counts(xyz, lists.rank_mat, lists.row_count, boxes, cutoff)
    if prows.shape[0] != xs.shape[0]:  # several parameter sets a replica: each system reads its replica's rows
        idx = lists_of.long()
        xyz, boxes = xyz[idx], boxes[idx]
    atoms = torch.cat([xyz, prows, prows.new_zeros((*prows.shape[:-1], 1))], dim=-1)
    return atoms, lists.row_start, row_count, lists.col_ids, lists_of, sweep_scalars(boxes, cutoff)


def make_nonbonded_rowscan_md_batched(
    beta: float, cutoff: float, max_pairs: int, skin: float = 0.1, rebuild_interval: int = 20,
    cell_size: float = 0.65, has_w: bool = True, atom_mask=None,
):
    """make_nonbonded_rowscan_md for K replicas of one system stepped
    together, in the masked form (triangular, minimum image; the RBFE host
    term's): each replica's lists are built as the single provider builds
    them and stacked at max_pairs (a rebuild loops over the replicas); a
    step assembles and chops every replica's tiles at once and runs one
    rowscan_sweep_batched launch, F for the forces, U for the energies (K
    systems, or K * S for S parameter sets a replica); see
    nonbonded_kernel.make_batched_list_md_provider. Each replica's result
    is bitwise the single provider's sweep; a replica whose lists overflow
    gets NaN alone."""
    series = es_energy_force_series(beta, cutoff)

    def sweep_batched(state, xs, prows, boxes, lists_of, mode):
        args = batched_sweep_inputs(state.lists, xs, prows, boxes, lists_of, cutoff)
        return rowscan_sweep_batched(*args, series, mode, has_w)

    build = _md_build(cutoff, max_pairs, skin, cell_size, False, has_w, atom_mask)
    return make_batched_list_md_provider(build, sweep_batched, param_rows_of(atom_mask), FORCE, ENERGY, rebuild_interval)


def make_nonbonded_rowscan_energy_force(
    beta: float, cutoff: float, max_pairs: int, cell_size: float = 0.65, atom_mask=None,
):
    """(conf, params, box, mode=FORCE_ENERGY, energy_dtype=None) -> (u,
    force) in one sweep over Newton-triangular lists built for this call at
    the bare cutoff, as in JAX (use the MD provider in a step loop); size
    max_pairs with suggest_max_pairs, triangular. With mode=ENERGY the force
    is zero. energy_dtype sums the per-atom energies in that dtype (None:
    the sweep's). atom_mask (N,) bool restricts the term to a subset of the
    atoms."""
    series = es_energy_force_series(beta, cutoff)

    def energy_force(conf, params, box, mode: int = FORCE_ENERGY, energy_dtype=None):
        tiles = build_rowscan_tiles(conf, box, cutoff, max_pairs, cell_size, triangular=True, atom_mask=atom_mask)
        n = conf.shape[0]
        prows = param_rows(params.to(conf.dtype), tiles.pad_order, n, atom_mask)
        atoms = assemble_atoms(conf, box, tiles.pad_order, prows)
        out = rowscan_sweep(
            atoms, tiles.row_start, tiles.row_count, tiles.col_ids, sweep_scalars(box, cutoff), series, mode, True
        )
        force = -out[torch.argsort(tiles.pad_order[:n]), 1:4]
        u = torch.sum(out[:, 0], dtype=energy_dtype)
        return poison_on_overflow(tiles.overflow, u), poison_on_overflow(tiles.overflow, force)

    return energy_force


def make_nonbonded_rowscan(
    beta: float, cutoff: float, max_pairs: int, dp_max_tiles: int, dp_cb: int = 2, atom_mask=None,
):
    """Differentiable energy(conf, params, box): the forward runs one F+U
    sweep over lists built for the call and stashes dU/dx; dU/dp comes from
    the block-tile kernel's DP pass (exact electrostatics, as in the JAX
    package's custom VJP) over lists of dp_max_tiles at dp_cb. Under
    atom_mask (N,) bool both passes see only the subset: atoms outside it
    get zero dU/dx and zero dU/dp."""
    ef = make_nonbonded_rowscan_energy_force(beta, cutoff, max_pairs, atom_mask=atom_mask)

    def energy_grad(conf, params, box):
        u, force = ef(conf, params, box)
        return u, -force

    def dp(conf, params, box):
        return run_dp(conf, params, box, beta, cutoff, dp_max_tiles, cb=dp_cb, atom_mask=atom_mask)

    def energy(conf, params, box):
        return StashedGradEnergy.apply(conf, params, box, energy_grad, dp)

    return energy
