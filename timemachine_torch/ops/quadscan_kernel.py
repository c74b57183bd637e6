"""Quadscan pair sweep: the rowscan pair function over 32 x 32-culled
Newton-triangular tiles with per-entry image shifts (counterpart of
timemachine_tpu/ops/pallas/quadscan_kernel.py, the MD provider of the
`kernel="quad"` configuration).

Atoms are sorted along a Hilbert curve and cut into 32-atom chunks, which
serve both as row chunks and as column quarters. Row chunk r lists the
quarters c >= r whose bounding boxes come within the list cutoff, its own
first, in ascending order, packed four to a tile as the JAX builder packs
them (padding entries point at the all-padding last quarter). Each entry
encodes its quarter id in bits 0-11 and, in bits 12-17, the image shift to
ADD to the quarter's coordinates, two bits per axis holding shift + 1.
That one shift is right for every pair of the entry as long as

    (two largest chunk half-extents) + cutoff < box / 2   on every axis,

which `shift_margin` measures; the builder rechecks it at every rebuild and
the providers poison their result with NaN where it fails (ROADMAP R5).

Each pair is visited once: the row atom gets its energy (row-side u) and
gradient, the column atom the reaction. `quadscan_sweep` launches the
hand-written CUDA kernel (`csrc/quadscan.cu`) on CUDA tensors and uses
`quadscan_sweep_plain`, the same function in plain PyTorch, on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from timemachine_torch.ops import _build
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.ops.nonbonded_kernel import ListState, hilbert_order, make_list_md_provider

Q = 32  # atoms per row chunk and per column quarter
PACK = 4  # quarters per listed tile
SHIFT_BITS = 12  # quarter ids in bits 0-11, image shifts in bits 12-17
FORCE, FORCE_ENERGY = rs.FORCE, rs.FORCE_ENERGY  # sweep modes, as in csrc/quadscan.cu

padded_size = rs.padded_size  # whole 128-atom blocks plus one all-padding block


def _sorted_chunks(conf, box):
    """(wrapped f32 coordinates, Hilbert pad_order (Npad,), (nQ, 32) valid mask)."""
    n = conf.shape[0]
    n_pad = padded_size(n)
    box_diag = torch.diagonal(box).to(torch.float32)
    x32 = conf[:, :3].to(torch.float32)
    wrapped = x32 - box_diag * torch.floor(x32 / box_diag)
    order = hilbert_order(wrapped, box_diag)
    pad_order = torch.cat([order, order.new_zeros(n_pad - n)])
    valid = (torch.arange(n_pad, device=conf.device) < n).view(n_pad // Q, Q, 1)
    return wrapped, pad_order, valid


def shift_margin(xq, valid, box_diag, cutoff: float):
    """min over axes of box/2 - (two largest chunk half-extents + cutoff),
    as a () tensor: the constant-shift invariant holds where it is > 0.
    xq (nQ, 32, 3) sorted coordinates, valid (nQ, 32, 1)."""
    qmin = torch.where(valid, xq, 1e9).amin(1)
    qmax = torch.where(valid, xq, -1e9).amax(1)
    half = torch.clamp(0.5 * (qmax - qmin), min=0.0)  # empty quarters: 0
    top2 = torch.topk(half, 2, dim=0).values.sum(0)
    return torch.min(0.5 * box_diag - (top2 + cutoff))


def constant_shift_margin(conf, box, cutoff: float) -> float:
    """Host-side margin of the constant-shift invariant at this geometry
    (nm): the smallest slack on any axis; valid where > 0."""
    wrapped, pad_order, valid = _sorted_chunks(conf, box)
    xq = wrapped[pad_order].view(-1, Q, 3)
    return float(shift_margin(xq, valid, torch.diagonal(box).to(torch.float32), cutoff))


def constant_shift_valid(conf, box, cutoff: float) -> bool:
    """Whether one image shift per (row chunk, quarter) entry is right for
    every pair within `cutoff`; `configure(kernel="quad")` falls back to
    rowscan where it is not (small boxes)."""
    return constant_shift_margin(conf, box, cutoff) > 0


class QuadTiles(NamedTuple):
    pad_order: torch.Tensor  # (Npad,) int64: sorted slot -> atom (padding slots -> atom 0)
    row_start: torch.Tensor  # (nR,) int32: first tile of each row chunk
    row_count: torch.Tensor  # (nR,) int32: tiles (of PACK entries) of each row chunk
    entries: torch.Tensor  # (max_tiles * PACK,) int32: quarter id | (shift + 1) << SHIFT_BITS per axis
    overflow: torch.Tensor  # () int64: tiles that did not fit in max_tiles
    margin: torch.Tensor  # () f32: shift_margin of this build; <= 0 poisons the result


def _code(cid, sx, sy, sz):
    return cid + ((sx + 1) << SHIFT_BITS) + ((sy + 1) << (SHIFT_BITS + 2)) + ((sz + 1) << (SHIFT_BITS + 4))


def build_quadscan_tiles(conf, box, cutoff: float, max_tiles: int) -> QuadTiles:
    """Hilbert sort, 32-atom chunk bounding boxes, and per row chunk r the
    quarters c >= r within `cutoff` by minimum-image box gap, with the image
    shift of the chunk centres, packed PACK to a tile (JAX's list layout,
    entry for entry). Runs in f32 whatever conf's dtype."""
    dev = conf.device
    wrapped, pad_order, valid = _sorted_chunks(conf, box)
    n_q = pad_order.shape[0] // Q
    box_diag = torch.diagonal(box).to(torch.float32)
    xq = wrapped[pad_order].view(n_q, Q, 3)
    qmin = torch.where(valid, xq, 1e9).amin(1)
    qmax = torch.where(valid, xq, -1e9).amax(1)
    qcen, qhal = 0.5 * (qmin + qmax), 0.5 * (qmax - qmin)
    q_has = valid.view(n_q, Q).any(1)

    dc = qcen[:, None, :] - qcen[None, :, :]
    shift = -torch.floor(dc / box_diag + 0.5)  # integer images in {-1, 0, 1}
    gap = torch.clamp(torch.abs(dc + shift * box_diag) - (qhal[:, None, :] + qhal[None, :, :]), min=0.0)
    d2 = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] + gap[..., 2] * gap[..., 2]
    ids = torch.arange(n_q, device=dev)
    inter = (d2 < cutoff * cutoff) & q_has[:, None] & q_has[None, :] & (ids[None, :] >= ids[:, None])
    neg = (-shift).to(torch.int64)  # the stored shift is added to the column coordinates
    codes = _code(ids[None, :], neg[..., 0], neg[..., 1], neg[..., 2])

    counts = inter.sum(1)
    tile_count = -(-counts // PACK)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    cap = max_tiles * PACK
    target = tile_start[:, None] * PACK + torch.cumsum(inter, dim=1) - 1
    target = torch.where(inter & (target < cap), target, cap)  # slot `cap`: dump
    zero_code = _code(n_q - 1, 0, 0, 0)  # the all-padding last quarter, no shift
    entries = torch.full((cap + 1,), zero_code, dtype=torch.int64, device=dev)
    entries.scatter_(0, target.reshape(-1), codes.reshape(-1))
    return QuadTiles(
        pad_order=pad_order,
        row_start=torch.clamp(tile_start, max=max_tiles - 1).to(torch.int32),
        # an overflowing tail is cut, never read out of bounds; overflow > 0 poisons the result
        row_count=torch.minimum(tile_count, torch.clamp(max_tiles - tile_start, min=0)).to(torch.int32),
        entries=entries[:cap].to(torch.int32),
        overflow=torch.clamp(tile_count.sum() - max_tiles, min=0),
        margin=shift_margin(xq, valid, box_diag, cutoff),
    )


def suggest_max_tiles(conf, box, cutoff: float, margin: float = 1.3) -> int:
    """Host-side capacity: the listed tile count at this geometry, times
    margin for diffusion between rebuilds, rounded up to 32."""
    n_pad = padded_size(conf.shape[0])
    cap = (n_pad // Q) * (1 + -(-(n_pad // Q) // PACK))
    total = int(build_quadscan_tiles(conf, box, cutoff, cap).row_count.sum())
    want = int(np.ceil(total * margin / 32) * 32)
    return min(max(want, 32), cap)


def decode(entries):
    """entries -> (quarter id, (..., 3) image shift in {-1, 0, 1})."""
    e = entries.to(torch.int64)
    shift = torch.stack([((e >> (SHIFT_BITS + 2 * a)) & 3) - 1 for a in range(3)], dim=-1)
    return e & ((1 << SHIFT_BITS) - 1), shift


def quadscan_sweep_plain(atoms, row_start, row_count, entries, scalars, series, mode: int):
    """The sweep in plain PyTorch, in atoms' dtype: each batch of row chunks
    gathers its listed quarters, shifted, into (rows, L, 32, 32) pair
    tensors masked by row_count, with L the batch's longest list in
    quarters, and the first tile of each row gated to row atom < column atom
    on its own chunk. A batch holds at most about 2^18 pair slots on the CPU
    and 2^24 on a card. Returns (Npad, 4) [u_i, dU/dx_i] like the kernel:
    u_i is the row-side energy (each pair counted once, at its row atom),
    dU/dx_i has the row and the column (reaction) parts."""
    quadscan_sweep_plain.calls += 1
    block_pairs = 1 << 18 if atoms.device.type == "cpu" else 1 << 24
    n_pad = atoms.shape[0]
    n_rows = n_pad // Q
    dev = atoms.device
    out = atoms.new_zeros((n_pad, 4))
    cols = atoms.new_zeros((n_pad, 3))
    counts = row_count.tolist()
    batch = max(1, block_pairs // (max(max(counts), 1) * PACK * Q * Q))
    quarters = atoms.view(n_rows, Q, 8)
    box = scalars[:3]
    cut2 = scalars[3] * scalars[3]
    lane = torch.arange(Q, device=dev)
    for r0 in range(0, n_rows, batch):
        r1 = min(r0 + batch, n_rows)
        length = max(counts[r0:r1]) * PACK
        if length == 0:
            continue
        k = torch.arange(length, device=dev)
        listed = k < PACK * row_count[r0:r1, None]  # (b, L)
        cid, shift = decode(entries[torch.where(listed, PACK * row_start[r0:r1, None] + k, 0)])
        cq = quarters[cid].permute(3, 0, 1, 2).unsqueeze(3)  # (8, b, L, 1, Q)
        shifted = shift.to(atoms.dtype) * box  # (b, L, 3)
        rows = torch.arange(r0, r1, device=dev)
        ri = quarters[r0:r1].permute(2, 0, 1)[:, :, None, :, None]  # (8, b, 1, Q, 1)
        d = [ri[a] - (cq[a] + shifted[:, :, None, None, a]) for a in range(3)]  # each (b, L, Q, Q)
        dw = ri[3] - cq[3]
        newton = (cid != rows[:, None])[:, :, None, None] | (lane[:, None] < lane[None, :])
        keep = listed[:, :, None, None] & newton
        de_r, e = rs.pair_terms(d, dw, ri[4] * cq[4], ri[5] + cq[5], ri[6] * cq[6], cut2, keep, series, mode)
        sl = slice(r0 * Q, r1 * Q)
        reaction = []
        for a in range(3):
            g = de_r * d[a]
            out[sl, 1 + a] = g.sum((1, 3)).reshape(-1)
            reaction.append(-g.sum(2))  # (b, L, Q) onto the column atoms
        slots = (cid[:, :, None] * Q + lane).reshape(-1)
        cols.index_add_(0, slots, torch.stack(reaction, -1).reshape(-1, 3))
        if mode == FORCE_ENERGY:
            out[sl, 0] = e.sum((1, 3)).reshape(-1)
    out[:, 1:4] += cols
    return out


quadscan_sweep_plain.calls = 0


def _launcher():
    fn = _build.load_library("quadscan").quadscan_sweep_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def quadscan_sweep(atoms, row_start, row_count, entries, scalars, series, mode: int):
    """(Npad, 4) [u_i, dU/dx_i] of the sweep over the listed tiles.

    atoms (Npad, 8) f32 sorted rows [x y z w q sigma/2 2 sqrt(eps) 0],
    row_start/row_count (nR,) and entries (max_tiles * PACK,) int32,
    scalars (4,) f32 [bx by bz cutoff], series the (h, P) coefficient
    tuples of es_energy_force_series, mode FORCE or FORCE_ENERGY (the
    energy column is zero in FORCE). A CUDA tensor launches the kernel of
    csrc/quadscan.cu on the current stream, with an int64 fixed-point
    scratch for the column reactions; a CPU tensor runs quadscan_sweep_plain."""
    if atoms.device.type == "cpu":
        return quadscan_sweep_plain(atoms, row_start, row_count, entries, scalars, series, mode)
    if atoms.device.type != "cuda":
        raise ValueError(f"quadscan_sweep: no kernel for device {atoms.device}")
    if mode not in (FORCE, FORCE_ENERGY):
        raise ValueError(f"quadscan_sweep: unknown mode {mode}")
    dev = atoms.device
    n_pad = atoms.shape[0]
    if n_pad % (PACK * Q) or n_pad // Q > 1 << SHIFT_BITS:
        raise ValueError(f"quadscan_sweep: {n_pad} atom rows is not a multiple of {PACK * Q} up to {Q << SHIFT_BITS}")
    n_rows = n_pad // Q
    rs.check_tensor("atoms", atoms, torch.float32, dev, (n_pad, 8))
    rs.check_tensor("row_start", row_start, torch.int32, dev, (n_rows,))
    rs.check_tensor("row_count", row_count, torch.int32, dev, (n_rows,))
    rs.check_tensor("entries", entries, torch.int32, dev)
    if entries.dim() != 1 or entries.shape[0] % PACK:
        raise ValueError(f"entries: want a multiple of {PACK} entries, got shape {tuple(entries.shape)}")
    rs.check_tensor("scalars", scalars, torch.float32, dev, (4,))
    h_arg, p_arg = rs.series_args(series)
    out = torch.empty((n_pad, 4), dtype=torch.float32, device=dev)
    acc = torch.zeros((3, n_pad), dtype=torch.int64, device=dev)
    rc = _launcher()(
        atoms.data_ptr(), row_start.data_ptr(), row_count.data_ptr(), entries.data_ptr(), scalars.data_ptr(),
        out.data_ptr(), acc.data_ptr(), n_rows, mode, h_arg, p_arg, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quadscan_sweep: kernel launch failed with CUDA error {rc}")
    quadscan_sweep.launches += 1
    return out


quadscan_sweep.launches = 0


def make_nonbonded_quadscan_md(beta: float, cutoff: float, max_tiles: int, skin: float = 0.1, rebuild_interval: int = 20):
    """MD force provider over quad tiles: an F sweep per step, an F+U sweep
    for the energy, as the JAX tile provider's energy is; see
    nonbonded_kernel.make_list_md_provider. The result is NaN on overflow
    and where the build broke the constant-shift invariant (ROADMAP R5).

    Between rebuilds every atom keeps the periodic image the build wrapped
    it into (the sweep places it at conf - box * image): an entry's shift
    was computed for the chunks as built, and an atom wrapped afresh after
    crossing a box face would sit a box length from where its entries
    expect it. The JAX provider wraps afresh at every sweep (ROADMAP P4)."""
    series = rs.es_energy_force_series(beta, cutoff)

    def build(conf, params, box):
        tiles = build_quadscan_tiles(conf, box, cutoff + skin, max_tiles)
        n = conf.shape[0]
        image = torch.floor(conf[:, :3].to(torch.float32) / torch.diagonal(box).to(torch.float32))  # as the builder wraps
        prows = rs.param_rows(params.to(conf.dtype), tiles.pad_order, n)
        invalid = tiles.overflow + (tiles.margin <= 0).to(tiles.overflow.dtype)
        return ListState(tiles, torch.argsort(tiles.pad_order[:n]), prows, invalid, image)

    def sweep(state, conf, box, mode):
        t = state.lists
        xyz = (conf[:, :3] - torch.diagonal(box).to(conf.dtype) * state.image.to(conf.dtype))[t.pad_order]
        atoms = torch.cat([xyz, state.prows, state.prows.new_zeros((xyz.shape[0], 1))], dim=1)
        return quadscan_sweep(atoms, t.row_start, t.row_count, t.entries, rs.sweep_scalars(box, cutoff), series, mode)

    return make_list_md_provider(build, sweep, FORCE, FORCE_ENERGY, rebuild_interval)
