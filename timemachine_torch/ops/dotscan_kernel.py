"""Dotscan pair sweep: the rowscan pair function with every atom mapped to
the image nearest its row chunk's periodic center and forces by contraction
(counterpart of
timemachine_tpu/ops/pallas/dotscan_kernel.py, the MD provider of the
`kernel="dot"` configuration).

The lists are rowscan's (`build_rowscan_tiles`, snake or Hilbert sort,
symmetric or Newton-triangular). Each 32-atom row chunk r also gets a
center c_r: per axis, the middle of the shortest periodic interval that
covers its atoms (the complement of the largest circular gap), quantized to
1e-4 nm (`rcen_q`, int32). A sweep maps each row atom and each column atom
of a listed tile to its image nearest c_r,

    row  x' = (x - c) - b * round((x - c) / b)
    col  x' = (x - c) + b * round(c / b - x / b)

after which the pairs subtract directly. That is the minimum image for every
pair within the list cutoff as long as

    (largest periodic row half-extent) + cutoff < box / 2   on every axis,

which `build_dotscan_tiles` rechecks at every rebuild (`invalid`, `margin`);
a pair farther than that is never wrongly included, only excluded. Then r^2
from those direct differences (4D: w rides along), the pair function of
`rowscan_kernel.pair_terms` (self-pair gate r^2 > 1e-7) with
G = dU/dr / r, and

    row     dU/dx_i = xi' * sum_j G - sum_j G xj'
    column  dU/dx_j = xj' * sum_i G - sum_i G xi'   (triangular only)

In triangular mode the covering column chunk of each row chunk is swept
first with the gate row atom < column atom, and each pair's energy goes to
its row atom; in symmetric mode each atom's energy is half its pair sums.

That is the JAX kernel's dot_r2=False form in both modes. Its default F
mode forms r^2 by the dot identity (|xi'|^2 - 2 xi'.xj') + |xj'|^2 in f32,
whose cancellation leaves about 1e-7 nm^2 on r^2; the all-pairs term's
bonded neighbours (r^2 near 0.01 nm^2, |dU/dx| up to 3.6e7 before the
exclusions cancel it) turn that into net-force errors up to 1,316
kJ/mol/nm at DHFR, and NPT goes non-finite within 15 steps (ROADMAP R6).

`dotscan_sweep` launches the hand-written CUDA kernel (`csrc/dotscan.cu`) on
CUDA tensors and uses `dotscan_sweep_plain`, the same function in plain
PyTorch, on CPU tensors. Every sweep wraps the coordinates afresh: the row
center, not a build-time image, decides each atom's image, so an atom that
crosses a box face between rebuilds keeps its pairs (unlike quadscan's
per-entry shifts, ROADMAP P4).

On triangular lists the kernel culls at every sweep, at the bare cutoff +
CULL_SLACK: each column atom, at the row center's image, against the box of
the row chunk's atoms at theirs; it sweeps each warp's live columns in
chunks of 32. `cull_mask` and `cull_census` give the same cull and slot
counts in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from timemachine_torch.ops import _build
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.ops.nonbonded_kernel import CULL_SLACK, ListState, make_list_md_provider

ROW, COL = rs.ROW, rs.COL
CEN_SCALE = rs.CEN_SCALE  # nm per unit of the quantized row centers
FORCE, FORCE_ENERGY = rs.FORCE, rs.FORCE_ENERGY  # sweep modes, as in csrc/dotscan.cu
# the triangular kernel's work items, constants of csrc/dotscan.cu mirrored
# here for cull_census: SPLITS list segments per row chunk, each a block of
# WARPS warps, warp w on columns [32 w, 32 w + 32) of every tile of the segment
WARPS, SPLITS = 4, 4

# the lists are rowscan's; size them with the sort and form the provider uses
suggest_max_pairs = rs.suggest_max_pairs
sweep_scalars = rs.sweep_scalars


def periodic_center_halfextent(xs, box_len):
    """(center (nR,), half-extent (nR,)) of each row of xs (nR, ROW), one
    axis of wrapped coordinates in a periodic box of length box_len: the
    shortest covering interval is the box minus the largest gap between
    circularly sorted positions. The center may lie past the box; only its
    residue matters."""
    s = torch.sort(xs, dim=1).values
    gaps = torch.cat([s[:, 1:] - s[:, :-1], (s[:, 0] + box_len - s[:, -1])[:, None]], dim=1)
    gi = torch.argmax(gaps, dim=1, keepdim=True)  # the first largest gap, as jnp.argmax
    extent = box_len - torch.gather(gaps, 1, gi)[:, 0]
    # the covering interval starts at the position after the largest gap
    start = torch.gather(s, 1, (gi + 1) % s.shape[1])[:, 0]
    return start + 0.5 * extent, 0.5 * extent


class DotscanTiles(NamedTuple):
    pad_order: torch.Tensor  # (Npad,) int64: sorted slot -> atom (padding slots -> atom 0)
    row_start: torch.Tensor  # (nR,) int32: first col_ids entry of each row chunk
    row_count: torch.Tensor  # (nR,) int32: listed column chunks of each row chunk
    col_ids: torch.Tensor  # (max_pairs,) int32: column chunk ids
    rank_mat: torch.Tensor  # (nR, nC) int32: rank of chunk c in row r's list, -1 if unlisted (for the chop)
    rcen_q: torch.Tensor  # (nR * 4,) int32: row centers [x y z 0] in units of CEN_SCALE
    overflow: torch.Tensor  # () int64: entries that did not fit in max_pairs
    margin: torch.Tensor  # () f32: min over axes of box/2 - (largest row half-extent + cutoff)
    invalid: torch.Tensor  # () int64: overflow + (image bound broken); nonzero poisons the result


def build_dotscan_tiles(
    conf, box, cutoff: float, max_pairs: int, cell_size: float = 0.65, triangular: bool = False, sort: str = "snake",
) -> DotscanTiles:
    """Rowscan lists at `cutoff` plus each row chunk's quantized periodic
    center, and the image bound at this build (JAX's build_dotscan_tiles,
    with its `invalid`). Padding slots duplicate atom 0 and only widen the
    extents. Runs in f32 whatever conf's dtype."""
    t = rs.build_rowscan_tiles(conf, box, cutoff, max_pairs, cell_size, triangular, sort)
    n_rows = t.pad_order.shape[0] // ROW
    box_diag = torch.diagonal(box).to(torch.float32)
    xs = rs._wrap(conf[:, :3].to(torch.float32), box_diag)[t.pad_order].view(n_rows, ROW, 3)
    parts = [periodic_center_halfextent(xs[:, :, a], box_diag[a]) for a in range(3)]
    rcen = torch.stack([c for c, _ in parts], dim=1)
    reach = torch.stack([h for _, h in parts], dim=1).amax(0) + cutoff  # (3,)
    rcen_q = torch.round(rcen / CEN_SCALE).to(torch.int32)
    bound_bad = (reach >= 0.5 * box_diag).any().to(t.overflow.dtype)
    return DotscanTiles(
        t.pad_order, t.row_start, t.row_count, t.col_ids, t.rank_mat, F.pad(rcen_q, (0, 1)).reshape(-1), t.overflow,
        torch.min(0.5 * box_diag - reach), t.overflow + bound_bad,
    )


def dotscan_valid(conf, box, cutoff: float, headroom: float = 0.1, sort: str = "snake", cell_size: float = 0.65) -> bool:
    """The configure-time gate of JAX's dotscan_valid: the image bound holds
    with `headroom` to spare for row chunks that stretch between rebuilds.
    Pass cutoff + skin to gate the MD provider, which builds at that radius."""
    return float(build_dotscan_tiles(conf, box, cutoff, ROW, cell_size, True, sort).margin) > headroom


class DotCull(NamedTuple):
    rows: torch.Tensor  # (T,) row chunk of each swept tile (covering chunk first), in row and list order
    segment: torch.Tensor  # (T,) the kernel's list segment (block) of the tile within its row
    chunk: torch.Tensor  # (T,) the tile's column chunk
    column: torch.Tensor  # (T, COL) bool: column atoms the cull keeps


def cull_mask(atoms, row_start, row_count, col_ids, rcen_q, scalars) -> DotCull:
    """The triangular kernel's cull over the swept tiles (each row's
    covering chunk, then its list), at the bare cutoff + CULL_SLACK
    (scalars[3] is the cutoff): a column atom is kept where its image
    nearest the row chunk's center comes near the box of the row chunk's
    atoms at their images. Those are the positions the pair function
    subtracts, and w only adds to r^2, so no pair within the cutoff is
    dropped."""
    dev, dt = atoms.device, atoms.dtype
    n_pad = atoms.shape[0]
    n_rows, n_cols = n_pad // ROW, n_pad // COL
    counts = row_count.long() + 1
    rows = torch.repeat_interleave(torch.arange(n_rows, device=dev), counts)
    k = torch.arange(rows.shape[0], device=dev) - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    covering = torch.clamp(rows * ROW // COL, max=n_cols - 1)
    cid = torch.where(k == 0, covering, col_ids[torch.where(k > 0, row_start.long()[rows] + k - 1, 0)].long())
    bounds = counts[:, None] * torch.arange(SPLITS + 1, device=dev) // SPLITS  # (nR, SPLITS + 1)
    segment = torch.searchsorted(bounds[rows], k[:, None], right=True)[:, 0] - 1
    box = scalars[:3]
    inv_box = 1.0 / box
    cen = rcen_q.view(n_rows, 4)[:, :3].to(dt) * CEN_SCALE
    comp = atoms.T.contiguous()
    rd = torch.stack(rs._row_frame(comp.view(8, n_rows, ROW), cen, box, inv_box)[:3], -1)  # (nR, ROW, 3)
    lo, hi = rd.amin(1)[rows][:, None], rd.amax(1)[rows][:, None]  # (T, 1, 3)
    cols = comp.view(8, n_cols, COL)[:, cid, None, :]  # (8, T, 1, COL)
    cd = torch.stack(rs._col_frame(cols, cen[rows], box, inv_box)[:3], -1)[:, 0]  # (T, COL, 3)
    g = torch.clamp(torch.maximum(cd - hi, lo - cd), min=0.0)
    cull = scalars[3] + CULL_SLACK
    keep = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2] < cull * cull
    return DotCull(rows, segment, cid, keep)


class CullCensus(NamedTuple):
    """Pair slots of the triangular dotscan kernel on one set of lists."""

    listed: int  # 32 x 128 per swept tile, the covering tiles included
    columns: int  # 32 rows x the column atoms the cull keeps
    swept: int  # what the kernel sweeps: each warp's live columns in chunks of 32


def cull_census(atoms, row_start, row_count, col_ids, rcen_q, scalars) -> CullCensus:
    """Slot counts of the triangular kernel's cull and chunking, counted by
    the plain copy of both (cull_mask; each warp's columns of a row's
    segment are swept in chunks of 32), not by the kernel."""
    c = cull_mask(atoms, row_start, row_count, col_ids, rcen_q, scalars)
    per_warp = c.column.view(-1, WARPS, COL // WARPS).sum(2)  # (T, WARPS)
    live = torch.zeros(row_count.shape[0] * SPLITS, WARPS, dtype=torch.int64, device=atoms.device)
    live.index_add_(0, c.rows * SPLITS + c.segment, per_warp)
    return CullCensus(
        listed=c.rows.shape[0] * ROW * COL, columns=int(c.column.sum()) * ROW,
        swept=int(((live + ROW - 1) // ROW).sum()) * ROW * ROW,
    )


def dotscan_sweep_plain(atoms, row_start, row_count, col_ids, rcen_q, scalars, series, mode: int, triangular: bool = False):
    """The sweep in plain PyTorch, in atoms' dtype: each batch of row chunks
    gathers its tiles (in triangular mode the covering chunk first) into
    (rows, L, 32, 128) pair tensors masked by row_count, with L the batch's
    longest list. A batch holds at most about 2^18 pair slots on the CPU
    and 2^24 on a card. The contractions are elementwise products and sums,
    so no TF32 matrix unit can enter. Returns (Npad, 4) [u_i, dU/dx_i] like
    the kernel; the column reactions are scattered with index_add_."""
    dotscan_sweep_plain.calls += 1
    dev, dt = atoms.device, atoms.dtype
    block_pairs = 1 << 18 if dev.type == "cpu" else 1 << 24
    n_pad = atoms.shape[0]
    n_rows, n_cols = n_pad // ROW, n_pad // COL
    out = atoms.new_zeros((n_pad, 4))
    react = atoms.new_zeros((n_pad, 3))
    counts_t = row_count.long() + int(triangular)
    counts = counts_t.tolist()
    batch = max(1, block_pairs // (max(max(counts), 1) * ROW * COL))
    comp = atoms.T.contiguous()
    rows_all = comp.view(8, n_rows, ROW)
    cols_all = comp.view(8, n_cols, COL)
    box = scalars[:3]
    inv_box = 1.0 / box
    cut2 = scalars[3] * scalars[3]
    cen_all = rcen_q.view(n_rows, 4)[:, :3].to(dt) * CEN_SCALE
    row_ids = torch.arange(n_rows, device=dev)
    lane_r = torch.arange(ROW, device=dev)
    lane_c = torch.arange(COL, device=dev)
    for r0 in range(0, n_rows, batch):
        r1 = min(r0 + batch, n_rows)
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
        cen = cen_all[r0:r1]
        rd = [v[:, None, :, None] for v in rs._row_frame(rows, cen, box, inv_box)]  # each (b, 1, ROW, 1)
        cd = [v[:, :, None, :] for v in rs._col_frame(cols, cen, box, inv_box)]  # each (b, L, 1, COL)
        keep = listed[:, :, None, None]
        if triangular:
            row_gid = (row_ids[r0:r1, None] * ROW + lane_r)[:, None, :, None]
            keep = keep & (row_gid < (cid[:, :, None] * COL + lane_c)[:, :, None, :])
        qq = rows[4][:, None, :, None] * cols[4][:, :, None, :]
        sg = rows[5][:, None, :, None] + cols[5][:, :, None, :]
        e4 = rows[6][:, None, :, None] * cols[6][:, :, None, :]
        g, e = rs.pair_terms([rd[a] - cd[a] for a in range(3)], rd[3] - cd[3], qq, sg, e4, cut2, keep, series, mode)
        sl = slice(r0 * ROW, r1 * ROW)
        sum_g = g.sum((1, 3))
        for a in range(3):
            out[sl, 1 + a] = (rd[a][:, 0, :, 0] * sum_g - (g * cd[a]).sum((1, 3))).reshape(-1)
        if triangular:
            col_g = g.sum(2)  # (b, L, COL)
            parts = [cd[a][:, :, 0, :] * col_g - (g * rd[a]).sum(2) for a in range(3)]
            react.index_add_(0, (cid[:, :, None] * COL + lane_c).reshape(-1), torch.stack(parts, -1).reshape(-1, 3))
        if mode == FORCE_ENERGY:
            u = e.sum((1, 3))
            out[sl, 0] = (u if triangular else 0.5 * u).reshape(-1)
    if triangular:
        out[:, 1:4] += react
    return out


dotscan_sweep_plain.calls = 0


def _launcher():
    fn = _build.load_library("dotscan").dotscan_sweep_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def dotscan_sweep(atoms, row_start, row_count, col_ids, rcen_q, scalars, series, mode: int, triangular: bool = False):
    """(Npad, 4) [u_i, dU/dx_i] of the sweep over the listed tiles.

    atoms (Npad, 8) f32 sorted rows [x y z w q sigma/2 2 sqrt(eps) 0],
    row_start/row_count (nR,), col_ids (max_pairs,) and rcen_q (nR * 4,)
    int32, scalars (4,) f32 [bx by bz cutoff], series the (h, P) coefficient
    tuples of es_energy_force_series, mode FORCE or FORCE_ENERGY (the energy
    column is zero in FORCE), lists symmetric or triangular. A CUDA tensor
    launches the kernel of csrc/dotscan.cu on the current stream: on
    triangular lists the redesign, with an int64 fixed-point scratch for the
    sums (NaN wherever a sum leaves its range), on symmetric lists the first design (the yardstick). A CPU tensor
    runs dotscan_sweep_plain."""
    if atoms.device.type == "cpu":
        return dotscan_sweep_plain(atoms, row_start, row_count, col_ids, rcen_q, scalars, series, mode, triangular)
    if atoms.device.type != "cuda":
        raise ValueError(f"dotscan_sweep: no kernel for device {atoms.device}")
    if mode not in (FORCE, FORCE_ENERGY):
        raise ValueError(f"dotscan_sweep: unknown mode {mode}")
    dev = atoms.device
    n_pad = atoms.shape[0]
    if n_pad % COL:
        raise ValueError(f"dotscan_sweep: {n_pad} atom rows is not a multiple of {COL}")
    n_rows = n_pad // ROW
    rs.check_tensor("atoms", atoms, torch.float32, dev, (n_pad, 8))
    rs.check_tensor("row_start", row_start, torch.int32, dev, (n_rows,))
    rs.check_tensor("row_count", row_count, torch.int32, dev, (n_rows,))
    rs.check_tensor("col_ids", col_ids, torch.int32, dev)
    rs.check_tensor("rcen_q", rcen_q, torch.int32, dev, (4 * n_rows,))
    rs.check_tensor("scalars", scalars, torch.float32, dev, (4,))
    h_arg, p_arg = rs.series_args(series)
    out = torch.empty((n_pad, 4), dtype=torch.float32, device=dev)
    acc = torch.zeros((4 * n_pad + 1) if triangular else 0, dtype=torch.int64, device=dev)  # sums, overflow flag
    rc = _launcher()(
        atoms.data_ptr(), row_start.data_ptr(), row_count.data_ptr(), col_ids.data_ptr(), rcen_q.data_ptr(),
        scalars.data_ptr(), out.data_ptr(), acc.data_ptr(), n_rows, mode, int(triangular), h_arg, p_arg,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dotscan_sweep: kernel launch failed with CUDA error {rc}")
    dotscan_sweep.launches += 1
    return out


dotscan_sweep.launches = 0


def make_nonbonded_dotscan_md(
    beta: float, cutoff: float, max_pairs: int, skin: float = 0.1, rebuild_interval: int = 20, sort: str = "snake",
):
    """MD force provider over Newton-triangular dotscan tiles (counterpart
    of JAX's make_nonbonded_dotscan_md with triangular=True, as its
    kernel="dot" configuration builds it): lists at cutoff + skin with
    `sort`, swept whole at every step (no per-step chop, as in JAX); an F
    sweep per step and an F+U sweep for the energy (JAX maps its
    energy-only request to F+U). Size max_pairs with suggest_max_pairs at
    cutoff + skin, triangular, with the same sort. The result is NaN on
    overflow, where the build broke the image bound, and on the card where a
    sum leaves the kernel's fixed-point range (nonbonded_kernel.FIX_LIMIT);
    see nonbonded_kernel.make_list_md_provider."""
    series = rs.es_energy_force_series(beta, cutoff)

    def build(conf, params, box):
        tiles = build_dotscan_tiles(conf, box, cutoff + skin, max_pairs, triangular=True, sort=sort)
        n = conf.shape[0]
        prows = rs.param_rows(params.to(conf.dtype), tiles.pad_order, n)
        return ListState(tiles, torch.argsort(tiles.pad_order[:n]), prows, tiles.invalid)

    def sweep(state, conf, box, mode):
        t = state.lists
        atoms = rs.assemble_atoms(conf, box, t.pad_order, state.prows)
        return dotscan_sweep(
            atoms, t.row_start, t.row_count, t.col_ids, t.rcen_q, sweep_scalars(box, cutoff), series, mode, True
        )

    return make_list_md_provider(build, sweep, FORCE, FORCE_ENERGY, rebuild_interval)
