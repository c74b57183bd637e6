"""Nonbonded block-tile sweep: energy + forces, or forcefield-parameter
gradients (counterpart of timemachine_tpu/ops/pallas/nonbonded_kernel.py).

Atoms are sorted along a snake path through spatial cells and cut into
128-atom row blocks; column super-blocks are cb row blocks wide. Each row
block lists the column super-blocks whose bounding boxes come within the
cutoff (and always its own). The symmetric list (JAX's) sees every pair
from both of its atoms; the Newton-triangular list keeps only the
super-blocks that reach the row block's diagonal (c cb + cb - 1 >= r) and
sees every pair once, from its lower sorted index. The sweep sums, per row
atom, over the listed column atoms j with

    mask = valid_i & valid_j & (i != j) & (r2 < cutoff^2)     symmetric
    mask = valid_i & valid_j & (i < j) & (r2 < cutoff^2)      triangular

(r2 the 4D minimum-image distance) in one of three modes:

    UF   [u_i, dU/dx_i]      u_i half of atom i's pair energies (symmetric),
                             the energies of the pairs atom i is row of
                             (triangular): only the sum is the energy
    F    [0, dU/dx_i]
    DP   [dU/dq_i, dU/d(sig/2)_i, dU/d sqrt(eps)_i, dU/dw_i]

In triangular form each pair's terms reach the column atom too (its
reaction). Every path of the port runs the triangular form; the symmetric
form is the kernel's first design, kept in DP and F as its yardstick.

The electrostatics (`es_coeffs`) are exact, erfc times the cos^3 switch
(None: torch's erfc in the plain version, CUDA's erfcf in the kernel, the
function of JAX's impl="dense" and impl="tiled"), the JAX kernel's own
exact form (AS7126: erfc by Abramowitz & Stegun 7.1.26, absolute error up
to 1.5e-7), or two Clenshaw series (`es_switch_poly_coeffs`); DP is never
the series, as in the JAX backward pass. The kernel="v1" configuration
runs the exact form (it serves JAX's "tiled" and the minimizers' host term
on the card, ROADMAP P11); the du/dp pass of the swept configurations
(run_dp's default) runs AS7126, as JAX's _run_dp does, and the kernel
builds AS7126 in DP only. It stays because the training path's dL/ds
must match JAX's: with erfc in its place,
tests/test_torch_param_grad.py::test_charge_scale_training_matches_jax
reads 1095.0033 against JAX's 1095.1317 (1.2e-4 relative, over its 1e-4).
The plain version takes AS7126 in every mode, as the JAX kernel's function
(tests/test_torch_nb_tiles.py holds it against the Pallas kernel).

`nb_tiles` launches the hand-written CUDA kernel (`csrc/nb_tiles.cu`) on
CUDA tensors and uses `nb_tiles_plain`, the same function in plain PyTorch,
on CPU tensors. The tile builder and the providers are plain tensor code,
as they are plain XLA in the JAX package. Where the JAX package drops the
list overflow count (its `_run_dp`), the port returns NaN; so does the
kernel where a sum leaves its int64 fixed-point range. `subtile_boxes` and
`subtile_near` are the kernel's in-sweep cull of 32 x 32 sub-tiles in plain
PyTorch, for the tests and for `cull_census`.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from timemachine_torch.ops import _build
from timemachine_torch.ops.nonbonded import SWITCH_CUTOFF

BLOCK = 128  # atoms per row block
GROUP = 32  # atoms per side of the triangular kernel's sub-tiles (one warp's rows)
UF, FORCE, DP = 0, 1, 2  # sweep modes, as in csrc/nb_tiles.cu
MAX_CB = 8  # widest column super-block the kernel takes
CULL_SLACK = 1e-3  # nm added to the cutoff by the sub-tile cull, far above its rounding
# the triangular kernel's sums are int64 fixed point at 2^32 units (csrc/fixed_point.cuh,
# range 2^31); a reaction, partial or whole sum of 2^30 or more turns its result into NaN
FIX_LIMIT = 2.0**30
CELL_SIZE = 0.65  # nm, the sort cells of the snake path, as in the JAX builder
HILBERT_BITS = 7  # Hilbert grid of 2^7 cells per axis
_SQRT_PI = 1.7724538509055159

AS7126 = "as7126"  # es_coeffs of the JAX kernel's exact form: erfc by A&S 7.1.26
_es_poly_cache: dict = {}


def es_switch_poly_coeffs(beta: float, cutoff: float, deg: int = 12):
    """Chebyshev coefficients (domain u = r/cutoff in [0, 1]) of the
    switched-erfc factor h(u) = erfc(beta*cutoff*u) * cos^3((pi/2) u^8) and
    of its derivative h'(u), fitted once per (beta, cutoff) in f64; max fit
    error ~2e-6 (h) / ~7e-4 abs (h')."""
    key = (float(beta), float(cutoff), deg)
    if key not in _es_poly_cache:
        from scipy.special import erfc as _erfc

        u = np.linspace(0.0, 1.0, 4001)
        bc = beta * cutoff
        h = _erfc(bc * u) * np.cos(np.pi / 2 * u**8) ** 3
        dh = (
            -2.0 * bc / np.sqrt(np.pi) * np.exp(-((bc * u) ** 2)) * np.cos(np.pi / 2 * u**8) ** 3
            + _erfc(bc * u) * 3.0 * np.cos(np.pi / 2 * u**8) ** 2 * (-np.sin(np.pi / 2 * u**8)) * (np.pi / 2 * 8 * u**7)
        )
        ch = np.polynomial.chebyshev.Chebyshev.fit(u, h, deg, domain=[0.0, 1.0])
        chp = np.polynomial.chebyshev.Chebyshev.fit(u, dh, deg, domain=[0.0, 1.0])
        _es_poly_cache[key] = (tuple(float(x) for x in ch.coef), tuple(float(x) for x in chp.coef))
    return _es_poly_cache[key]


class BlockTiles(NamedTuple):
    atoms: torch.Tensor  # (Npad, 8) sorted rows [x y z w q sig/2 sqrt(eps) valid], padding rows zero
    pad_order: torch.Tensor  # (Npad,) int64: sorted slot -> atom (padding slots -> atom 0)
    row_start: torch.Tensor  # (nB,) int32: first col_ids entry of each row block
    row_count: torch.Tensor  # (nB,) int32: listed column super-blocks of each row block
    col_ids: torch.Tensor  # (max_tiles,) int32: column super-block ids, ascending per row
    overflow: torch.Tensor  # () int64: tiles that did not fit in max_tiles


def padded_size(n: int, cb: int) -> int:
    return -(-n // (BLOCK * cb)) * (BLOCK * cb)


def snake_order(conf, box_diag, cell_size: float):
    """Atom order along a boustrophedon path through cells of about
    cell_size nm (the JAX builders' key, in their arithmetic)."""
    dims = torch.clamp(torch.floor(box_diag / cell_size).to(torch.int32), min=1)
    frac = conf / box_diag
    frac = frac - torch.floor(frac)
    cx, cy, cz = torch.minimum((frac * dims).to(torch.int32), dims - 1).unbind(1)
    ky = torch.where(cz % 2 == 0, cy, dims[1] - 1 - cy)
    kx = torch.where((cz * dims[1] + ky) % 2 == 0, cx, dims[0] - 1 - cx)
    return torch.argsort((cz * dims[1] + ky) * dims[0] + kx, stable=True)


def hilbert_keys(frac, bits: int = HILBERT_BITS):
    """(N, 3) fractional positions in [0, 1) -> (N,) int64 index along a
    Hilbert curve through a 2^bits grid (Skilling's transpose algorithm, in
    the JAX package's arithmetic)."""
    side = 1 << bits
    cell = torch.clamp((frac * side).to(torch.int64), max=side - 1)
    x = [cell[:, 0], cell[:, 1], cell[:, 2]]
    q = side >> 1
    while q > 1:
        p = q - 1
        for i in range(3):
            cond = (x[i] & q) != 0
            x[0] = torch.where(cond, x[0] ^ p, x[0])
            t = torch.where(cond, 0, (x[0] ^ x[i]) & p)
            x[0] = x[0] ^ t
            x[i] = x[i] ^ t
        q >>= 1
    for i in range(1, 3):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = side >> 1
    while q > 1:
        t = torch.where((x[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    x = [xi ^ t for xi in x]
    key = torch.zeros_like(x[0])
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << 1) | ((x[i] >> b) & 1)
    return key


def hilbert_order(wrapped, box_diag):
    """Atom order along the Hilbert curve of hilbert_keys, for coordinates
    wrapped into the box (the JAX builders' key, in their arithmetic)."""
    frac = wrapped / box_diag
    return torch.argsort(hilbert_keys(frac - torch.floor(frac)), stable=True)


def param_rows(params, pad_order, n: int, atom_mask=None):
    """(Npad, 5) sorted rows [w q sig/2 sqrt(eps) valid], zero on padding;
    atoms outside atom_mask (N,) bool, where given, have valid = 0 and join
    no pair."""
    real = (torch.arange(pad_order.shape[0], device=params.device) < n).to(params.dtype)[:, None]
    p = params[pad_order]
    valid = torch.ones_like(p[:, 0]) if atom_mask is None else atom_mask[pad_order].to(params.dtype)
    return torch.stack([p[:, 3], p[:, 0], p[:, 1], p[:, 2], valid], dim=1) * real


def assemble_atoms(conf, box, pad_order, prows):
    """(Npad, 8) sweep rows: coordinates wrapped into the box and sorted,
    then the parameter rows; padding rows are zero."""
    box_diag = torch.diagonal(box)
    xyz = conf[:, :3] - box_diag * torch.floor(conf[:, :3] / box_diag)
    return torch.cat([xyz[pad_order] * prows[:, 4:], prows], dim=1)


def build_block_tiles(
    conf, params, box, cutoff: float, max_tiles: int, cb: int = 1, triangular: bool = False, atom_mask=None,
):
    """Snake sort, 128-atom block bounding boxes and the symmetric list of
    (row block, column super-block) tiles whose boxes come within `cutoff`,
    in CSR form with every row's own column kept; triangular=True keeps of
    it only the super-blocks c that reach the row block r's diagonal, c cb +
    cb - 1 >= r (the own column among them). The sort and the boxes run in
    f32, as in the JAX builder; the atom rows take conf's dtype. Atoms
    outside atom_mask (N,) bool, where given, are invalid rows: they join
    no box and no pair, as in JAX's builder."""
    n = conf.shape[0]
    dev = conf.device
    n_pad = padded_size(n, cb)
    n_blocks, n_cols = n_pad // BLOCK, n_pad // (BLOCK * cb)
    x32 = conf[:, :3].to(torch.float32)
    box_diag = torch.diagonal(box).to(torch.float32)
    order = snake_order(x32, box_diag, CELL_SIZE)
    pad_order = torch.cat([order, order.new_zeros(n_pad - n)])
    prows = param_rows(params.to(conf.dtype), pad_order, n, atom_mask)
    atoms = assemble_atoms(conf, box.to(conf.dtype), pad_order, prows)

    wrapped = (x32 - box_diag * torch.floor(x32 / box_diag))[pad_order]
    valid = prows[:, 4:] > 0
    lo = torch.where(valid, wrapped, 1e9).view(n_blocks, BLOCK, 3).amin(1)
    hi = torch.where(valid, wrapped, -1e9).view(n_blocks, BLOCK, 3).amax(1)
    clo, chi = lo.view(n_cols, cb, 3).amin(1), hi.view(n_cols, cb, 3).amax(1)
    dc = 0.5 * (lo + hi)[:, None, :] - 0.5 * (clo + chi)[None, :, :]
    dc = dc - box_diag * torch.floor(dc / box_diag + 0.5)
    gap = torch.clamp(torch.abs(dc) - (0.5 * (hi - lo)[:, None, :] + 0.5 * (chi - clo)[None, :, :]), min=0.0)
    has_r = valid.view(n_blocks, BLOCK).any(1)
    has_c = has_r.view(n_cols, cb).any(1)
    cols = torch.arange(n_cols, device=dev)
    inter = (torch.sum(gap * gap, dim=2) < cutoff * cutoff) & has_r[:, None] & has_c[None, :]
    rows = torch.arange(n_blocks, device=dev)[:, None]
    inter = inter | (cols[None, :] == rows // cb)
    if triangular:
        inter = inter & (cols[None, :] * cb + cb - 1 >= rows)

    counts = inter.sum(1)
    listed = torch.sort(torch.where(inter, cols, n_cols + cols), dim=1).values  # interacting columns first, ascending
    row_start = torch.cumsum(counts, 0) - counts
    target = row_start[:, None] + cols
    ok = (cols < counts[:, None]) & (target < max_tiles)
    # entries that are not written go to distinct slots past max_tiles
    slot = torch.where(ok, target, max_tiles + torch.arange(n_blocks * n_cols, device=dev).view(n_blocks, n_cols))
    col_ids = torch.zeros(max_tiles + n_blocks * n_cols, dtype=torch.int32, device=dev)
    col_ids[slot.reshape(-1)] = listed.reshape(-1).to(torch.int32)
    return BlockTiles(
        atoms=atoms,
        pad_order=pad_order,
        row_start=torch.clamp(row_start, max=max_tiles - 1).to(torch.int32),
        # an overflowing tail is cut, never read out of bounds; overflow > 0 poisons the result
        row_count=torch.minimum(counts, torch.clamp(max_tiles - row_start, min=0)).to(torch.int32),
        col_ids=col_ids[:max_tiles],
        overflow=torch.clamp(counts.sum() - max_tiles, min=0),
    )


def suggest_max_tiles(
    conf, box, cutoff: float, margin: float = 1.3, cb: int = 1, triangular: bool = False, atom_mask=None,
) -> int:
    """Host-side capacity: the listed tile count at this geometry, times
    margin for diffusion between rebuilds, rounded up to 128."""
    n_pad = padded_size(conf.shape[0], cb)
    cap = (n_pad // BLOCK) * (n_pad // (BLOCK * cb))
    conf = torch.as_tensor(conf)
    params = conf.new_zeros((conf.shape[0], 4))
    tiles = build_block_tiles(conf, params, torch.as_tensor(box), cutoff, cap, cb, triangular, atom_mask)
    count = int(tiles.row_count.sum())
    want = int(np.ceil(count * margin / 128) * 128)
    return min(max(want, 128), cap)


def tile_scalars(box, beta: float, cutoff: float):
    """(5,) [box_x, box_y, box_z, beta, cutoff] on box's device, without a
    host copy."""
    return F.pad(F.pad(torch.diagonal(box), (0, 1), value=beta), (0, 1), value=cutoff)


def subtile_boxes(atoms, box_diag):
    """(Npad / 32, 3) centers and half-extents of each 32-atom group's
    valid atoms, at their images nearest the group's first atom (the
    kernel's group_boxes). A group with no valid atom gets half-extents of
    -1e18, so nothing comes near it."""
    x = atoms[:, :3].reshape(-1, GROUP, 3)
    valid = (atoms[:, 7] > 0).reshape(-1, GROUP, 1)
    rel = x - x[:, :1]
    rel = rel - box_diag * torch.round(rel / box_diag)
    lo = torch.where(valid, rel, math.inf).amin(1)
    hi = torch.where(valid, rel, -math.inf).amax(1)
    empty = ~valid.any(1)
    center = torch.where(empty, 0.0, x[:, 0] + 0.5 * (lo + hi))
    half = torch.where(empty, -1e18, 0.5 * (hi - lo))
    return center, half


def subtile_near(row_boxes, col_boxes, box_diag, cutoff: float):
    """The kernel's cull, elementwise over broadcast (center, half) pairs:
    True where the two groups' boxes come within cutoff + CULL_SLACK under
    the minimum image. Any images of the atoms bound each pair's distance
    from below, and w only adds to r^2, so a False pair of groups holds no
    pair within the cutoff."""
    (rc, rh), (cc, ch) = row_boxes, col_boxes
    dc = rc - cc
    dc = dc - box_diag * torch.round(dc / box_diag)
    gap = torch.clamp(torch.abs(dc) - (rh + ch), min=0.0)
    return torch.sum(gap * gap, dim=-1) < (cutoff + CULL_SLACK) ** 2


class CullCensus(NamedTuple):
    """Pair slots of the triangular kernel on one set of lists."""

    listed: int  # 128 x 128 cb per listed tile
    upper: int  # in the 32 x 32 sub-tiles whose column group is not below the row group
    subtiles: int  # in those sub-tiles the group-box cull keeps
    columns: int  # 32 rows x the live columns: those of kept sub-tiles near the row group's box
    swept: int  # what the kernel sweeps: the live columns of each warp and tile in chunks of 32


def cull_census(atoms, row_start, row_count, col_ids, box, cutoff: float, cb: int) -> CullCensus:
    """Host-side pair-slot counts of the triangular kernel's culls on these
    lists, by subtile_near (the column cull takes each column atom as a box
    of no extent)."""
    box_diag = torch.diagonal(box).to(atoms.dtype)
    center, half = subtile_boxes(atoms, box_diag)
    dev = atoms.device
    counts = row_count.long()
    rows = torch.repeat_interleave(torch.arange(len(counts), device=dev), counts)
    k = torch.arange(len(rows), device=dev) - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    cols = col_ids[row_start.long()[rows] + k].long()
    per_block, per_col, width = BLOCK // GROUP, BLOCK * cb // GROUP, BLOCK * cb
    rg = rows[:, None] * per_block + torch.arange(per_block, device=dev)  # (T, 4)
    cg = cols[:, None] * per_col + torch.arange(per_col, device=dev)  # (T, groups)
    upper = cg[:, None, :] >= rg[:, :, None]  # (T, 4, groups)
    kept = upper & subtile_near(
        (center[rg][:, :, None], half[rg][:, :, None]), (center[cg][:, None], half[cg][:, None]), box_diag, cutoff
    )
    j = cols[:, None] * width + torch.arange(width, device=dev)  # (T, width)
    point = (atoms[j, :3][:, None], torch.zeros_like(atoms[j, :3][:, None]))
    live = (
        kept.repeat_interleave(GROUP, dim=2)
        & (atoms[j, 7] > 0)[:, None]
        & subtile_near((center[rg][:, :, None], half[rg][:, :, None]), point, box_diag, cutoff)
    )  # (T, 4, width)
    n_live = live.sum(2)
    slots = GROUP * GROUP
    return CullCensus(
        listed=len(rows) * BLOCK * width, upper=int(upper.sum()) * slots, subtiles=int(kept.sum()) * slots,
        columns=int(n_live.sum()) * GROUP, swept=int(((n_live + GROUP - 1) // GROUP).sum()) * slots,
    )


def _clenshaw(t2, coeffs):
    b1 = torch.zeros_like(t2)
    b2 = torch.zeros_like(t2)
    for ck in coeffs[:0:-1]:
        b1, b2 = t2 * b1 - b2 + ck, b1
    return 0.5 * t2 * b1 - b2 + coeffs[0]


def _pair_terms(r2, qq, sig, eps, beta, mask, es_coeffs):
    """(e, dE/dr / r, s_es, t6, t12, eps4) of the kernel's pair function on
    pair tensors; masked pairs take r2 := 1 and every term is selected on
    the mask by the caller."""
    r2 = torch.where(mask, r2, 1.0)
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    inv_r2 = inv_r * inv_r
    s2 = sig * sig * inv_r2
    t6 = s2 * s2 * s2
    t12 = t6 * t6
    eps4 = 4.0 * eps
    e_lj = eps4 * (t12 - t6)
    dlj_r = eps4 * inv_r2 * (6.0 * t6 - 12.0 * t12)
    if _is_series(es_coeffs):
        h_coeffs, hp_coeffs = es_coeffs
        inv_c = 1.0 / SWITCH_CUTOFF
        t2 = 2.0 * (2.0 * (r * inv_c) - 1.0)
        h = _clenshaw(t2, h_coeffs)
        hp = _clenshaw(t2, hp_coeffs)
        s_r_sw = h * inv_r
        e_es = qq * s_r_sw
        des_r = qq * inv_r2 * (hp * inv_c - h * inv_r)
    else:  # exact: erfc itself (es_coeffs None) or A&S 7.1.26 (AS7126)
        v = r2 * (1.0 / (SWITCH_CUTOFF * SWITCH_CUTOFF))
        v2 = v * v
        u8 = v2 * v2
        cosu = torch.cos((0.5 * math.pi) * u8)
        cos2 = cosu * cosu
        sinu = torch.sqrt(torch.clamp(1.0 - cos2, min=0.0))
        sw = cos2 * cosu
        dsw_dr = -12.0 * math.pi * u8 * inv_r * cos2 * sinu
        x = beta * r
        gauss = torch.exp(-x * x)
        if es_coeffs == AS7126:
            tt = 1.0 / (1.0 + 0.3275911 * x)
            erfc_bar = gauss * tt * (
                0.254829592 + tt * (-0.284496736 + tt * (1.421413741 + tt * (-1.453152027 + tt * 1.061405429)))
            )
        else:
            erfc_bar = torch.special.erfc(x)
        s_r = erfc_bar * inv_r
        ds_dr = (-2.0 / _SQRT_PI) * beta * gauss * inv_r - erfc_bar * inv_r2
        e_es = qq * s_r * sw
        des_r = qq * (ds_dr * sw + s_r * dsw_dr) * inv_r
        s_r_sw = s_r * sw
    e = torch.where(mask, e_lj + e_es, 0.0)
    de_r = torch.where(mask, dlj_r + des_r, 0.0)
    return e, de_r, s_r_sw, t6, t12, eps4


def _is_series(es_coeffs) -> bool:
    return es_coeffs is not None and not isinstance(es_coeffs, str)


def _check_args(atoms, row_start, row_count, col_ids, scalars, mode: int, cb: int, es_coeffs):
    if mode not in (UF, FORCE, DP):
        raise ValueError(f"nb_tiles: unknown mode {mode}")
    if isinstance(es_coeffs, str) and es_coeffs != AS7126:
        raise ValueError(f"nb_tiles: es_coeffs must be None, AS7126 or a series, got {es_coeffs!r}")
    if mode == DP and _is_series(es_coeffs):
        raise ValueError("nb_tiles: the DP mode runs the exact electrostatics only")
    if not 1 <= cb <= MAX_CB:
        raise ValueError(f"nb_tiles: cb must lie in [1, {MAX_CB}], got {cb}")
    n_pad = atoms.shape[0]
    if n_pad % (BLOCK * cb):
        raise ValueError(f"nb_tiles: {n_pad} atom rows is not a multiple of {BLOCK * cb}")
    n_blocks = n_pad // BLOCK
    dev = atoms.device
    for name, t, dtype, shape in (
        ("atoms", atoms, torch.float32, (n_pad, 8)),
        ("row_start", row_start, torch.int32, (n_blocks,)),
        ("row_count", row_count, torch.int32, (n_blocks,)),
        ("col_ids", col_ids, torch.int32, None),
        ("scalars", scalars, torch.float32, (5,)),
    ):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dtype} tensor on {dev}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got {tuple(t.shape)}")


def nb_tiles_plain(
    atoms, row_start, row_count, col_ids, scalars, mode: int, cb: int = 1, es_coeffs=None, triangular: bool = False,
):
    """The sweep in plain PyTorch, in atoms' dtype: each batch of row blocks
    gathers its listed column super-blocks into (rows, L, 128, 128 cb) pair
    tensors masked by row_count, with L the batch's longest list. A batch
    holds at most about 2^18 pair slots on the CPU and 2^24 on a card.
    Returns (Npad, 4) by mode, like the kernel; the triangular form's
    column reactions are scattered with index_add_."""
    nb_tiles_plain.calls += 1
    block_pairs = 1 << 18 if atoms.device.type == "cpu" else 1 << 24
    n_pad = atoms.shape[0]
    width = BLOCK * cb
    n_blocks = n_pad // BLOCK
    out = atoms.new_zeros((n_pad, 4))
    react = atoms.new_zeros((4, n_pad)) if triangular else None
    counts = row_count.tolist()
    batch = max(1, block_pairs // (max(max(counts), 1) * BLOCK * width))
    comp = atoms.T.contiguous()  # one contiguous row per column of the atom rows
    rows = comp.view(8, n_blocks, 1, BLOCK, 1)
    cols = comp.view(8, n_pad // width, width)
    box, beta, cutoff = scalars[:3], scalars[3], scalars[4]
    lane = torch.arange(BLOCK, device=atoms.device)
    col_lane = torch.arange(width, device=atoms.device)
    for r0 in range(0, n_blocks, batch):
        r1 = min(r0 + batch, n_blocks)
        length = max(counts[r0:r1])
        if length == 0:
            continue
        k = torch.arange(length, device=atoms.device)
        listed = k < row_count[r0:r1, None]  # (b, L)
        cid = col_ids[torch.where(listed, row_start[r0:r1, None] + k, 0)].long()
        cj = cols[:, cid].unsqueeze(3)  # (8, b, L, 1, W)
        ri = rows[:, r0:r1]  # (8, b, 1, 128, 1)
        gi = (torch.arange(r0, r1, device=atoms.device)[:, None] * BLOCK + lane)[:, None, :, None]
        gj = (cid[:, :, None] * width + col_lane)[:, :, None, :]
        d = [ri[a] - cj[a] for a in range(3)]  # each (b, L, 128, W)
        d = [da - box[a] * torch.floor(da / box[a] + 0.5) for a, da in enumerate(d)]
        dw = ri[3] - cj[3]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + dw * dw
        pair_ok = gi < gj if triangular else gi != gj
        mask = (ri[7] > 0) & (cj[7] > 0) & pair_ok & (r2 < cutoff * cutoff) & listed[:, :, None, None]
        e, de_r, s_r_sw, t6, t12, eps4 = _pair_terms(r2, ri[4] * cj[4], ri[5] + cj[5], ri[6] * cj[6], beta, mask, es_coeffs)
        sl = slice(r0 * BLOCK, r1 * BLOCK)
        if mode == DP:
            sig = ri[5] + cj[5]
            sig_safe = torch.where(sig > 0, sig, 1.0)
            d_sig = torch.where(mask & (eps4 != 0), eps4 * (12.0 * t12 - 6.0 * t6) / sig_safe, 0.0)
            lj = 4.0 * (t12 - t6)
            rows_terms = (torch.where(mask, cj[4] * s_r_sw, 0.0), d_sig, torch.where(mask, cj[6] * lj, 0.0), de_r * dw)
            cols_terms = (
                (torch.where(mask, ri[4] * s_r_sw, 0.0), d_sig, torch.where(mask, ri[6] * lj, 0.0), -de_r * dw)
                if triangular else ()
            )
        else:
            rows_terms = (e if mode == UF else None, *(de_r * da for da in d))
            cols_terms = (None, *(-de_r * da for da in d)) if triangular else ()
        for a, term in enumerate(rows_terms):
            if term is not None:
                out[sl, a] = term.sum((1, 3)).reshape(-1)
        if mode == UF and not triangular:
            out[sl, 0] *= 0.5  # each pair's energy was counted from both of its atoms
        for a, term in enumerate(cols_terms):
            if term is not None:
                react[a].index_add_(0, gj[:, :, 0, :].reshape(-1), term.sum(2).reshape(-1))
    if triangular:
        out += react.T
    return out


nb_tiles_plain.calls = 0

_series_args: dict = {}


def _launcher():
    fn = _build.load_library("nb_tiles").nb_tiles_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def nb_tiles(
    atoms, row_start, row_count, col_ids, scalars, mode: int, cb: int = 1, es_coeffs=None, triangular: bool = False,
):
    """(Npad, 4) sweep of the listed tiles by mode (UF, FORCE or DP).

    atoms (Npad, 8) f32 sorted rows [x y z w q sig/2 sqrt(eps) valid],
    row_start/row_count (nB,) and col_ids (max_tiles,) int32 in CSR form,
    scalars (5,) f32 [bx by bz beta cutoff], es_coeffs None (exact
    electrostatics, erfc), AS7126 (the JAX kernel's A&S 7.1.26) or the (h,
    h') series of es_switch_poly_coeffs, triangular as the lists were built.
    A CUDA tensor launches the kernel of csrc/nb_tiles.cu on the current
    stream (with int64 fixed-point and sub-tile box scratch in triangular
    form; NaN where a sum leaves the fixed-point range); the kernel is built
    for the triangular form in DP (exact and A&S), F (exact) and UF (exact
    and poly), and for the symmetric form in DP (exact and A&S) and F
    (exact), and refuses any other. A CPU tensor runs nb_tiles_plain (in atoms'
    dtype)."""
    if atoms.device.type == "cpu":
        return nb_tiles_plain(atoms, row_start, row_count, col_ids, scalars, mode, cb, es_coeffs, triangular)
    if atoms.device.type != "cuda":
        raise ValueError(f"nb_tiles: no kernel for device {atoms.device}")
    _check_args(atoms, row_start, row_count, col_ids, scalars, mode, cb, es_coeffs)
    h_arg = hp_arg = None
    es_form = 2 if _is_series(es_coeffs) else int(es_coeffs == AS7126)
    if es_form == 2:
        if es_coeffs not in _series_args:
            _series_args[es_coeffs] = tuple((ctypes.c_float * len(c))(*c) for c in es_coeffs)
        h_arg, hp_arg = _series_args[es_coeffs]
    dev = atoms.device
    n_pad = atoms.shape[0]
    out = torch.empty((n_pad, 4), dtype=torch.float32, device=dev)
    # triangular: (4, Npad) fixed-point sums and an overflow flag; (Npad / 32, 8) group boxes
    acc = torch.zeros(4 * n_pad + 1 if triangular else 0, dtype=torch.int64, device=dev)
    boxes = torch.empty(n_pad // GROUP * 8 if triangular else 0, dtype=torch.float32, device=dev)
    rc = _launcher()(
        atoms.data_ptr(), row_start.data_ptr(), row_count.data_ptr(), col_ids.data_ptr(), scalars.data_ptr(),
        out.data_ptr(), acc.data_ptr(), boxes.data_ptr(), n_pad // BLOCK, cb, mode, int(triangular), es_form, h_arg, hp_arg,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"nb_tiles: kernel launch failed with CUDA error {rc}")
    nb_tiles.launches += 1
    nb_tiles.launches_by_form[mode, bool(triangular), ("exact", "as7126", "poly")[es_form]] += 1
    return out


nb_tiles.launches = 0
nb_tiles.launches_by_form = Counter()  # (mode, triangular, electrostatics) -> launches, never zeroed


def poison_on_overflow(overflow, val):
    """NaN where the list overflowed: a sweep that dropped tiles must not
    pass for a right answer."""
    return torch.where(overflow > 0, torch.nan, val)


def _sweep(conf, params, box, beta, cutoff, max_tiles, mode, cb, es_coeffs=None, atom_mask=None):
    """(Npad, 4) sweep over triangular lists built for this call, with the
    inverse order."""
    tiles = build_block_tiles(conf, params, box, cutoff, max_tiles, cb, triangular=True, atom_mask=atom_mask)
    out = nb_tiles(
        tiles.atoms, tiles.row_start, tiles.row_count, tiles.col_ids, tile_scalars(box.to(conf.dtype), beta, cutoff),
        mode, cb, es_coeffs, triangular=True,
    )
    return out, torch.argsort(tiles.pad_order[: conf.shape[0]]), tiles.overflow


def run_uf(conf, params, box, beta, cutoff, max_tiles, es_coeffs=None, cb: int = 1, atom_mask=None, energy_dtype=None):
    """One UF pass over triangular lists of max_tiles (size it with
    suggest_max_tiles(..., triangular=True)): (total energy, dU/dx), NaN on
    list overflow; the per-atom energies summed in energy_dtype (None:
    theirs). atom_mask (N,) bool, where given, restricts the pairs to its
    atoms (JAX's _run_uf(atom_mask=))."""
    out, inv, overflow = _sweep(conf, params, box, beta, cutoff, max_tiles, UF, cb, es_coeffs, atom_mask)
    u = torch.sum(out[:, 0], dtype=energy_dtype)
    return poison_on_overflow(overflow, u), poison_on_overflow(overflow, out[inv, 1:4])


def run_dp(conf, params, box, beta, cutoff, max_tiles, cb: int = 1, atom_mask=None, es_coeffs=AS7126):
    """One DP pass over triangular lists of max_tiles: (N, 4) dU/dp in
    params' column order [q, sig/2, sqrt(eps), w], NaN on list overflow;
    zero for atoms outside atom_mask (N,) bool, where given (JAX's
    _run_dp(atom_mask=)). es_coeffs AS7126 (the default) is JAX's _run_dp
    electrostatics, None exact erfc."""
    out, inv, overflow = _sweep(conf, params, box, beta, cutoff, max_tiles, DP, cb, es_coeffs, atom_mask)
    return poison_on_overflow(overflow, out[inv])


class StashedGradEnergy(torch.autograd.Function):
    """u(conf, params, box) whose forward pass also returns dU/dx, stashed
    for the backward pass, and whose dU/dp comes from a separate pass run
    only when params needs a gradient. The box gets no gradient (no virial,
    as in the JAX package). Differentiating twice raises: a backward pass
    run with create_graph=True stops with an error, since the kernels have
    no backward of their own."""

    @staticmethod
    def forward(ctx, conf, params, box, energy_grad_fn, dp_fn):
        u, du_dx = energy_grad_fn(conf, params, box)
        ctx.save_for_backward(conf, params, box, du_dx)
        ctx.dp_fn = dp_fn
        return u

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError("StashedGradEnergy: cannot differentiate twice (backward with create_graph=True)")
        conf, params, box, du_dx = ctx.saved_tensors
        g_conf = (g * du_dx).to(conf.dtype) if ctx.needs_input_grad[0] else None
        g_params = (g * ctx.dp_fn(conf, params, box)).to(params.dtype) if ctx.needs_input_grad[1] else None
        return g_conf, g_params, None, None, None


def make_nonbonded_tiles(beta: float, cutoff: float, max_tiles: int, cb: int = 1, atom_mask=None):
    """Differentiable energy(conf, params, box): the forward runs one UF
    pass (exact electrostatics, erfc) and stashes dU/dx; dU/dp comes from a
    DP pass in the same electrostatics (counterpart of
    make_nonbonded_pallas, whose passes take A&S 7.1.26); both see only the
    atoms of atom_mask (N,) bool, where given."""

    def energy_grad(conf, params, box):
        return run_uf(conf, params, box, beta, cutoff, max_tiles, cb=cb, atom_mask=atom_mask)

    def dp(conf, params, box):
        return run_dp(conf, params, box, beta, cutoff, max_tiles, cb=cb, atom_mask=atom_mask, es_coeffs=None)

    def energy(conf, params, box):
        return StashedGradEnergy.apply(conf, params, box, energy_grad, dp)

    return energy


def make_nonbonded_tiles_energy_force(
    beta: float, cutoff: float, max_tiles: int, es: str = "exact", cb: int = 1, atom_mask=None,
):
    """(conf, params, box, energy_dtype=None) -> (u, force) in one UF pass
    over lists built for the call (counterpart of
    make_nonbonded_pallas_energy_force), the per-atom energies summed in
    energy_dtype (None: theirs), only the pairs of atom_mask (N,) bool where
    given. es="poly" evaluates the electrostatics as the Clenshaw series of
    es_switch_poly_coeffs, which pins cutoff to the switch's 1.2 nm."""
    if es not in ("exact", "poly"):
        raise ValueError(f"es must be 'exact' or 'poly', got {es!r}")
    es_coeffs = None
    if es == "poly":
        if cutoff != SWITCH_CUTOFF:
            raise ValueError("poly electrostatics pins cutoff == SWITCH_CUTOFF")
        es_coeffs = es_switch_poly_coeffs(beta, cutoff)

    def energy_force(conf, params, box, energy_dtype=None):
        u, du_dx = run_uf(
            conf, params, box, beta, cutoff, max_tiles, es_coeffs=es_coeffs, cb=cb, atom_mask=atom_mask,
            energy_dtype=energy_dtype,
        )
        return u, -du_dx

    return energy_force


class ListState(NamedTuple):
    """An MD provider's state between rebuilds."""

    lists: NamedTuple  # the layout's lists as built (pad_order first)
    inv: torch.Tensor  # (N,) sorted slot of each atom
    prows: torch.Tensor  # sorted parameter rows, cached at rebuild
    invalid: torch.Tensor  # () int: nonzero where the lists must not be trusted (overflow, a broken invariant)
    image: torch.Tensor | None = None  # (N, 3) whole boxes the build wrapped each atom by, where the layout keeps it


def make_list_md_provider(build, sweep, force_mode: int, energy_mode: int, rebuild_interval: int, prows_fn=None):
    """The stateful MD force provider of every list layout (counterpart of
    make_tile_md_provider in the JAX rowscan module):

      build(conf, params, box) -> ListState        lists at cutoff + skin
      sweep(state, conf, box, mode) -> (Npad, 4)   [u_i, dU/dx_i], sorted
      prows_fn(params, pad_order) -> prows         the layout's parameter rows

    The lists are rebuilt when the step t is a multiple of rebuild_interval;
    the sweep's gate applies the bare cutoff. Returns (init_fn, apply_fn,
    energy_fn, energy_with_params_fn):

      init_fn(conf, params, box) -> state
      apply_fn(state, conf, params, box, t) -> (force, state)    force_mode sweep
      energy_fn(state, conf, params, box) -> energy              energy_mode sweep
      energy_with_params_fn(state, conf, params, box) -> energy  the same under
          other parameters: their rows re-gathered through the cached order
          (JAX's energy_with_params_fn; raises without prows_fn)

    All are NaN where state.invalid is nonzero. The parameter rows are
    cached at rebuild: params must not change between rebuilds. The
    energies run through the cached lists, valid for any conf within skin/2
    of the build conf, which covers a barostat trial move. t is the host's
    step count, so the rebuild decision reads nothing from the device."""

    def apply_fn(state, conf, params, box, t: int):
        if t % rebuild_interval == 0:
            state = build(conf, params, box)
        out = sweep(state, conf, box, force_mode)
        return poison_on_overflow(state.invalid, -out[state.inv, 1:4]), state

    def energy_fn(state, conf, params, box):
        return poison_on_overflow(state.invalid, torch.sum(sweep(state, conf, box, energy_mode)[:, 0]))

    def energy_with_params_fn(state, conf, params, box):
        if prows_fn is None:
            raise NotImplementedError("this list layout has no energy under other parameters")
        return energy_fn(state._replace(prows=prows_fn(params.to(conf.dtype), state.lists.pad_order)), conf, params, box)

    return build, apply_fn, energy_fn, energy_with_params_fn


class BatchedListState(NamedTuple):
    """A batched MD provider's state between rebuilds: K replicas' lists
    stacked at one capacity."""

    lists: NamedTuple  # the layout's lists, each field (K, ...)
    inv: torch.Tensor  # (K, N) sorted slot of each atom
    prows: torch.Tensor  # (K, Npad, 4) sorted parameter rows, cached at rebuild
    invalid: torch.Tensor  # (K,) nonzero where a replica's lists must not be trusted


def make_batched_list_md_provider(
    build, sweep_batched, prows_fn, force_mode: int, energy_mode: int, rebuild_interval: int,
):
    """The MD force provider of K replicas of one system, stepped together
    (the counterpart of the JAX provider under jax.vmap over replicas):

      build(conf, params, box) -> ListState    one replica's lists, as make_list_md_provider's
      sweep_batched(state, xyz, prows, box, lists_of, mode) -> (B, Npad, 4)
          B systems in one sweep: coordinates xyz (B, N, 3) [or (K, N, 3)
          broadcast], prows (B, Npad, 4), box (B, 3, 3), lists_of (B,) the
          replica whose lists each system reads
      prows_fn(params, pad_order) -> prows     the layout's parameter rows

    Returns (init_fn, apply_fn, energy_fn, energy_with_params_fn):

      init_fn(xs, params, boxes) -> state          K list builds, stacked
      apply_fn(state, xs, params, boxes, t) -> (forces (K, N, 3), state)
      energy_fn(state, xs, boxes) -> (K,)          one energy_mode sweep
      energy_with_params_fn(state, xs, params_sets, boxes) -> (K, S)
          each replica's energy under S parameter sets (K, S, N, 4), one
          energy_mode sweep of K * S systems through the replicas' lists,
          the per-atom energies summed in float64 (HREX's banded energies)

    The rebuild loops over the K replicas (a rebuild step's launches grow
    with K); every other step runs a fixed number of launches whatever K.
    A replica whose lists are invalid gets NaN, the others are untouched."""

    def init_fn(xs, params, boxes):
        states = [build(xs[k], params[k], boxes[k]) for k in range(xs.shape[0])]
        lists = type(states[0].lists)(*(torch.stack(f) for f in zip(*(st.lists for st in states))))
        return BatchedListState(
            lists, torch.stack([st.inv for st in states]), torch.stack([st.prows for st in states]),
            torch.stack([st.invalid for st in states]),
        )

    def _poison(state, val):
        return torch.where((state.invalid > 0).view(-1, *([1] * (val.dim() - 1))), torch.nan, val)

    def apply_fn(state, xs, params, boxes, t: int):
        if t % rebuild_interval == 0:
            state = init_fn(xs, params, boxes)
        lists_of = torch.arange(xs.shape[0], device=xs.device, dtype=torch.int32)
        out = sweep_batched(state, xs, state.prows, boxes, lists_of, force_mode)
        force = -torch.take_along_dim(out[..., 1:4], state.inv[..., None], dim=-2)
        return _poison(state, force), state

    def energy_fn(state, xs, boxes):
        lists_of = torch.arange(xs.shape[0], device=xs.device, dtype=torch.int32)
        return _poison(state, torch.sum(sweep_batched(state, xs, state.prows, boxes, lists_of, energy_mode)[..., 0], -1))

    def energy_with_params_fn(state, xs, params_sets, boxes):
        k, s = params_sets.shape[:2]
        pad_order = state.lists.pad_order[:, None, :].expand(k, s, -1)
        prows = prows_fn(params_sets.to(xs.dtype), pad_order).reshape(k * s, *state.prows.shape[1:])
        lists_of = torch.arange(k, device=xs.device, dtype=torch.int32).repeat_interleave(s)
        out = sweep_batched(state, xs, prows, boxes, lists_of, energy_mode)
        return _poison(state, torch.sum(out[..., 0], -1, dtype=torch.float64).view(k, s))

    return init_fn, apply_fn, energy_fn, energy_with_params_fn


def make_nonbonded_tiles_md(
    beta: float, cutoff: float, max_tiles: int, skin: float = 0.1, rebuild_interval: int = 20, cb: int = 1,
    atom_mask=None,
):
    """MD force provider over triangular block tiles (counterpart of
    make_nonbonded_pallas_md): an F pass per step, a UF pass for the
    energy; see make_list_md_provider. Size max_tiles with
    suggest_max_tiles(..., triangular=True). atom_mask (N,) bool, where
    given, leaves the other atoms out of the lists' boxes and pairs, as in
    JAX (its energy under other parameters keeps them out too)."""

    def build(conf, params, box):
        tiles = build_block_tiles(conf, params, box, cutoff + skin, max_tiles, cb, triangular=True, atom_mask=atom_mask)
        return ListState(tiles, torch.argsort(tiles.pad_order[: conf.shape[0]]), tiles.atoms[:, 3:], tiles.overflow)

    def sweep(state, conf, box, mode):
        t = state.lists
        atoms = assemble_atoms(conf, box, t.pad_order, state.prows)
        return nb_tiles(
            atoms, t.row_start, t.row_count, t.col_ids, tile_scalars(box, beta, cutoff), mode, cb, triangular=True
        )

    def prows_fn(params, pad_order):
        return param_rows(params, pad_order, params.shape[-2], atom_mask)

    return make_list_md_provider(build, sweep, FORCE, UF, rebuild_interval, prows_fn=prows_fn)
