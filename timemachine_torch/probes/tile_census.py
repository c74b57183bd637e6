"""Tile census of the pair sweep (counterpart of the CPU census in
scripts/probe_bf16.py::probe_census and of the helpers it takes from
scripts/probe_slots.py): on a configuration sorted along a Hilbert curve
and cut into 32-atom row chunks and 128-atom column chunks, the tiles the
production pipeline sweeps (Newton-triangular loop tiles culled by the
boxes' gap at cutoff + skin, then chopped at the bare cutoff each step),
and how many of those hold no pair within the cutoff. That share is the
most a tile-granular skip (a bf16 distance prefilter, say) could remove.

`tile_census(conf, box, device)` runs in f64 on any device; the exact
per-tile test runs in batches of tiles, so on a card it takes milliseconds.
`python -m timemachine_torch.probes.bf16_rate` prints it for the DHFR
start.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from timemachine_torch.device import resolve_device
from timemachine_torch.ops.nonbonded_kernel import hilbert_keys

ROW, COL = 32, 128
CUTOFF, SKIN = 1.2, 0.1
TILE_BATCH = 256  # tiles per batch of the exact test


class TileCensus(NamedTuple):
    n_atoms: int
    row_chunks: int
    col_chunks: int
    built: int  # loop tiles kept by the build-time cull at cutoff + skin
    chopped: int  # of those, kept by the per-step chop at the cutoff
    empty: int  # of those, tiles with no pair within the cutoff
    hits: int  # pairs within the cutoff in the chopped tiles
    slots: int  # pair slots the chopped tiles sweep

    @property
    def skip_ceiling(self) -> float:
        """Share of the swept tiles a tile-granular skip could remove."""
        return self.empty / max(self.chopped, 1)


def hilbert_order(conf, box):
    """(order, wrapped): the atoms' order along the Hilbert curve of their
    f32 fractional positions in the box, and the positions wrapped into it
    (f64), as scripts/probe_slots.py::hilbert_order computes them."""
    diag = torch.diagonal(box)
    wrapped = conf - diag * torch.floor(conf / diag)
    frac = wrapped / diag
    frac = frac - torch.floor(frac)
    return torch.argsort(hilbert_keys(frac.to(torch.float32)), stable=True), wrapped


def chunk_bboxes(xs, size: int):
    """(min, max) corners of each whole chunk of `size` consecutive rows."""
    nc = xs.shape[0] // size
    xr = xs[: nc * size].reshape(nc, size, 3)
    return xr.amin(dim=1), xr.amax(dim=1)


def gap2(rmin, rmax, cmin, cmax, box_diag):
    """(n_row, n_col) squared gap between each row box and each column box
    under the minimum image of their centers."""
    rcen, rhal = 0.5 * (rmin + rmax), 0.5 * (rmax - rmin)
    ccen, chal = 0.5 * (cmin + cmax), 0.5 * (cmax - cmin)
    dc = rcen[:, None, :] - ccen[None, :, :]
    dc = dc - box_diag * torch.floor(dc / box_diag + 0.5)
    gap = torch.clamp(torch.abs(dc) - (rhal[:, None, :] + chal[None, :, :]), min=0.0)
    g = gap * gap
    return (g[..., 0] + g[..., 1]) + g[..., 2]


def tile_census(conf, box, device=None) -> TileCensus:
    """The census of (N, 3+) positions `conf` in the orthorhombic (3, 3)
    `box` (numpy or tensors; computed in f64 on `device`)."""
    dev = resolve_device(device)
    conf = torch.as_tensor(np.asarray(conf, np.float64)[:, :3], device=dev)
    box = torch.as_tensor(np.asarray(box, np.float64), device=dev)
    diag = torch.diagonal(box)
    n = conf.shape[0]
    order, wrapped = hilbert_order(conf, box)
    n_pad = -(-n // COL) * COL
    ghost = diag / 2.0 + 100.0  # padding atoms far from everything
    xs = torch.cat([wrapped[order], ghost.expand(n_pad - n, 3)])
    n_row, n_col = n_pad // ROW, n_pad // COL
    g2 = gap2(*chunk_bboxes(xs, ROW), *chunk_bboxes(xs, COL), diag)
    rows = torch.arange(n_row, device=dev)[:, None]
    cols = torch.arange(n_col, device=dev)[None, :]
    loop = rows * ROW >= (cols + 1) * COL  # row chunks past the column chunk's own rows
    built = loop & (g2 <= (CUTOFF + SKIN) ** 2)
    chopped = built & (g2 <= CUTOFF**2)

    ri, ci = torch.nonzero(chopped, as_tuple=True)
    xr_all, xc_all = xs.reshape(n_row, ROW, 3), xs.reshape(n_col, COL, 3)
    empty = hits = 0
    for s in range(0, ri.shape[0], TILE_BATCH):
        d = xr_all[ri[s : s + TILE_BATCH], :, None, :] - xc_all[ci[s : s + TILE_BATCH], None, :, :]
        d = d - diag * torch.round(d / diag)
        dd = d * d
        k = (((dd[..., 0] + dd[..., 1]) + dd[..., 2]) < CUTOFF**2).sum(dim=(1, 2))
        hits += int(k.sum())
        empty += int((k == 0).sum())
    n_chop = int(chopped.sum())
    return TileCensus(n, n_row, n_col, int(built.sum()), n_chop, empty, hits, n_chop * ROW * COL)


def describe(c: TileCensus) -> str:
    """One line of the census' counts and shares."""
    return (
        f"{c.n_atoms} atoms, {c.row_chunks} row chunks x {c.col_chunks} column chunks; tiles built {c.built}, "
        f"after the chop {c.chopped}, with no pair within the cutoff {c.empty} ({100 * c.skip_ceiling:.2f}%: the "
        f"skip ceiling); swept slots {c.slots}, within the cutoff {c.hits} ({100 * c.hits / max(c.slots, 1):.1f}%)"
    )

