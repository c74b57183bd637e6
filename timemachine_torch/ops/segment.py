"""Fixed-order segment sums: the port's scatter-add for per-term forces.

A scatter-add with atomics (`index_add_` on CUDA) sums in whatever order the
threads arrive, so the same step gives different low bits from run to run.
`SegmentSum` instead gathers each segment's members through a padded index
table built once on the host and sums along a fixed axis, in two levels so
that one large segment (a protein's centroid group) does not widen the
table for all others. Same inputs give bitwise-equal outputs on any device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class SegmentSum(nn.Module):
    """out[s] = sum of src[m] over all m with seg[m] == s.

    Members of a segment are split into pieces of at most `width` (in
    ascending member order); pieces are summed first, then each segment sums
    its pieces. Empty segments give 0.
    """

    def __init__(self, seg, n_segments: int, device=None, width: int = 32):
        super().__init__()
        seg = np.asarray(seg, dtype=np.int64).ravel()
        if seg.size and (seg.min() < 0 or seg.max() >= n_segments):
            raise ValueError("segment id out of range")
        m = seg.size
        counts = np.bincount(seg, minlength=n_segments)
        width = int(max(1, min(width, counts.max(initial=1))))
        order = np.argsort(seg, kind="stable")
        pos = np.arange(m) - np.repeat(np.cumsum(counts) - counts, counts)  # rank within segment
        n_pieces = -(-counts // width)
        piece_base = np.cumsum(n_pieces) - n_pieces
        piece = np.repeat(piece_base, counts) + pos // width
        n_total = int(n_pieces.sum())
        piece_table = np.full((n_total, width), m, dtype=np.int64)  # m: the appended zero row
        piece_table[piece, pos % width] = order
        depth = int(max(1, n_pieces.max(initial=1)))
        seg_table = np.full((n_segments, depth), n_total, dtype=np.int64)
        rows = np.repeat(np.arange(n_segments), n_pieces)
        cols = np.arange(n_total) - np.repeat(piece_base, n_pieces)
        seg_table[rows, cols] = np.arange(n_total)
        self.register_buffer("piece_table", torch.as_tensor(piece_table, device=device))
        self.register_buffer("seg_table", torch.as_tensor(seg_table, device=device))

    def forward(self, src):
        zero = src.new_zeros((1, *src.shape[1:]))
        partial = torch.cat([src, zero])[self.piece_table].sum(1)
        return torch.cat([partial, zero])[self.seg_table].sum(1)
