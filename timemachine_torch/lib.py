"""The utility surface of the JAX package's lib.py (the port of
timemachine_tpu/lib.py): spatial sort, block neighbour lists, segmented
logsumexp, segmented weighted sampling, per-molecule nonbonded energies and
the hardware helpers.

Each class computes in torch on the device it is given (None: the card)
and returns what JAX's returns: numpy permutations and energies, Python
lists. The sort, the lists and the logsumexp run in float64 in JAX's
arithmetic, so they equal JAX's; NonbondedMolEnergy computes in float64
too, as the exchange movers that it serves do (ROADMAP P29). The sampler
draws its uniforms from a torch.Generator seeded with `seed` where JAX
splits a threefry key (ROADMAP P32). The `_f32`/`_f64` aliases name one
class each, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.device import resolve_device
from timemachine_torch.ops.nonbonded import nonbonded_block_unsummed
from timemachine_torch.ops.nonbonded_kernel import HILBERT_BITS, hilbert_keys

f64 = torch.float64


class InvalidHardware(Exception):
    """Raised when no usable accelerator is present."""


def device_reset() -> None:
    """Release the caching allocator's unused blocks on the card and drop
    the port's cached fitted series. Switches no device."""
    from timemachine_torch.ops import nonbonded, nonbonded_kernel, rowscan_kernel

    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    rowscan_kernel._poly_cache.clear()
    nonbonded_kernel._es_poly_cache.clear()
    nonbonded._poly_derivative.cache_clear()


def _wrap(coords, box_diag):
    return coords - box_diag * torch.floor(coords / box_diag)


class HilbertSort:
    """Spatial sort on a 2^bits-per-axis grid mapped to the Hilbert curve.
    Each atom's cell takes its curve index from hilbert_keys at the cell's
    centre: the entry of JAX's table of every cell (its hilbert_lut), which
    the port does not tabulate."""

    def __init__(self, size: int, bits: int = HILBERT_BITS, device=None):
        self.size = size
        self.bits = bits
        self.device = resolve_device(device)

    def sort(self, coords, box) -> np.ndarray:
        """Permutation (uint32) ordering atoms along the Hilbert curve after
        wrapping into the box."""
        coords = torch.as_tensor(np.asarray(coords)[:, :3], device=self.device, dtype=f64)
        box_diag = torch.diagonal(torch.as_tensor(np.asarray(box), device=self.device, dtype=f64))
        frac = torch.clamp(_wrap(coords, box_diag) / box_diag, 0.0, float(np.nextafter(1.0, 0.0)))
        dim = 1 << self.bits
        cell = torch.clamp((frac * dim).to(torch.int64), max=dim - 1)
        d = hilbert_keys((cell.to(f64) + 0.5) / dim, self.bits)
        return torch.argsort(d, stable=True).cpu().numpy().astype(np.uint32)


class Neighborlist:
    """Block-bounds neighbour list: 32-atom row blocks' bounding boxes and,
    for each, the candidate atoms within a cutoff of the box. Supports the
    row-idxs subset mode of interaction groups."""

    BLOCK = 32
    # (row blocks x atoms) distance slots computed at once
    SLOTS = 1 << 22

    def __init__(self, N: int, device=None):
        self._n = N
        self.device = resolve_device(device)
        self._row_idxs: np.ndarray | None = None
        self._last_ixn_count = 0

    def resize(self, size: int) -> None:
        if size <= 0:
            raise RuntimeError("size must be at least 1")
        self._n = size
        self._row_idxs = None

    def set_row_idxs(self, idxs) -> None:
        idxs = np.asarray(idxs, dtype=np.uint32)
        if idxs.size >= self._n:
            raise RuntimeError("number of idxs must be less than N")
        self._row_idxs = idxs

    def reset_row_idxs(self) -> None:
        self._row_idxs = None

    def get_num_row_idxs(self) -> int:
        return self._n if self._row_idxs is None else len(self._row_idxs)

    def _coords(self, coords, box):
        coords = np.asarray(coords)[:, :3]
        if len(coords) != self._n:
            raise RuntimeError(f"N={self._n} coords={len(coords)}")
        x = torch.as_tensor(coords, device=self.device, dtype=f64)
        box_diag = torch.diagonal(torch.as_tensor(np.asarray(box), device=self.device, dtype=f64))
        return _wrap(x, box_diag), box_diag

    def _row_ids(self):
        return None if self._row_idxs is None else torch.as_tensor(self._row_idxs.astype(np.int64), device=self.device)

    def compute_block_bounds(self, coords, box, block_size: int = 32):
        """(centers, extents), numpy (blocks, 3), of ceil(R/block)-atom row
        blocks after wrapping; the last block is padded with its last row."""
        wrapped, _ = self._coords(coords, box)
        rows = self._row_ids()
        if rows is not None:
            wrapped = wrapped[rows]
        n_blocks = -(-len(wrapped) // block_size)
        pad = n_blocks * block_size - len(wrapped)
        padded = torch.cat([wrapped, wrapped[-1:].expand(pad, 3)]).reshape(n_blocks, block_size, 3)
        bmin, bmax = padded.amin(dim=1), padded.amax(dim=1)
        return (0.5 * (bmin + bmax)).cpu().numpy(), (0.5 * (bmax - bmin)).cpu().numpy()

    def get_nblist(self, coords, box, cutoff) -> list[list[int]]:
        """Per row block, the candidate atom indices: every atom whose
        minimum-image distance to the block's bounding box is < cutoff. With
        all atoms as rows the lists are upper-triangular (atoms at or after
        the block's first); with row_idxs set they hold the column atoms (the
        complement of row_idxs)."""
        wrapped, box_diag = self._coords(coords, box)
        rows_ids = self._row_ids()
        rows = wrapped if rows_ids is None else wrapped[rows_ids]
        if rows_ids is None:
            col_ids = torch.arange(self._n, device=self.device)
        else:
            mask = torch.ones(self._n, dtype=torch.bool, device=self.device)
            mask[rows_ids] = False
            col_ids = torch.nonzero(mask)[:, 0]
        cols = wrapped[col_ids]

        B = self.BLOCK
        n_rows = len(rows)
        n_blocks = -(-n_rows // B)
        pad = n_blocks * B - n_rows
        # pad with +inf/-inf so that the min/max of a partial block are its own rows'
        lo = torch.cat([rows, rows.new_full((pad, 3), float("inf"))]).reshape(n_blocks, B, 3).amin(dim=1)
        hi = torch.cat([rows, rows.new_full((pad, 3), float("-inf"))]).reshape(n_blocks, B, 3).amax(dim=1)
        cen, hal = 0.5 * (lo + hi), 0.5 * (hi - lo)
        cut2 = cutoff * cutoff
        step = max(1, self.SLOTS // max(1, len(cols)))
        out: list[list[int]] = []
        for b0 in range(0, n_blocks, step):
            d = cen[b0 : b0 + step, None, :] - cols[None]
            d = d - box_diag * torch.round(d / box_diag)
            gap = torch.clamp(torch.abs(d) - hal[b0 : b0 + step, None, :], min=0.0)
            hit = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] + gap[..., 2] * gap[..., 2] < cut2
            if rows_ids is None:
                first = (torch.arange(b0, min(b0 + step, n_blocks), device=self.device) * B)[:, None]
                hit &= col_ids[None, :] >= first
            blk, j = torch.nonzero(hit, as_tuple=True)
            ids = col_ids[j].cpu().numpy()
            counts = torch.bincount(blk, minlength=hit.shape[0]).cpu().numpy()
            out.extend(a.tolist() for a in np.split(ids, np.cumsum(counts)[:-1]))
        self._last_ixn_count = sum(len(ids) for ids in out)
        return out

    def get_tile_ixn_count(self) -> int:
        """Interactions found by the most recent get_nblist call."""
        return self._last_ixn_count

    def get_max_ixn_count(self) -> int:
        n_blocks = -(-self.get_num_row_idxs() // self.BLOCK)
        return n_blocks * self.BLOCK * self._n


class SegmentedSumExp:
    """Segmented logsumexp: max + log sum exp(v - max) per segment, float64."""

    def __init__(self, max_vals_per_segment: int, num_segments: int, device=None):
        self.max_vals_per_segment = max_vals_per_segment
        self.num_segments = num_segments
        self.device = resolve_device(device)

    def logsumexp(self, values: list) -> list[float]:
        if len(values) > self.num_segments:
            raise RuntimeError(f"got {len(values)} segments, configured for {self.num_segments}")
        out = []
        for seg in values:
            seg = torch.as_tensor(np.asarray(seg, dtype=np.float64), device=self.device)
            if seg.numel() > self.max_vals_per_segment:
                raise RuntimeError("segment exceeds max_vals_per_segment")
            if seg.numel() == 0:
                out.append(-np.inf)
                continue
            m = torch.max(seg)
            out.append(float(m + torch.log(torch.sum(torch.exp(seg - m)))))
        return out


class SegmentedWeightedRandomSampler:
    """Per-segment categorical draws from unnormalized weights: the arg-max
    of log w + Gumbel noise, the noise -log(-log u) of uniforms from a
    torch.Generator seeded with `seed`."""

    def __init__(self, max_vals_per_segment: int, segments: int, seed: int, device=None):
        self.max_vals_per_segment = max_vals_per_segment
        self.segments = segments
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

    def sample(self, weights: list) -> list[int]:
        if len(weights) > self.segments:
            raise RuntimeError(f"got {len(weights)} segments, configured for {self.segments}")
        out = []
        for seg in weights:
            seg = np.asarray(seg, dtype=np.float64)
            if seg.size > self.max_vals_per_segment:
                raise RuntimeError("segment exceeds max_vals_per_segment")
            if np.any(seg < 0) or not np.all(np.isfinite(seg)) or np.sum(seg) <= 0:
                raise RuntimeError("weights must be finite, non-negative, with positive sum")
            u = torch.rand(seg.size, generator=self._gen, device=self.device, dtype=f64)
            u = torch.clamp(u, min=torch.finfo(f64).tiny)
            gumbel = -torch.log(-torch.log(u))
            out.append(int(torch.argmax(torch.log(torch.as_tensor(seg, device=self.device)) + gumbel)))
        return out


HilbertSort_f32 = HilbertSort_f64 = HilbertSort
Neighborlist_f32 = Neighborlist_f64 = Neighborlist
SegmentedSumExp_f32 = SegmentedSumExp_f64 = SegmentedSumExp
SegmentedWeightedRandomSampler_f32 = SegmentedWeightedRandomSampler_f64 = SegmentedWeightedRandomSampler


class NonbondedMolEnergy:
    """Per-molecule interaction energy of each target molecule with the rest
    of the system (the exchange movers' inner loop), float64 on `device`.

    target_mols: atom-index lists. Molecules of one size go through
    nonbonded_block_unsummed together, in chunks of molecules; ragged ones
    one at a time. A molecule's own columns are zeroed and a NaN pair (a
    coincident atom) counts +inf, as in JAX's."""

    # (molecules x atoms x all atoms) slots of one chunk, by device type
    SLOTS = {"cpu": 1 << 20, "cuda": 1 << 22}

    def __init__(self, num_atoms: int, target_mols, beta: float, cutoff: float, device=None):
        self.num_atoms = num_atoms
        self.beta = beta
        self.cutoff = cutoff
        self.device = resolve_device(device)
        mols = [np.asarray(m, dtype=np.int64) for m in target_mols]
        self._uniform = len({len(m) for m in mols}) == 1
        owner = np.full(num_atoms, len(mols), dtype=np.int64)
        for mol_idx, m in enumerate(mols):
            owner[m] = mol_idx
        self._owner = torch.as_tensor(owner, device=self.device)
        if self._uniform:
            self._groups = [torch.as_tensor(np.stack(mols), device=self.device)]
        else:
            self._groups = [torch.as_tensor(m[None], device=self.device) for m in mols]

    def _energies(self, conf, params, box, idx, first: int):
        u = nonbonded_block_unsummed(conf[idx], conf, box, params[idx], params, self.beta, self.cutoff)
        u = torch.where(torch.isnan(u), torch.inf, u)
        mol_ids = torch.arange(first, first + idx.shape[0], device=self.device)
        u = torch.where((self._owner[None, :] == mol_ids[:, None])[:, None, :], 0.0, u)
        return torch.sum(u, dim=(1, 2))

    def execute(self, coords, params, box) -> np.ndarray:
        conf = torch.as_tensor(np.asarray(coords), device=self.device, dtype=f64)
        params = torch.as_tensor(np.asarray(params), device=self.device, dtype=f64)
        box = torch.as_tensor(np.asarray(box), device=self.device, dtype=f64)
        out, first = [], 0
        with torch.no_grad():
            for idx in self._groups:
                chunk = max(1, self.SLOTS[self.device.type] // (idx.shape[1] * self.num_atoms))
                for c0 in range(0, idx.shape[0], chunk):
                    out.append(self._energies(conf, params, box, idx[c0 : c0 + chunk], first + c0))
                first += idx.shape[0]
        return torch.cat(out).cpu().numpy()


NonbondedMolEnergy_f32 = NonbondedMolEnergy_f64 = NonbondedMolEnergy
