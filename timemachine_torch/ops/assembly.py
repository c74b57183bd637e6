"""One shared force assembly for irregular term lists (counterpart of
timemachine_tpu/ops/assembly.py).

The Context's step gathers every per-term force contribution of its
irregular lists (the bonded tails past the leading waters, the exclusion
tail of the nonbonded term) into one flat array and sums it per atom once:

1. each term gives per-role force contributions in its term order (one
   (T, 3) tensor a role);
2. a host-side plan orders the contribution slots by receiving atom: a
   stable argsort, group-major then role-major, exactly as JAX builds it;
3. each atom's contiguous run in that order is summed by the port's
   fixed-order two-level SegmentSum.

JAX sums each run as a difference of a running prefix sum, which in float32
carries rounding from the prefix's magnitude (about 1e-4 relative at DHFR's
scale, its module says). The SegmentSum computes the same function with
sums of at most 32 members and then of the pieces, in one fixed order: no
atomics and no index_add_, and bitwise on repeat on any device (ROADMAP P39).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from timemachine_torch.ops.segment import SegmentSum


@dataclass(frozen=True, eq=False)
class ContribPlan:
    """Assembly plan over a fixed set of term-index groups.

    The flat contribution index space lays the groups out in order, each
    group role-major: the contribution of term t, role r in group g is at
    offset_g + r * T_g + t. Rows with any -1 are padding: their slots sort
    to a trailing sentinel segment past the last atom."""

    perm: np.ndarray  # (L,) int32: atom-major position -> flat contribution index
    starts: np.ndarray  # (n_atoms + 1,) int32: boundaries into the atom-major order
    n_atoms: int
    group_shapes: tuple  # ((T_g, arity_g), ...) for layout checks
    segment_sum: SegmentSum  # the per-atom runs, members in perm's order


def build_contrib_plan(groups, n_atoms: int, device=None) -> ContribPlan:
    """groups: list of (T_g, arity_g) int index arrays (host-side, once per
    Context). The SegmentSum's tables live on `device` (None: the card)."""
    atoms, shapes = [], []
    for idxs in groups:
        idxs = np.asarray(idxs)
        t_g, arity = idxs.shape
        shapes.append((int(t_g), int(arity)))
        pad = np.any(idxs < 0, axis=1)
        for r in range(arity):
            atoms.append(np.where(pad, n_atoms, idxs[:, r].astype(np.int64)))  # sentinel: past the last atom
    atom_of = np.concatenate(atoms) if atoms else np.zeros((0,), np.int64)
    perm = np.argsort(atom_of, kind="stable").astype(np.int32)
    starts = np.searchsorted(atom_of[perm], np.arange(n_atoms + 1)).astype(np.int32)
    # SegmentSum's own order is this stable argsort: each atom's members are
    # summed in their run's order of perm
    segment_sum = SegmentSum(atom_of, n_atoms + 1, device=device)
    return ContribPlan(perm=perm, starts=starts, n_atoms=n_atoms, group_shapes=tuple(shapes), segment_sum=segment_sum)


def assemble_forces(plan: ContribPlan, contribs):
    """contribs: list over groups of lists over roles of (T_g, 3) tensors, in
    the plan's group order. Returns the (n_atoms, 3) summed force."""
    flat = [c for group in contribs for c in group]
    if not flat:
        raise ValueError("assemble_forces called with no contributions")
    c = torch.cat(flat)
    if c.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"{c.shape[0]} contributions for a plan of {plan.perm.shape[0]}")
    return plan.segment_sum(c)[: plan.n_atoms]
