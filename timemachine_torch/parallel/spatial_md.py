"""Spatially decomposed MD of one large system over a mesh (counterpart of
timemachine_tpu/parallel/spatial_md.py).

Every rank of the mesh runs the same Langevin BAOAB steps of the whole
system; each computes its share of the force, and one all-reduce of the
(N, 3) force a step sums the shares:

- the nonbonded sweep: the Newton-triangular rowscan lists (minimum image,
  with w) are built on every rank at cutoff + skin every
  `rebuild_interval` steps (the same sort on every rank), chopped to the
  bare cutoff every step, and each rank sweeps one contiguous slab of the
  snake-sorted row chunks through the kernel's row slab
  (ops/rowscan_kernel.rowscan_sweep with row_base, n_rows_local); atoms
  and lists are whole on every rank, as JAX replicates its columns;
- the exclusion pairs and the bonded term lists: block-partitioned over the
  ranks (_pad_terms' -1 rows dropped), each rank's block through the
  closed-form force functions (specific_pairs_energy_force,
  generic_bond/angle_energy_force, torsion_energy_force);
- an interaction group: its environment columns partitioned under a
  col_mask (ops/nonbonded.interaction_group_energy_force);
- any other term: replicated, its force by autograd divided by the rank
  count.

x, v and box stay replicated: the BAOAB update runs on every rank with
noise from one torch.Generator seeded with the run's seed, drawn in the
canonical (N, 3) shape as the port's Context draws it, so a one-rank run
is the Context's trajectory but for the order of the force's sums. With a
barostat the volume move runs replicated (the barostat's own generator on
every rank) on the all-reduced slab energies: the sweep alone, the
rigid-move energy, since the bonded and exclusion terms are intramolecular
and cancel in a molecule-rigid move's dU (as in JAX).

mesh None runs everything on this process. JAX's `interpret` argument has
no counterpart: the CPU runs the sweep's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.integrators import LangevinIntegrator, langevin_step
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.ops.bonded import generic_angle_energy_force, generic_bond_energy_force, torsion_energy_force
from timemachine_torch.ops.nonbonded import interaction_group_energy_force, specific_pairs_energy_force
from timemachine_torch.ops.nonbonded_kernel import poison_on_overflow
from timemachine_torch.ops.segment import SegmentSum
from timemachine_torch.parallel.mesh import all_reduce_sum, mesh_rank, mesh_size
from timemachine_torch.potentials import HarmonicAngle, HarmonicBond, Nonbonded, NonbondedInteractionGroup, PeriodicTorsion

_BONDED = ((HarmonicBond, generic_bond_energy_force), (HarmonicAngle, generic_angle_energy_force),
           (PeriodicTorsion, torsion_energy_force))


def _pad_terms(idxs, params, n_dev: int):
    """Pad a term list to a multiple of n_dev with -1 index rows (zero
    parameters) so that it splits into n_dev equal blocks; the parameters
    keep their dtype (JAX's casts them to float32)."""
    idxs = np.asarray(idxs).reshape(len(idxs), -1)
    params = np.asarray(params)
    t = idxs.shape[0]
    tpad = max(n_dev, -(-t // n_dev) * n_dev)
    idxs_p = np.full((tpad, idxs.shape[1]), -1, dtype=np.int32)
    params_p = np.zeros((tpad,) + params.shape[1:], dtype=params.dtype)
    if t:
        idxs_p[:t] = idxs
        params_p[:t] = params
    return idxs_p, params_p


def _block(padded, n_dev: int, rank: int):
    """This rank's block of a _pad_terms list, the padding rows dropped."""
    idxs_p, params_p = padded
    per = len(idxs_p) // n_dev
    idxs, params = idxs_p[rank * per : (rank + 1) * per], params_p[rank * per : (rank + 1) * per]
    keep = (idxs >= 0).all(axis=1)
    return idxs[keep].astype(np.int64), params[keep]


def make_spatial_md_runner(
    bps,
    masses,
    mesh,
    axis_name: str = "spatial",
    rebuild_interval: int = 20,
    skin: float = 0.1,
    margin: float = 1.4,
    conf0=None,
    box0=None,
):
    """Build an n-step NVT (optionally NPT) Langevin runner whose force pass
    is partitioned over `mesh` along `axis_name`.

    bps: the port's potentials (each holding its parameters), one
      Nonbonded all-pairs term among them (its beta, cutoff and exclusions
      are read from it); they run on their parameters' device and dtype
      (the card in float32 for the kernel; the CPU in any float dtype).
    conf0, box0: the geometry that sizes the lists (suggest_max_pairs at
      cutoff + skin, margin).

    Returns make_run(temperature, dt, friction, n_steps, barostat=None);
    make_run returns run(x0, v0, box, seed) -> (x, v, box), the same on
    every rank (the box changes only under a barostat). make_run.force(x,
    box) is the all-reduced force a step takes at (x, box)."""
    if conf0 is None or box0 is None:
        raise ValueError("make_spatial_md_runner: conf0 and box0 size the lists")
    n_dev, rank = mesh_size(mesh, axis_name), mesh_rank(mesh, axis_name)
    nb = next((p for p in bps if isinstance(p, Nonbonded)), None)
    if nb is None or sum(isinstance(p, Nonbonded) for p in bps) != 1:
        raise ValueError("spatial MD takes one Nonbonded all-pairs term")
    if nb.atom_idxs is not None:
        raise ValueError("spatial MD sweeps every atom: the Nonbonded term must have no atom subset")
    dev, dtype = nb.params.device, nb.params.dtype
    n = len(conf0)

    def tensor(a, dt=dtype):
        return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a), device=dev, dtype=dt)

    # -- this rank's share of each term -----------------------------------------
    bonded = []  # (force fn, idxs, params, assemble)
    ig_terms = []  # (potential, columns, col_mask)
    grad_terms = []
    for pot in bps:
        fn = next((f for cls, f in _BONDED if isinstance(pot, cls)), None)
        if pot is nb:
            continue
        if fn is not None:
            if pot.idxs.shape[0] == 0:
                continue
            idxs, params = _block(_pad_terms(pot.idxs.cpu().numpy(), pot.params.cpu().numpy(), n_dev), n_dev, rank)
            if len(idxs):
                bonded.append((fn, tensor(idxs, torch.int64), tensor(params), SegmentSum(idxs.T.ravel(), n, device=dev)))
        elif isinstance(pot, NonbondedInteractionGroup):
            # partition the environment columns; padding repeats column 0 under a False mask
            cols = pot.col_atom_idxs.cpu().numpy()
            c = len(cols)
            per = max(1, -(-c // n_dev))
            padded = np.full(per * n_dev, cols[0] if c else 0)
            padded[:c] = cols
            mask = np.arange(per * n_dev) < c
            blk = slice(rank * per, (rank + 1) * per)
            ig_terms.append((pot, tensor(padded[blk], torch.int64), torch.as_tensor(mask[blk], device=dev)))
        else:
            grad_terms.append(pot)

    beta, cutoff = nb.beta, nb.cutoff
    series = rs.es_energy_force_series(beta, cutoff)
    exc, scales = nb._exclusions
    exc_idxs, exc_scales = _block(_pad_terms(exc, scales, n_dev), n_dev, rank)
    exclusions = None
    if len(exc_idxs):
        exclusions = (tensor(exc_idxs, torch.int64), tensor(exc_scales), SegmentSum(exc_idxs.T.ravel(), n, device=dev))

    conf0_t, box0_t = tensor(conf0), tensor(box0)
    max_pairs = rs.suggest_max_pairs(conf0_t, box0_t, cutoff + skin, margin=margin, triangular=True)
    n_rows = rs.padded_size(n) // rs.ROW
    rows_local = -(-n_rows // n_dev)
    row_base = min(rank * rows_local, n_rows)
    rows_here = min(rows_local, n_rows - row_base)  # 0: this rank sweeps no rows
    nb_params = nb.params

    def build_tiles(x, box):
        tiles = rs.build_rowscan_tiles(x, box, cutoff + skin, max_pairs, triangular=True)
        prows = rs.param_rows(nb_params.to(x.dtype), tiles.pad_order, n)
        return tiles, prows, torch.argsort(tiles.pad_order[:n])

    def slab_sweep(x, box, lists, mode):
        """(Npad, 4) of this rank's slab: its rows' sums and the column reactions it causes."""
        tiles, prows, _ = lists
        atoms = rs.assemble_atoms(x, box, tiles.pad_order, prows)
        row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, cutoff)
        return rs.rowscan_sweep(
            atoms, tiles.row_start, row_count, tiles.col_ids, rs.sweep_scalars(box, cutoff), series, mode, True,
            None, True, row_base, rows_here,
        )

    def local_force(x, box, lists):
        """This rank's share of the force (N, 3); the caller all-reduces it."""
        force = torch.zeros_like(x)
        if rows_here:
            force = -slab_sweep(x, box, lists, rs.FORCE)[lists[2], 1:4]
        if exclusions is not None:
            e_idx, e_scl, e_asm = exclusions
            force = force - specific_pairs_energy_force(x, nb_params, box, e_idx, cutoff, e_scl, series[0], e_asm)[1]
        for fn, t_idx, t_par, t_asm in bonded:
            force = force + fn(x, t_par, box, t_idx, t_asm)[1]
        for pot, cols, mask in ig_terms:
            force = force + interaction_group_energy_force(
                x, pot.params, box, pot.row_atom_idxs, cols, pot.beta, pot.cutoff, col_mask=mask
            )[1]
        for pot in grad_terms:
            xg = x.detach().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(pot.u(xg, pot.params, box), xg)
            force = force - g / n_dev
        return poison_on_overflow(lists[0].overflow, force)

    def sweep_energy(x, box, lists):
        """The all-reduced all-pairs energy through the cached lists (within skin / 2 of their build)."""
        u = slab_sweep(x, box, lists, rs.ENERGY)[:, 0].sum() if rows_here else x.new_zeros(())
        return all_reduce_sum(poison_on_overflow(lists[0].overflow, u).reshape(1), mesh, axis_name)[0]

    def make_run(temperature, dt, friction, n_steps: int, barostat=None):
        """barostat: a MonteCarloBarostat; its volume moves run replicated on
        the all-reduced rigid-move energy (the sweep's)."""
        ca, cb, cc = LangevinIntegrator(temperature, dt, friction, np.asarray(masses), seed=0).coefficients()
        ca, cb, cc = float(ca), tensor(cb), tensor(cc)

        def run(x0, v0, box, seed: int):
            x, v, box = tensor(x0), tensor(v0), tensor(box)
            noise = torch.Generator(device=dev)
            noise.manual_seed(seed)
            baro_state = move = lists = None
            if barostat is not None:
                baro_state = barostat.init_state(dev, dtype)
                move = barostat.make_move_fn(lambda xx, bb: sweep_energy(xx, bb, lists), dev)
            with torch.no_grad():
                for t in range(n_steps):
                    if t % rebuild_interval == 0:
                        lists = build_tiles(x, box)
                    force = all_reduce_sum(local_force(x, box, lists), mesh, axis_name)
                    xi = torch.randn(x.shape, generator=noise, device=dev, dtype=dtype)
                    x, v = langevin_step(x, v, force, xi, ca, cb, cc, dt)
                    if barostat is not None and (t + 1) % barostat.interval == 0:
                        baro_state, x, v, box = move(baro_state, x, v, box)
            return x, v, box

        return run

    def force(x, box):
        """The all-reduced force at (x, box), through lists built there: what a step's integrator takes."""
        x, box = tensor(x), tensor(box)
        with torch.no_grad():
            return all_reduce_sum(local_force(x, box, build_tiles(x, box)), mesh, axis_name)

    make_run.force = force
    return make_run
