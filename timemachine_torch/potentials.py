"""Potentials of the host system as `nn.Module`s
(counterpart of timemachine_tpu/potentials.py).

Each module holds its index and parameter buffers (a JAX BoundPotential's
potential + params) and offers

  energy(x, box) -> u
  energy_force(x, box) -> (u, force),  force = -dU/dx, closed form
  u(x, params, box) -> u,  differentiable in x and params (du/dp)
  u_force(x, params, box) -> (u, force)  (all but the all-pairs terms), the
      closed form at other parameters: what a batched step vmaps over replicas

Bonded terms sum their per-term forces with a fixed-order SegmentSum, so a
step is bitwise reproducible on the card. `Nonbonded` also offers the
stateful MD provider the Context uses (`md_force_provider`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from timemachine_torch.device import resolve_device
from timemachine_torch.fe.terms import BoundPotential, Potential, SummedPotential, make_summed_potential  # noqa: F401
from timemachine_torch.ops import bonded, chiral, nonbonded
from timemachine_torch.ops import dotscan_kernel as dk
from timemachine_torch.ops import gather_kernel as gk
from timemachine_torch.ops import nonbonded_kernel as nbk
from timemachine_torch.ops import quadscan_kernel as qk
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.ops.segment import SegmentSum


class SortedNBInfo(NamedTuple):
    """What the Context's sorted-state step needs of its one stateful
    provider (JAX's SortedNBInfo): `sweep(state, x_sorted, box, mode)` the
    sweep on pad-ordered coordinates, `pad_order(state)` and `inv(state)`
    the state's permutation, `rebuild_interval`, and `canonical_force(conf,
    params, box)`, where not None, the term's force outside the sweep that
    its provider's apply adds (the leading waters' exclusion correction);
    the Context adds it in canonical order and gathers it to pad order."""

    sweep: object
    pad_order: object
    inv: object
    rebuild_interval: int
    canonical_force: object

# list capacity over the count at configure time, the MD lists' skin (nm)
# and their rebuild period (steps), as the JAX package's rowscan path
MARGIN, SKIN, REBUILD_INTERVAL = 1.4, 0.1, 20
DP_CB = 2  # column super-block width of the block-tile lists, as the JAX package's configure_pallas
KERNELS = ("rowscan", "gather", "quad", "dot", "v1", "dense")
# the JAX package leaves the all-pairs term dense below this many atoms at every call site
DENSE_LIMIT = 4096
SITES = ("context", "host_du_dx", "minimize", "fresh")


def all_pairs_kernel(site: str, num_atoms: int, device) -> str:
    """The configuration that gives the all-pairs term the JAX package's
    form at a call site, for a system of num_atoms on `device` (its type
    "cpu" standing for jax.default_backend() == "cpu"):

      "context"     get_context, and pre_equilibrate_host's NPT run and force
                    check (JAX free_energy.py:477-489, minimizer.py:219-234):
                    "dense" on the CPU or below DENSE_LIMIT atoms, else the
                    rowscan sweep (JAX's configure_pallas default)
      "host_du_dx"  make_host_du_dx_fxn (minimizer.py:123-130): "dense"
                    below DENSE_LIMIT atoms, else JAX's "tiled" form on every
                    device, which "v1" serves (the same function: exact erfc
                    within the cutoff, over block tiles)
      "minimize"    a potential no call site has configured yet, as
                    get_val_and_grad_fn reads it (minimizer.py:287: JAX's
                    fresh impl="dense"): "dense" on the CPU or below
                    DENSE_LIMIT atoms, else "v1", the same function in O(N)
      "fresh"       a Context or an energy over potentials that no
                    configure_pallas touched: NVTMove's and NPTMove's Context
                    (moves.py:148-161), equilibrate_solvent_phase's
                    (enhanced.py:271-276), SMC's reduced_potential_fxn
                    (absolute_hydration.py:104-108) and the MTM's batched log
                    weights built on it: JAX's impl="dense" on every backend,
                    so the rule of "minimize"

    A rule by device and size, not a fallback: on the card every exact
    evaluation at DENSE_LIMIT atoms and up launches nb_tiles, every MD step
    of get_context's Context the rowscan sweep, and every MD step of a
    "fresh" Context (a move's) nb_tiles' exact form."""
    if site not in SITES:
        raise ValueError(f"site must be one of {SITES}, got {site!r}")
    small = num_atoms < DENSE_LIMIT
    if site == "host_du_dx":
        return "dense" if small else "v1"
    if small or torch.device(device).type == "cpu":
        return "dense"
    return "rowscan" if site == "context" else "v1"


class _BondedTerm(nn.Module):
    """Shared shape of the valence terms: idxs (T, k) atoms, params (T, 3|2).

    A term with a strided water path (`_water`: the leading-water count's
    function, rows per water, the strided (u, force)) takes it for its
    leading waters (`num_waters`, the first `water_rows` rows) and sums the
    rest, its tail, with the SegmentSum."""

    # bond-graph-local: a rigid per-molecule move (the barostat's) leaves the
    # energy unchanged, so volume moves skip the term
    rigid_group_invariant = True
    _water = None

    def __init__(self, idxs, params, num_atoms: int, device=None, dtype=torch.float64):
        super().__init__()
        device = resolve_device(device)
        idxs = np.ascontiguousarray(idxs, dtype=np.int64)
        if idxs.size and (idxs.min() < 0 or idxs.max() >= num_atoms):
            raise ValueError(f"{type(self).__name__}: atom index out of range")
        self.register_buffer("idxs", torch.tensor(idxs, device=device))
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))
        self.num_waters = self._water[0](idxs) if self._water is not None else 0
        self.water_rows = self._water[1] * self.num_waters if self.num_waters else 0
        # role-major: contributions arrive as cat([role 0 rows, role 1 rows, ...])
        self.assemble = SegmentSum(idxs[self.water_rows :].T.ravel(), num_atoms, device=device)

    def u(self, x, params, box):
        """Energy as a function of (x, params, box), differentiable in both
        by autograd (the counterpart of the JAX potential's __call__)."""
        return type(self)._energy(x, params, box, self.idxs)

    def energy(self, x, box):
        return self.u(x, self.params, box)

    def u_force(self, x, params, box):
        rows = self.water_rows
        if not rows:
            u, contribs = type(self)._contribs(x, params, self.idxs)
            return u, self.assemble(torch.cat(contribs))
        u, force = self._water[2](x, params[:rows], self.num_waters)
        if rows < self.idxs.shape[0]:
            u_tail, contribs = type(self)._contribs(x, params[rows:], self.idxs[rows:])
            u, force = u + u_tail, force + self.assemble(torch.cat(contribs))
        return u, force

    def energy_force(self, x, box):
        return self.u_force(x, self.params, box)


class _ValenceTerm(_BondedTerm):
    """The three terms of the JAX package's scatter-free step protocol."""

    def energy_force_fn(self):
        """(conf, params, box) -> (u, force): the strided path for the
        leading waters, the closed form summed by the SegmentSum for the
        rest; None for an empty term."""
        return self.u_force if self.idxs.shape[0] else None

    def force_contribs(self):
        """(groups, fn) of the Context's shared contribution plan (see
        ops/assembly.py), or None for an empty or pure-water term, as JAX's.
        groups = [the tail's idxs (host)]; fn(conf, params, box) -> ([the
        tail's per-role force contributions], the strided waters' (N, 3)
        force or None)."""
        rows, n_rows = self.water_rows, self.idxs.shape[0]
        if n_rows == 0 or rows == n_rows:
            return None
        tail = self.idxs[rows:]

        def fn(conf, params, box):
            extra = self._water[2](conf, params[:rows], self.num_waters)[1] if rows else None
            _, contribs = type(self)._contribs(conf, params[rows:], tail)
            return [contribs], extra

        return [tail.cpu().numpy()], fn


class HarmonicBond(_ValenceTerm):
    _energy = staticmethod(bonded.harmonic_bond)
    _contribs = staticmethod(bonded.bond_force_contribs)
    _water = (bonded._leading_water_bonds, 2, bonded.water_bond_energy_force)


class HarmonicAngle(_ValenceTerm):
    _energy = staticmethod(bonded.harmonic_angle)
    _contribs = staticmethod(bonded.angle_force_contribs)
    _water = (bonded._leading_water_angles, 1, bonded.water_angle_energy_force)


class PeriodicTorsion(_ValenceTerm):
    _energy = staticmethod(bonded.periodic_torsion)
    _contribs = staticmethod(bonded.torsion_force_contribs)


class ChiralAtomRestraint(_BondedTerm):
    """k v^2 on positive pyramidal volumes; idxs (C, 4), params (C,)."""

    _energy = staticmethod(chiral.chiral_atom_restraint)
    _contribs = staticmethod(chiral.chiral_atom_contribs)


class ChiralBondRestraint(_BondedTerm):
    """k v^2 on torsion volumes of the sign s; idxs (C, 4), params (C,),
    signs (C,). Not flagged rigid-invariant, as in the JAX package."""

    rigid_group_invariant = False

    def __init__(self, idxs, signs, params, num_atoms: int, device=None, dtype=torch.float64):
        super().__init__(idxs, params, num_atoms, device=device, dtype=dtype)
        self.register_buffer("signs", torch.tensor(np.ascontiguousarray(signs), device=self.params.device, dtype=dtype))

    def u(self, x, params, box):
        return chiral.chiral_bond_restraint(x, params, box, self.idxs, self.signs.to(params.dtype))

    def u_force(self, x, params, box):
        u, contribs = chiral.chiral_bond_contribs(x, params, self.idxs, self.signs.to(params.dtype))
        return u, self.assemble(torch.cat(contribs))


class FlatBottomBond(_BondedTerm):
    """Quartic flat-bottom restraints between atom pairs, minimum image;
    idxs (B, 2), params (B, 3) rows (k, r_min, r_max). Not flagged
    rigid-invariant: a pair may span two molecules, as in the JAX package."""

    rigid_group_invariant = False

    def u(self, x, params, box):
        return bonded.flat_bottom_bond(x, params, box, self.idxs)

    def u_force(self, x, params, box):
        u, contribs = bonded.flat_bottom_force_contribs(x, params, box, self.idxs)
        return u, self.assemble(torch.cat(contribs))


class LogFlatBottomBond(FlatBottomBond):
    """-1/beta log(1 - exp(-beta U_fb)) over flat-bottom pairs: the
    restraint with which local MD's frozen shell follows a moving reference."""

    def __init__(self, idxs, params, beta: float, num_atoms: int, device=None, dtype=torch.float64):
        super().__init__(idxs, params, num_atoms, device=device, dtype=dtype)
        self.beta = float(beta)

    def u(self, x, params, box):
        return bonded.log_flat_bottom_bond(x, params, box, self.idxs, self.beta)

    def u_force(self, x, params, box):
        u, contribs = bonded.log_flat_bottom_force_contribs(x, params, box, self.idxs, self.beta)
        return u, self.assemble(torch.cat(contribs))


class CentroidRestraint(nn.Module):
    """kb (|c_a - c_b| - b0)^2 between the geometric centroids of two atom
    groups (kb d^2 where b0 == 0); params (an empty array, as JAX binds it)
    are unused. Not flagged rigid-invariant: the groups may be two
    molecules."""

    rigid_group_invariant = False

    def __init__(self, group_a_idxs, group_b_idxs, kb: float, b0: float, params, num_atoms: int, device=None,
                 dtype=torch.float64):
        super().__init__()
        device = resolve_device(device)
        a = np.ascontiguousarray(group_a_idxs, dtype=np.int64)
        b = np.ascontiguousarray(group_b_idxs, dtype=np.int64)
        if a.size == 0 or b.size == 0 or min(a.min(), b.min()) < 0 or max(a.max(), b.max()) >= num_atoms:
            raise ValueError("CentroidRestraint: each group needs atoms in range")
        self.kb, self.b0 = float(kb), float(b0)
        self.register_buffer("group_a_idxs", torch.tensor(a, device=device))
        self.register_buffer("group_b_idxs", torch.tensor(b, device=device))
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))
        self.assemble = SegmentSum(np.concatenate([a, b]), num_atoms, device=device)

    def u(self, x, params, box):
        return bonded.centroid_restraint(x, params, box, self.group_a_idxs, self.group_b_idxs, self.kb, self.b0)

    def energy(self, x, box):
        return self.u(x, self.params, box)

    def u_force(self, x, params, box):
        u, contribs = bonded.centroid_restraint_contribs(x, self.group_a_idxs, self.group_b_idxs, self.kb, self.b0)
        return u, self.assemble(torch.cat(contribs))

    def energy_force(self, x, box):
        return self.u_force(x, self.params, box)


class FanoutSummedPotential(nn.Module):
    """The sum of several modules that share one parameter array: u(x, p,
    box) passes the same p to each (JAX's FanoutSummedPotential). `params`
    is the shared array; each member keeps its own copy for its energy()."""

    def __init__(self, members, params, device=None, dtype=torch.float64):
        super().__init__()
        device = resolve_device(device)
        self.members = nn.ModuleList(members)
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))
        self.rigid_group_invariant = all(getattr(m, "rigid_group_invariant", False) for m in members)

    def u(self, x, params, box):
        return sum(m.u(x, params, box) for m in self.members)

    def energy(self, x, box):
        return self.u(x, self.params, box)

    def u_force(self, x, params, box):
        u, f = zip(*(m.u_force(x, params, box) for m in self.members))
        return sum(u), sum(f)

    def energy_force(self, x, box):
        return self.u_force(x, self.params, box)


class _PairListTerm(_BondedTerm):
    """Shared shape of the explicit pair-list terms: idxs (P, 2), exact erfc
    electrostatics, forces in closed form summed by the SegmentSum."""

    def __init__(self, idxs, params, beta: float, cutoff: float, num_atoms: int, device=None, dtype=torch.float64):
        super().__init__(np.reshape(idxs, (-1, 2)), params, num_atoms, device=device, dtype=dtype)
        self.beta, self.cutoff = float(beta), float(cutoff)


class NonbondedPairList(_PairListTerm):
    """LJ + switched erfc Coulomb over listed pairs, each scaled by its row
    of rescale_mask [q_scale, lj_scale]; per-atom params rows."""

    rigid_group_invariant = False
    sign = 1.0

    def __init__(self, idxs, rescale_mask, params, beta, cutoff, num_atoms, device=None, dtype=torch.float64):
        super().__init__(idxs, params, beta, cutoff, num_atoms, device=device, dtype=dtype)
        mask = np.ascontiguousarray(rescale_mask, dtype=np.float64).reshape(-1, 2)
        self.register_buffer("rescale_mask", torch.tensor(mask, device=self.params.device, dtype=dtype))

    def u(self, x, params, box):
        vdw, es = nonbonded.nonbonded_on_specific_pairs(
            x, params, box, self.idxs, self.beta, self.cutoff, self.rescale_mask.to(params.dtype)
        )
        return self.sign * (torch.sum(vdw) + torch.sum(es))

    def u_force(self, x, params, box):
        u, f = nonbonded.specific_pairs_exact_energy_force(
            x, params, box, self.idxs, self.beta, self.cutoff, self.rescale_mask.to(params.dtype), self.assemble
        )
        return self.sign * u, self.sign * f


class NonbondedExclusions(NonbondedPairList):
    """The negated pair list: cancels excluded pairs out of an all-pairs sum."""

    rigid_group_invariant = True  # bond-graph-local pairs
    sign = -1.0


class NonbondedPairListPrecomputed(_PairListTerm):
    """Pair list whose parameter rows are already combined, [q_ij, sigma_ij,
    eps_ij, dw_ij]: the single-topology ligand's intramolecular term."""

    rigid_group_invariant = True  # intramolecular ligand pairs

    def u(self, x, params, box):
        vdw, es = nonbonded.nonbonded_on_precomputed_pairs(x, params, box, self.idxs, self.beta, self.cutoff)
        return torch.sum(vdw) + torch.sum(es)

    def u_force(self, x, params, box):
        return nonbonded.precomputed_pairs_energy_force(x, params, box, self.idxs, self.beta, self.cutoff, self.assemble)


class NonbondedInteractionGroup(nn.Module):
    """Row atoms x column atoms (the ligand x its environment), exact erfc
    electrostatics, in grid form; col_atom_idxs None means every atom not
    in row_atom_idxs. Plain PyTorch, as in the JAX package, where it is
    plain XLA."""

    rigid_group_invariant = False

    def __init__(
        self, num_atoms: int, row_atom_idxs, beta: float, cutoff: float, params, col_atom_idxs=None,
        device=None, dtype=torch.float64,
    ):
        super().__init__()
        device = resolve_device(device)
        rows = np.asarray(row_atom_idxs, dtype=np.int64)
        cols = np.setdiff1d(np.arange(num_atoms), rows) if col_atom_idxs is None else np.asarray(col_atom_idxs, np.int64)
        if len(set(rows.tolist()) | set(cols.tolist())) != rows.size + cols.size:
            raise ValueError("NonbondedInteractionGroup: row and column atoms must be distinct and disjoint")
        if min(rows.min(initial=0), cols.min(initial=0)) < 0 or max(rows.max(initial=0), cols.max(initial=0)) >= num_atoms:
            raise ValueError("NonbondedInteractionGroup: atom index out of range")
        self.num_atoms, self.beta, self.cutoff = num_atoms, float(beta), float(cutoff)
        self.register_buffer("row_atom_idxs", torch.tensor(rows, device=device))
        self.register_buffer("col_atom_idxs", torch.tensor(cols, device=device))
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))

    def u(self, x, params, box):
        vdw, es = nonbonded.nonbonded_interaction_groups(
            x, params, box, self.row_atom_idxs, self.col_atom_idxs, self.beta, self.cutoff
        )
        return torch.sum(vdw) + torch.sum(es)

    def energy(self, x, box):
        return self.u(x, self.params, box)

    def u_force(self, x, params, box):
        return nonbonded.interaction_group_energy_force(
            x, params, box, self.row_atom_idxs, self.col_atom_idxs, self.beta, self.cutoff
        )

    def energy_force(self, x, box):
        return self.u_force(x, self.params, box)


class NonbondedAllPairs(nn.Module):
    """All-pairs LJ + switched Coulomb in 4D, no exclusions. Call
    `configure(box, conf, kernel)` once before use: it picks the kernel and
    sizes the list capacities from the geometry.

    kernel="rowscan" (the MD main path): the rowscan sweep with polynomial
    electrostatics over Newton-triangular lists, as JAX's configure_pallas;
    its MD provider images every atom to its row chunk's center
    (`md_preshift`) where dotscan_valid holds at cutoff + SKIN, and leaves w
    out of r^2 unless `rowscan_has_w` (a nonzero w then gives NaN).
    kernel="gather": the same pair function over atom-exact
    full neighbour lists, for energy, force and MD. kernel="quad": rowscan
    for energy and force, the Newton-triangular quadscan sweep for MD, with
    w in r^2 unless `quad_has_w` is False (a nonzero w then gives NaN); it
    falls back to rowscan wholesale where the constant-shift invariant
    fails at cutoff + SKIN (small boxes). kernel="dot": rowscan for energy
    and force, the dotscan sweep (row-center images, forces by contraction) over Newton-triangular lists for MD, on the snake
    sort, else the Hilbert sort, whichever passes the image bound at cutoff
    + SKIN first (`dot_sort`); where neither does, rowscan wholesale.
    kernel="v1": the block-tile sweep with exact electrostatics, lists at
    cutoff + SKIN for MD; it also serves JAX's impl="tiled" (the same
    function, exact erfc within the cutoff; JAX's cell lists are an XLA
    layout the card does not need). kernel="dense": JAX's impl="dense",
    plain PyTorch over Newton-triangular row blocks (ops/nonbonded.py
    DenseAllPairs), exact erfc, no lists: its MD providers (single and
    batched) evaluate it whole at every step. `kernel` then names the
    configuration taken. Either way `u(x, params, box)` is differentiable in
    params: through the block-tile kernel's DP pass (exact electrostatics,
    as in the JAX package), or by autograd through the dense form.
    `all_pairs_kernel` gives the JAX package's choice at each call site.

    atom_idxs restricts the term to a subset of the atoms (the RBFE host
    term's host atoms), as JAX's `_atom_mask`: the others get q = eps = 0
    in the sweeps, leave the chunk boxes (and gather's lists), and get zero
    force and dU/dp. Under a subset configure keeps JAX's rules (quad falls
    back to rowscan, rowscan's MD provider takes no preshift); dot reads
    its image bound on the subset's atoms alone."""

    rigid_group_invariant = False

    def __init__(
        self, num_atoms: int, beta: float, cutoff: float, params, atom_idxs=None, device=None, dtype=torch.float64,
    ):
        super().__init__()
        device = resolve_device(device)
        self.num_atoms = num_atoms
        self.beta = float(beta)
        self.cutoff = float(cutoff)
        self.register_buffer("params", torch.tensor(np.ascontiguousarray(params), device=device, dtype=dtype))
        mask = None
        if atom_idxs is not None:
            mask = torch.zeros(num_atoms, dtype=torch.bool, device=device)
            mask[torch.as_tensor(np.asarray(atom_idxs, dtype=np.int64), device=device)] = True
        self.register_buffer("atom_mask", mask)
        self.atom_idxs = None if atom_idxs is None else np.unique(np.asarray(atom_idxs, dtype=np.int64))
        # the exclusion corrections' electrostatics: the rowscan polynomial, or None for exact erfc
        self.h_coeffs = rs.es_energy_force_series(self.beta, self.cutoff)[0]
        self._energy = self._energy_force = self._ef64 = self._u = self._md = self._md_batched = None
        self._md_sorted = None
        self.kernel = None

    # the closures configure() makes; a term pickles (as the examples pickle
    # their results) unconfigured, and configure() is called again after loading
    _CONFIGURED = ("_energy", "_energy_force", "_ef64", "_u", "_md", "_md_batched", "_md_sorted")

    def __getstate__(self):
        state = self.__dict__.copy()
        state.update(dict.fromkeys(self._CONFIGURED), kernel=None)
        return state

    def __deepcopy__(self, memo):
        """A copy as configured as this term (deepcopy's default, which
        __getstate__ would otherwise change): the closures are shared."""
        import copy

        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__setstate__(copy.deepcopy(self.__dict__, memo))
        return new

    def _dense_exclusions(self):
        """(exclusion_idxs, scale_factors) the dense form scales by 1 - scale: none here."""
        return None, None

    def _configure_dense(self):
        dense = nonbonded.DenseAllPairs(
            self.num_atoms, self.beta, self.cutoff, *self._dense_exclusions(), atom_idxs=self.atom_idxs,
            device=self.params.device,
        )
        self._energy = self._u = dense.energy
        self._energy_force = dense.energy_force

        def ef64(x, box):
            f64 = torch.float64
            return dense.energy_force(x.to(f64), self.params.to(f64), box.to(f64))

        self._ef64 = ef64

        def apply(state, x, params, box, t):
            return dense.energy_force(x, params, box)[1], state

        def energy(state, x, params, box):
            return dense.energy(x, params, box)

        self._md = (lambda x, params, box: None, apply, energy, energy)
        uf_k, u_k = torch.func.vmap(dense.energy_force), torch.func.vmap(dense.energy)

        def apply_k(params, xs, _, boxes, t):
            return uf_k(xs, params, boxes)[1], params

        def energy_with_params_k(params, xs, params_sets, boxes):
            f64 = torch.float64
            x64, b64 = xs.to(f64), boxes.to(f64)
            # one parameter set at a time: K systems' block temporaries at once, not K * S
            return torch.stack([u_k(x64, params_sets[:, j].to(f64), b64) for j in range(params_sets.shape[1])], 1)

        # the batched state is the replicas' parameters, which the energies read
        self._md_batched = (lambda xs, params, boxes: params, apply_k, lambda params, xs, boxes: u_k(xs, params, boxes),
                            energy_with_params_k)

    def configure(self, box, conf, kernel: str = "rowscan", rowscan_has_w: bool = True, quad_has_w: bool = True):
        """Size the lists from this geometry, at MARGIN over the present
        counts: the energy/force lists at the bare cutoff, the MD lists at
        cutoff + SKIN (with a sort-cell size from a census of swept slots
        for rowscan systems of 8,192 atoms and up), the du/dp lists at the
        bare cutoff with column super-blocks DP_CB wide (the block-tile
        lists, du/dp and v1, are Newton-triangular). rowscan_has_w=False
        promises that every w offset is zero (as bench.py passes for DHFR),
        and so does quad_has_w=False for the quad MD provider (JAX's
        configure_pallas takes the same two)."""
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
        self._md_batched = self._ef64 = self._md_sorted = None
        mask = self.atom_mask
        if kernel == "dense":
            self.kernel, self.h_coeffs, self.dot_sort = "dense", None, None
            self._configure_dense()
            return self
        box = torch.as_tensor(box, device=self.params.device)
        conf = torch.as_tensor(conf, device=self.params.device)
        dt = self.params.dtype
        if kernel == "quad" and (mask is not None or not qk.constant_shift_valid(conf, box, self.cutoff + SKIN)):
            kernel = "rowscan"
        self.dot_sort = None
        if kernel == "dot":
            valid = (
                s for s in ("snake", "hilbert")
                if dk.dotscan_valid(conf, box, self.cutoff + SKIN, sort=s, atom_mask=mask)
            )
            self.dot_sort = next(valid, None)
            if self.dot_sort is None:
                kernel = "rowscan"
        self.kernel = kernel
        self.dp_max_tiles = nbk.suggest_max_tiles(
            conf, box, self.cutoff, margin=MARGIN, cb=DP_CB, triangular=True, atom_mask=mask
        )
        self.h_coeffs = rs.es_energy_force_series(self.beta, self.cutoff)[0]
        if kernel == "gather":
            self.max_nbrs = gk.suggest_max_nbrs(conf, box, self.cutoff, margin=MARGIN, atom_mask=mask)
            ef = gk.make_nonbonded_gather_energy_force(self.beta, self.cutoff, self.max_nbrs, atom_mask=mask)
            self._energy = lambda x, params, box: ef(x, params, box)[0]
            self._energy_force = ef
            self._u = gk.make_nonbonded_gather(
                self.beta, self.cutoff, self.max_nbrs, self.dp_max_tiles, dp_cb=DP_CB, atom_mask=mask
            )
            self.md_max_nbrs = gk.suggest_max_nbrs(conf, box, self.cutoff + SKIN, margin=MARGIN, atom_mask=mask)
            self._md = gk.make_nonbonded_gather_md(
                self.beta, self.cutoff, self.md_max_nbrs, skin=SKIN, rebuild_interval=REBUILD_INTERVAL, atom_mask=mask
            )
        elif kernel in ("rowscan", "quad", "dot"):
            pairs = rs.suggest_max_pairs(conf, box, self.cutoff, margin=MARGIN, triangular=True, atom_mask=mask)
            ef = rs.make_nonbonded_rowscan_energy_force(self.beta, self.cutoff, pairs, atom_mask=mask)
            self._energy = lambda x, params, box: ef(x, params, box, rs.ENERGY)[0]
            self._energy_force = ef
            self._ef64 = lambda x, box: ef(x.to(dt), self.params, box.to(dt), rs.FORCE_ENERGY, torch.float64)
            self._u = rs.make_nonbonded_rowscan(
                self.beta, self.cutoff, pairs, self.dp_max_tiles, dp_cb=DP_CB, atom_mask=mask
            )
            self.max_pairs = pairs
            if kernel == "quad":
                self.md_max_tiles = qk.suggest_max_tiles(conf, box, self.cutoff + SKIN, margin=MARGIN)
                self._md = qk.make_nonbonded_quadscan_md(
                    self.beta, self.cutoff, self.md_max_tiles, skin=SKIN, rebuild_interval=REBUILD_INTERVAL,
                    has_w=quad_has_w,
                )
            elif kernel == "dot":
                self.md_max_pairs = dk.suggest_max_pairs(
                    conf, box, self.cutoff + SKIN, margin=MARGIN, triangular=True, sort=self.dot_sort, atom_mask=mask
                )
                self._md = dk.make_nonbonded_dotscan_md(
                    self.beta, self.cutoff, self.md_max_pairs, skin=SKIN, rebuild_interval=REBUILD_INTERVAL,
                    sort=self.dot_sort, atom_mask=mask,
                )
            else:
                cell = 0.65
                if conf.shape[0] >= 8192:
                    cell = rs.suggest_cell_size(conf, box, self.cutoff, skin=SKIN)
                md_pairs = rs.suggest_max_pairs(
                    conf, box, self.cutoff + SKIN, margin=MARGIN, cell_size=cell, triangular=True, atom_mask=mask
                )
                preshift = mask is None and dk.dotscan_valid(conf, box, self.cutoff + SKIN, cell_size=cell)
                self._md = rs.make_nonbonded_rowscan_md(
                    self.beta, self.cutoff, md_pairs, skin=SKIN, rebuild_interval=REBUILD_INTERVAL, cell_size=cell,
                    preshift=preshift, has_w=rowscan_has_w, atom_mask=mask,
                )
                self._md_sorted = rs.make_rowscan_sorted_protocol(
                    self.beta, self.cutoff, REBUILD_INTERVAL, preshift=preshift, has_w=rowscan_has_w
                )
                if not preshift:
                    self._md_batched = rs.make_nonbonded_rowscan_md_batched(
                        self.beta, self.cutoff, md_pairs, skin=SKIN, rebuild_interval=REBUILD_INTERVAL,
                        cell_size=cell, has_w=rowscan_has_w, atom_mask=mask,
                    )
                self.md_max_pairs, self.md_cell_size, self.md_preshift = md_pairs, cell, preshift
        else:
            ef = nbk.make_nonbonded_tiles_energy_force(
                self.beta, self.cutoff, self.dp_max_tiles, cb=DP_CB, atom_mask=mask
            )
            self._energy = lambda x, params, box: ef(x, params, box)[0]
            self._energy_force = ef
            self._ef64 = lambda x, box: ef(x.to(dt), self.params, box.to(dt), torch.float64)
            self._u = nbk.make_nonbonded_tiles(self.beta, self.cutoff, self.dp_max_tiles, cb=DP_CB, atom_mask=mask)
            self.md_max_tiles = nbk.suggest_max_tiles(
                conf, box, self.cutoff + SKIN, margin=MARGIN, cb=DP_CB, triangular=True, atom_mask=mask
            )
            self._md = nbk.make_nonbonded_tiles_md(
                self.beta, self.cutoff, self.md_max_tiles, skin=SKIN, rebuild_interval=REBUILD_INTERVAL, cb=DP_CB,
                atom_mask=mask,
            )
            self.h_coeffs = None
        return self

    def _configured(self):
        if self._u is None:
            raise RuntimeError(f"{type(self).__name__}: call configure(box, conf) first")

    def u(self, x, params, box):
        """Energy as a function of (x, params, box), differentiable in x and
        params (the counterpart of the JAX potential's __call__)."""
        self._configured()
        return self._u(x, params, box)

    def energy(self, x, box):
        self._configured()
        return self._energy(x, self.params, box)

    def energy_force(self, x, box):
        self._configured()
        return self._energy_force(x, self.params, box)

    def energy_force_f64(self, x, box):
        """(u, force) in float64, as a minimizer reads them: one F+U sweep at
        x and box in the parameters' dtype (float32 on the card), its
        per-atom energies summed in float64 and its force taken to float64:
        the rowscan energy/force entry (kernel "rowscan", "quad" or "dot"),
        or nb_tiles' exact UF pass (kernel "v1"; only the sum of its per-atom
        energies is the energy, ROADMAP P8). kernel="dense" evaluates in
        float64 outright. "gather" raises."""
        self._configured()
        if self._ef64 is None:
            raise NotImplementedError(f"energy_force_f64: no float64 energy sum for kernel={self.kernel!r}")
        u, f = self._ef64(x, box)
        return u, f.to(torch.float64)

    def md_force_provider(self):
        """(init(x, box), apply(state, x, box, t) -> (force, state),
        energy(state, x, box), rigid_energy(state, x, box),
        energy_with_params(state, x, params, box)); the energies reuse the
        state's lists, the last with another state's parameters (JAX's
        provider slot 4, which the HREX runner's banded energies read)."""
        self._configured()
        init, apply, energy, energy_with_params = self._md

        def init_fn(x, box):
            return init(x, self.params, box)

        def apply_fn(state, x, box, t):
            return apply(state, x, self.params, box, t)

        def energy_fn(state, x, box):
            return energy(state, x, self.params, box)

        return init_fn, apply_fn, energy_fn, energy_fn, energy_with_params

    def md_force_provider_sorted(self):
        """SortedNBInfo of the Context's sorted-state step, or None where the
        configuration has no sorted protocol: only the rowscan MD provider
        (kernel="rowscan", in every form) has one, as in JAX; gather, quad,
        dot, v1 and dense have none."""
        self._configured()
        if self._md_sorted is None:
            return None
        ss = self._md_sorted
        return SortedNBInfo(ss.sweep, ss.pad_order, ss.inv, ss.rebuild_interval, canonical_force=None)

    def md_force_provider_batched(self):
        """The provider of K replicas stepped together, each with its own
        parameters: (init(xs, params, boxes), apply(state, xs, params, boxes,
        t) -> (forces, state), energy(state, xs, params, boxes) -> (K,),
        rigid_energy(state, xs, params, boxes), energy_with_params(state,
        xs, params_sets (K, S, N, 4), boxes) -> (K, S)), over one
        rowscan_sweep_batched launch a step. The energies run through the
        lists of the state's last rebuild, whose parameter rows the first
        two use. The rowscan configuration without preshift has one (the
        RBFE host term's on the card), and so has "dense" (the CPU's: the
        dense form under torch.func.vmap, its state the parameters of the
        last step); others raise."""
        self._configured()
        if self._md_batched is None:
            raise NotImplementedError(
                f"no batched MD provider for kernel={self.kernel!r} (preshift {getattr(self, 'md_preshift', None)}): "
                "only the rowscan configuration without preshift has one"
            )
        init, apply, energy, energy_with_params = self._md_batched

        def energy_fn(state, xs, params, boxes):
            return energy(state, xs, boxes)

        return init, apply, energy_fn, energy_fn, energy_with_params


class Nonbonded(NonbondedAllPairs):
    """All pairs minus the intramolecular exclusions. The swept forms
    subtract them with the sweep's own electrostatics so that they cancel
    it: the rowscan polynomial, or exact erfc (kernel="v1"), both in closed
    form; leading TIP3P waters go through a strided path, the rest through
    an explicit pair list. kernel="dense" scales the excluded pairs by
    1 - scale inside the dense form instead, as JAX's dense Nonbonded does,
    so nothing is subtracted."""

    def __init__(
        self, num_atoms: int, exclusion_idxs, scale_factors, beta: float, cutoff: float, params, atom_idxs=None,
        device=None, dtype=torch.float64,
    ):
        super().__init__(num_atoms, beta, cutoff, params, atom_idxs=atom_idxs, device=device, dtype=dtype)
        device = self.params.device
        exc = np.ascontiguousarray(exclusion_idxs, dtype=np.int64).reshape(-1, 2)
        scales = np.ascontiguousarray(scale_factors, dtype=np.float64).reshape(-1, 2)
        if atom_idxs is not None:  # keep the exclusions inside the subset, in order (JAX's filter_exclusions)
            inside = np.isin(exc, np.asarray(atom_idxs)).all(axis=1)
            exc, scales = exc[inside], scales[inside]
        self._exclusions = (exc, scales)
        self.num_waters = nonbonded.leading_water_exclusions(exc, scales)
        tail = exc[3 * self.num_waters :]
        self.register_buffer("tail_idxs", torch.tensor(tail, device=device))
        self.register_buffer("tail_scales", torch.tensor(scales[3 * self.num_waters :], device=device, dtype=dtype))
        self.assemble = SegmentSum(tail.T.ravel(), num_atoms, device=device)

    def _dense_exclusions(self):
        return self._exclusions

    @property
    def _subtracts(self) -> bool:
        """Whether the exclusions are a separate correction (every swept form) or inside the dense form."""
        return self.kernel != "dense"

    def exclusion_energy(self, x, params, box):
        """u_exc as a function of (x, params, box), differentiable in both."""
        if self.h_coeffs is not None:
            return self._exclusion_energy_force_poly(x, params, box)[0]
        u = x.new_zeros(())
        if self.num_waters:
            u = nonbonded.water_exclusion_energy(x, params, box, self.num_waters, self.beta, self.cutoff)
        if self.tail_idxs.shape[0]:
            vdw, es = nonbonded.nonbonded_on_specific_pairs(
                x, params, box, self.tail_idxs, self.beta, self.cutoff, self.tail_scales.to(params.dtype)
            )
            u = u + torch.sum(vdw) + torch.sum(es)
        return u

    def _exclusion_energy_force_poly(self, x, params, box):
        u, grad = x.new_zeros(()), torch.zeros_like(x)
        if self.num_waters:
            u, grad = nonbonded.water_exclusion_energy_force(x, params, box, self.num_waters, self.cutoff, self.h_coeffs)
        if self.tail_idxs.shape[0]:
            u_t, f_t = nonbonded.specific_pairs_energy_force(
                x, params, box, self.tail_idxs, self.cutoff, self.tail_scales.to(params.dtype), self.h_coeffs,
                self.assemble,
            )
            u, grad = u + u_t, grad - f_t
        return u, grad

    def _exclusion_energy_force_exact(self, x, params, box):
        u, grad = x.new_zeros(()), torch.zeros_like(x)
        if self.num_waters:
            u, grad = nonbonded.water_exclusion_exact_energy_force(
                x, params, box, self.num_waters, self.beta, self.cutoff
            )
        if self.tail_idxs.shape[0]:
            u_t, f_t = nonbonded.specific_pairs_exact_energy_force(
                x, params, box, self.tail_idxs, self.beta, self.cutoff, self.tail_scales.to(params.dtype),
                self.assemble,
            )
            u, grad = u + u_t, grad - f_t
        return u, grad

    def _exclusion_energy_force_at(self, x, params, box):
        """(u_exc, dU_exc/dx) in closed form, in the sweep's electrostatics."""
        if self.h_coeffs is not None:
            return self._exclusion_energy_force_poly(x, params, box)
        return self._exclusion_energy_force_exact(x, params, box)

    def exclusion_energy_force(self, x, box):
        """(u_exc, dU_exc/dx) of the excluded pairs in closed form: the
        rowscan polynomial, or exact erfc."""
        return self._exclusion_energy_force_at(x, self.params, box)

    def u(self, x, params, box):
        if not self._subtracts:
            return super().u(x, params, box)
        return super().u(x, params, box) - self.exclusion_energy(x, params, box)

    def energy(self, x, box):
        if not self._subtracts:
            return super().energy(x, box)
        return super().energy(x, box) - self.exclusion_energy_force(x, box)[0]

    def energy_force(self, x, box):
        u, f = super().energy_force(x, box)
        if not self._subtracts:
            return u, f
        u_exc, g_exc = self.exclusion_energy_force(x, box)
        return u - u_exc, f + g_exc

    def energy_force_f64(self, x, box):
        """As NonbondedAllPairs', minus the exclusions evaluated in float64
        at the sweep's coordinates (x and box rounded to the parameters'
        dtype), so that the two cancel as far as the sweep's own arithmetic
        allows: the all-pairs term and its exclusions cancel about 16 times
        over on an RBFE window (ROADMAP P16). The dense form holds its
        exclusions already."""
        u, f = super().energy_force_f64(x, box)
        if not self._subtracts:
            return u, f
        dt, f64 = self.params.dtype, torch.float64
        u_exc, g_exc = self._exclusion_energy_force_at(x.to(dt).to(f64), self.params.to(f64), box.to(dt).to(f64))
        return u - u_exc, f + g_exc

    def md_force_provider(self):
        """As NonbondedAllPairs', with the exclusions subtracted in the force
        and in the energy. The rigid energy (4th) is all-pairs only: in a
        rigid move the bond-graph-local exclusions cancel exactly, and
        leaving them out avoids f32 cancellation of their large sums."""
        init_fn, apply_ap, energy_ap, rigid_ap, energy_params_ap = super().md_force_provider()
        if not self._subtracts:
            return init_fn, apply_ap, energy_ap, rigid_ap, energy_params_ap

        def apply_fn(state, x, box, t):
            f, state = apply_ap(state, x, box, t)
            return f + self.exclusion_energy_force(x, box)[1], state

        def energy_fn(state, x, box):
            return energy_ap(state, x, box) - self.exclusion_energy_force(x, box)[0]

        def energy_with_params_fn(state, x, params, box):
            return energy_params_ap(state, x, params, box) - self.exclusion_energy(x, params, box)

        return init_fn, apply_fn, energy_fn, energy_ap, energy_with_params_fn

    def _water_exclusion_grad(self, x, params, box):
        """dU_exc/dx of the leading waters' exclusions in the rowscan
        polynomial: their correction's force (it enters the net force as +)."""
        return nonbonded.water_exclusion_energy_force(x, params, box, self.num_waters, self.cutoff, self.h_coeffs)[1]

    def md_force_provider_split(self):
        """The Context's split of this term (JAX's md_force_provider_split):
        (provider, [tail idxs (host)], tail_fn). The provider is
        md_force_provider's, but its apply adds only the leading waters'
        exclusion correction; every energy (the movers', rigid or not, and
        under other parameters) keeps the full correction. tail_fn(conf,
        params, box) -> ([[f_l, f_r]], None) gives the exclusion tail's
        correction as per-role contributions for the Context's shared plan.
        None where there is no polynomial series to cancel (kernel "v1",
        "dense") or no exclusion tail, as JAX's."""
        self._configured()
        tail = self.tail_idxs
        if not self._subtracts or self.h_coeffs is None or tail.shape[0] == 0:
            return None
        init_fn, apply_ap, *_ = NonbondedAllPairs.md_force_provider(self)
        _, _, energy_fn, rigid_fn, energy_with_params_fn = self.md_force_provider()
        nw = self.num_waters

        def apply_fn(state, x, box, t):
            f, state = apply_ap(state, x, box, t)
            return (f + self._water_exclusion_grad(x, self.params, box) if nw else f), state

        def tail_fn(conf, params, box):
            _, (f_l, f_r) = nonbonded.specific_pairs_force_contribs(
                conf, params, box, tail, self.beta, self.cutoff, self.tail_scales.to(params.dtype), self.h_coeffs
            )
            # the correction is subtracted from the energy, so it adds +dU_exc/dx to the force
            return [[-f_l, -f_r]], None

        return (init_fn, apply_fn, energy_fn, rigid_fn, energy_with_params_fn), [tail.cpu().numpy()], tail_fn

    def md_force_provider_sorted(self):
        """As NonbondedAllPairs', with canonical_force the leading waters'
        exclusion correction (None without leading waters). The exclusion
        tail is not in it: the Context's sorted step takes the split
        (md_force_provider_split), whose tail goes through its shared plan.
        None where the exclusions have no polynomial series to cancel."""
        info = super().md_force_provider_sorted()
        if info is None or not self._subtracts or self.h_coeffs is None:
            return None
        if not self.num_waters:
            return info
        return info._replace(canonical_force=self._water_exclusion_grad)

    def md_force_provider_batched(self):
        """As NonbondedAllPairs', with the exclusions subtracted for every
        replica (and parameter set) at once by torch.func.vmap, in the
        rowscan polynomial's closed form; the rigid energy is all-pairs
        only, as md_force_provider's. The energy under parameter sets is
        float64: the exclusions are evaluated in it, from which the
        all-pairs sum (its per-atom energies summed in float64) cancels.
        The dense form's provider holds its exclusions already."""
        provider = super().md_force_provider_batched()
        if not self._subtracts:
            return provider
        init, apply_ap, energy_ap, _, energy_params_ap = provider
        exc_uf = torch.func.vmap(self._exclusion_energy_force_poly)
        exc_u_sets = torch.func.vmap(torch.func.vmap(self.exclusion_energy, in_dims=(None, 0, None)))

        def apply_fn(state, xs, params, boxes, t):
            f, state = apply_ap(state, xs, params, boxes, t)
            return f + exc_uf(xs, params, boxes)[1], state

        def energy_fn(state, xs, params, boxes):
            return energy_ap(state, xs, params, boxes) - exc_uf(xs, params, boxes)[0]

        def energy_with_params_fn(state, xs, params_sets, boxes):
            f64 = torch.float64
            return energy_params_ap(state, xs, params_sets, boxes) - exc_u_sets(
                xs.to(f64), params_sets.to(f64), boxes.to(f64)
            )

        return init, apply_fn, energy_fn, energy_ap, energy_with_params_fn


# The builders' potentials (fe/terms.py) under JAX's module path: the
# descriptors a builder binds, and the helpers over lists of them.

Conf = torch.Tensor
Params = torch.Tensor
Box = Optional[torch.Tensor]

def unflatten_params(params_flat, shapes):
    sizes = [int(np.prod(s)) for s in shapes]
    offsets = np.cumsum([0] + sizes)
    return [params_flat[offsets[i] : offsets[i + 1]].reshape(shapes[i]) for i in range(len(shapes))]


def get_potential_by_type(pots: Sequence, pot_type):
    for pot in pots:
        if isinstance(pot, pot_type):
            return pot
    raise ValueError(f"Unable to find potential of type: {pot_type}")


def get_bound_potential_by_type(bps: Sequence[BoundPotential], pot_type):
    for bp in bps:
        if isinstance(bp.potential, pot_type):
            return bp
    raise ValueError(f"Unable to find potential of type: {pot_type}")


def sum_potential_energies(bps: Sequence, conf, box):
    """Total energy of a list of bound potentials: the builders' (each
    evaluated by its module on conf's device) or the port's modules."""
    total = 0.0
    for bp in bps:
        total = total + (bp.energy(conf, box) if isinstance(bp, nn.Module) else bp(conf, box))
    return total
