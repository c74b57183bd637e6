"""Enhanced sampling (the port of timemachine_tpu/md/enhanced.py):
importance-weighted vacuum conformers of a ligand, the solvated system of
the absolute hydration leg and its NPT samples, and aligned ligand-swap
proposals for the condensed-phase endstate; the rotatable-bond query that
REST's region selection reads.

The vacuum walkers are one leading axis of torch tensors, stepped together
on the card unless the caller passes the CPU: each step's forces are
autograd of the energy vmapped over the walkers (the valence terms'
expressions and the plain dense nonbonded form at the 1,000 nm
vacuum box, which stays dense at every size: a handful of atoms). The
Langevin noise comes from a torch.Generator seeded with `seed` where JAX
folds jax.random keys (ROADMAP P25); the weighted draws take a numpy
RandomState or Generator `rng` where JAX draws from numpy's global stream,
and a numpy Generator `key` where it passes a jax.random key (P25, P26).

Alignment (Kabsch, ops/rmsd.py) runs in float64 on the device of the
coordinates it is given: numpy state, as the moves pass it, aligns on the
host.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from scipy.special import logsumexp

from timemachine_torch.chem.smarts import match_smarts
from timemachine_torch.constants import BOLTZ
from timemachine_torch.device import resolve_device, working_dtype
from timemachine_torch.integrators import langevin_coefficients, langevin_step
from timemachine_torch.md.states import CoordsVelBox
from timemachine_torch.ops.rmsd import align_x2_unto_x1

logger = logging.getLogger(__name__)

ROTATABLE_BOND_SMARTS = "[!$(*#*)&!D1]-&!@[!$(*#*)&!D1]"


def identify_rotatable_bonds(mol) -> set:
    """Rotatable bonds by the Lipinski-style (non-strict) SMARTS, as
    canonicalized (i < j) pairs."""
    return {(min(i, j), max(i, j)) for i, j in match_smarts(mol, ROTATABLE_BOND_SMARTS)}


class VacuumState:
    """Vacuum energy ladder for barrier-crossing proposals: U_easy (the
    rigid scaffold only: rotatable torsions and nonbonded terms off) ->
    U_decharged -> U_full, as closures over the port's modules on `device`
    (None: the card) in its working dtype. Each U takes one conformer
    (N, 3), a tensor there or numpy."""

    def __init__(self, mol, ff, device=None):
        from timemachine_torch.convert import modules_from_bound_potentials
        from timemachine_torch.fe import terms, topology
        from timemachine_torch.potentials import all_pairs_kernel

        self.mol = mol
        bt = topology.BaseTopology(mol, ff)
        self.box = None
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)

        hb_p, hb = bt.parameterize_harmonic_bond(ff.hb_handle.params)
        ha_p, ha = bt.parameterize_harmonic_angle(ff.ha_handle.params)
        pt_p, pt = bt.parameterize_proper_torsion(ff.pt_handle.params)
        it_p, it = bt.parameterize_improper_torsion(ff.it_handle.params)
        nb_p, nb = bt.parameterize_nonbonded(
            ff.q_handle.params, ff.q_handle_intra.params, ff.lj_handle.params, ff.lj_handle_intra.params, 0.0
        )
        # kept public: estimator tests and reweighting introspect these
        self.bond_params, self.hb_potential = hb_p, hb
        self.angle_params, self.ha_potential = ha_p, ha
        self.proper_torsion_params, self.pt_potential = pt_p, pt
        self.improper_torsion_params, self.it_potential = it_p, it
        self.nb_params, self.nb_potential = nb_p, nb
        self.lamb = 0.0

        # easy torsions: the propers whose central bond is not rotatable
        rotatable = identify_rotatable_bonds(mol)
        pt_idxs = np.asarray(pt.idxs).reshape(-1, 4)
        central = np.stack(
            [np.minimum(pt_idxs[:, 1], pt_idxs[:, 2]), np.maximum(pt_idxs[:, 1], pt_idxs[:, 2])], axis=1
        )
        keep = np.array([tuple(b) not in rotatable for b in central], dtype=bool)
        self._easy_torsion_idxs = pt_idxs[keep].astype(np.int32)
        self._easy_torsion_params = np.asarray(torch.as_tensor(pt_p).detach(), np.float64).reshape(-1, 3)[keep]

        decharged_p = np.array(torch.as_tensor(nb_p).detach(), np.float64)
        decharged_p[:, 0] = 0.0
        n = mol.num_atoms
        bound = [
            hb.bind(hb_p), ha.bind(ha_p), it.bind(it_p),
            terms.PeriodicTorsion(self._easy_torsion_idxs).bind(self._easy_torsion_params),
            pt.bind(pt_p), nb.bind(nb_p), nb.bind(decharged_p),
        ]
        bond, angle, improper, easy, proper, nonbonded, decharged = modules_from_bound_potentials(
            bound, n, self.device, self.dtype
        )
        vac_box = torch.eye(3, device=self.device, dtype=self.dtype) * 1000.0
        kernel = all_pairs_kernel("fresh", n, self.device)  # "dense": the vacuum term is never swept
        for m in (nonbonded, decharged):
            m.configure(vac_box, torch.zeros((n, 3), device=self.device, dtype=self.dtype), kernel=kernel)
        self._modules = [bond, angle, improper, easy, proper, nonbonded, decharged]

        def on(m, box=None):
            return lambda x: m.u(x, m.params, box)

        scaffold = [on(bond), on(angle), on(improper)]
        self._terms = {
            "scaffold": lambda x: sum(f(x) for f in scaffold),
            "easy_torsions": on(easy),
            "propers": on(proper),
            "nonbonded": on(nonbonded, vac_box),
            "nonbonded_decharged": on(decharged, vac_box),
        }

    def _x(self, x):
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=self.device, dtype=self.dtype)

    def U_easy(self, x):
        """Proposal potential: rotatable torsions and every nonbonded term off."""
        x = self._x(x)
        return self._terms["scaffold"](x) + self._terms["easy_torsions"](x)

    def U_full(self, x):
        x = self._x(x)
        return self._terms["scaffold"](x) + self._terms["propers"](x) + self._terms["nonbonded"](x)

    def U_decharged(self, x):
        """Interacting but decharged: better overlap with condensed states."""
        x = self._x(x)
        return self._terms["scaffold"](x) + self._terms["propers"](x) + self._terms["nonbonded_decharged"](x)


def _batched(U_fn):
    """U over a leading axis of conformers: (..., N, 3) -> (...)."""

    def U_batch(xs):
        flat = xs.reshape(-1, *xs.shape[-2:])
        return torch.func.vmap(U_fn)(flat).reshape(xs.shape[:-2])

    return U_batch


def _simulate(x, v, U_fn, temperature, masses, dt, friction, steps_per_batch: int, num_batches: int, draw):
    """Langevin steps of every walker at once from (x, v), tensors (walkers,
    N, 3): JAX's step, v_mid = v + cb F, v' = ca v_mid + cc noise,
    x' = x + dt/2 (v_mid + v'), F = -dU/dx by autograd of U_fn vmapped over
    the walkers; a frame every steps_per_batch steps; draw(shape) gives each
    step's noise. Returns (xs, vs), each (walkers, num_batches, N, 3) numpy."""
    ca, cb, cc = langevin_coefficients(temperature, dt, friction, np.asarray(masses, dtype=np.float64))
    cb, cc = (torch.as_tensor(c[:, None], device=x.device, dtype=x.dtype) for c in (cb, cc))
    U_batch = torch.func.vmap(U_fn)

    def force(x):
        x = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(U_batch(x).sum(), x)
        return -grad

    xs, vs = [], []
    for _ in range(num_batches):
        for _ in range(steps_per_batch):
            x, v = langevin_step(x, v, force(x), draw(x.shape), float(ca), cb, cc, dt)
            x, v = x.detach(), v.detach()
        xs.append(x)
        vs.append(v)
    return torch.stack(xs, 1).cpu().numpy(), torch.stack(vs, 1).cpu().numpy()


def simulate_batch(
    x0, U_fn, temperature, masses, steps_per_batch, num_batches, num_walkers, seed, dt=1.5e-3, friction=1.0,
    device=None,
):
    """Batched vacuum Langevin: num_walkers trajectories from x0 (each
    jittered by 0.01 nm, velocities drawn at temperature) advanced together
    on `device` (None: the card) in its working dtype, a frame every
    steps_per_batch steps; U_fn maps one conformer to its energy; the noise
    comes from a torch.Generator seeded with `seed`.

    Returns (xs, vs), each (num_walkers, num_batches, N, 3) numpy."""
    device = resolve_device(device)
    dtype = working_dtype(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    masses = np.asarray(masses, dtype=np.float64)
    x0 = torch.as_tensor(np.asarray(x0), device=device, dtype=dtype)
    shape = (num_walkers, *x0.shape)
    x_init = x0[None] + 0.01 * draw(shape)
    sigma = torch.as_tensor(np.sqrt(BOLTZ * temperature / masses), device=device, dtype=dtype)
    v_init = sigma[None, :, None] * draw(shape)
    return _simulate(x_init, v_init, U_fn, temperature, masses, dt, friction, steps_per_batch, num_batches, draw)


def _log_weights(xs, U_proposal, U_target, kT):
    """(U_proposal - U_target) / kT of each conformer of xs (..., N, 3), flat, float64 numpy."""
    with torch.no_grad():
        du = _batched(U_proposal)(xs) - _batched(U_target)(xs)
    return (du.double().cpu().numpy() / kT).reshape(-1)


def generate_log_weighted_samples(
    mol,
    temperature,
    U_proposal,
    U_target,
    seed,
    steps_per_batch: int = 250,
    num_batches: int = 24000,
    num_workers=None,
    burn_in_batches: int = 2000,
    device=None,
):
    """Sample from U_proposal with num_workers (8 when None) walkers, weight
    each frame by U_target - U_proposal. U_proposal and U_target are
    functions of one conformer on `device` (None: the card; a VacuumState's
    on the same device).

    Returns (xvs, log_weights): xvs (num_batches, 2, N, 3) stacks coordinates
    and velocities."""
    from timemachine_torch.fe.utils import get_mol_masses, get_romol_conf

    masses = get_mol_masses(mol)
    num_walkers = num_workers or 8
    kT = temperature * BOLTZ

    batches_per_walker = int(np.ceil(num_batches / num_walkers))
    xs, vs = simulate_batch(
        get_romol_conf(mol), U_proposal, temperature, masses, steps_per_batch, batches_per_walker + burn_in_batches,
        num_walkers, seed, device=device,
    )
    xs = xs[:, burn_in_batches:]
    vs = vs[:, burn_in_batches:]
    device = resolve_device(device)
    log_weights = _log_weights(torch.as_tensor(xs, device=device), U_proposal, U_target, kT)

    n_atoms = len(masses)
    xs = xs.reshape(-1, n_atoms, 3)[:num_batches]
    vs = vs.reshape(-1, n_atoms, 3)[:num_batches]
    return np.stack([xs, vs], axis=1), log_weights[:num_batches]


def sample_from_log_weights(weighted_samples, log_weights, size, rng=None):
    """Multinomial resample into an unweighted collection, drawn from `rng`
    (a numpy RandomState or Generator; None: a fresh default_rng())."""
    if len(log_weights) != len(weighted_samples):
        raise ValueError("one log weight per sample required")
    weights = np.exp(log_weights - logsumexp(log_weights))
    assert np.abs(np.sum(weights) - 1) < 1e-5
    rng = np.random.default_rng() if rng is None else rng
    chosen = rng.choice(len(weights), size=size, p=weights)
    return [weighted_samples[i] for i in chosen]


def jax_sample_from_log_weights(weighted_samples, log_weights, size, key):
    """`size` samples drawn with probability ∝ exp(log weight), from the
    numpy Generator `key` (JAX's categorical draw from a jax.random key)."""
    lw = np.asarray(log_weights, dtype=np.float64)
    p = np.exp(lw - logsumexp(lw))
    chosen = key.choice(len(p), size=size, p=p / p.sum())
    return np.asarray(weighted_samples)[chosen]


def get_solvent_phase_system(
    mol, ff, lamb: float, box_width: float = 3.0, margin: float = 0.5, minimize_energy: bool = True, device=None
):
    """The molecule in a box_width nm water box with margin nm of slack, its
    edge at lamb (AbsoluteFreeEnergy.prepare_host_edge): (potentials,
    params, masses, coords, box), the potentials the builders' terms; with
    minimize_energy the host FIRE-minimized around it on `device` (None:
    the card)."""
    from timemachine_torch.fe.free_energy import AbsoluteFreeEnergy
    from timemachine_torch.fe.topology import BaseTopology
    from timemachine_torch.fe.utils import get_romol_conf
    from timemachine_torch.md import builders, minimizer

    host_config = builders.build_water_system(box_width, ff.water_ff, mols=[mol])
    host_config.box += np.eye(3) * margin

    afe = AbsoluteFreeEnergy(mol, BaseTopology(mol, ff))
    potentials, params, masses = afe.prepare_host_edge(ff, host_config, lamb)

    ligand_coords = get_romol_conf(mol)
    if minimize_energy:
        new_water_coords = minimizer.fire_minimize_host([mol], host_config, ff, device=device)
        coords = np.concatenate([new_water_coords, ligand_coords])
    else:
        coords = np.concatenate([host_config.conf, ligand_coords])
    return potentials, params, masses, coords, host_config.box


def solvent_phase_modules(potentials, params, num_atoms: int, device=None) -> list:
    """The solvated system's terms as the port's modules on `device` (None:
    the card) in its working dtype, in the terms' order."""
    from timemachine_torch.convert import modules_from_bound_potentials

    device = resolve_device(device)
    bps = [pot.bind(p) for pot, p in zip(potentials, params)]
    return modules_from_bound_potentials(bps, num_atoms, device, working_dtype(device))


def equilibrate_solvent_phase(
    potentials, params, masses, coords, box, temperature, pressure, num_steps, seed=None, device=None
):
    """NPT equilibration from minimized coordinates at a 1e-4 ps step, the
    barostat every 5 steps, velocities zero in and out, on `device` (None:
    the card), the all-pairs term as a fresh Context's (site "fresh")."""
    from timemachine_torch.fe import terms
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md.barostat import MonteCarloBarostat
    from timemachine_torch.md.context import Context
    from timemachine_torch.md.minimizer import configure_nonbonded
    from timemachine_torch.md.utils import get_bond_list, get_group_indices

    bond = next(pot for pot in potentials if isinstance(pot, terms.HarmonicBond))
    group_idxs = get_group_indices(get_bond_list(bond), len(masses))
    modules = solvent_phase_modules(potentials, params, len(masses), device)
    dev, dt = modules[0].params.device, modules[0].params.dtype
    x0 = torch.as_tensor(np.asarray(coords), device=dev, dtype=dt)
    configure_nonbonded(modules, x0, torch.as_tensor(np.asarray(box), device=dev, dtype=dt), site="fresh")
    ctxt = Context(
        x0,
        np.zeros_like(coords),
        box,
        LangevinIntegrator(temperature, 1e-4, 1.0, masses, seed),
        modules,
        movers=[MonteCarloBarostat(len(masses), pressure, temperature, group_idxs, 5, seed + 1)],
        device=dev,
    )
    ctxt.multiple_steps(num_steps)
    x_eq = ctxt.get_x_t()
    return CoordsVelBox(x_eq, np.zeros_like(x_eq), ctxt.get_box())


def align_sample(x_vacuum, x_solvent):
    """x_vacuum (or a batch of them) rigidly aligned onto the ligand, the
    last atoms of x_solvent, in float64."""
    x_vacuum = torch.as_tensor(x_vacuum, dtype=torch.float64)
    x_solvent = torch.as_tensor(x_solvent, dtype=torch.float64, device=x_vacuum.device)
    return align_x2_unto_x1(x_solvent[-x_vacuum.shape[-2] :], x_vacuum)


def align_and_replace(x_vacuum, x_solvent):
    """x_solvent with its ligand replaced by x_vacuum aligned onto it, in
    float64; a batch of vacuum conformers (K, n, 3) gives K systems."""
    aligned = align_sample(x_vacuum, x_solvent)
    x_solvent = torch.as_tensor(x_solvent, dtype=torch.float64, device=aligned.device)
    out = x_solvent.expand(*aligned.shape[:-2], *x_solvent.shape).clone()
    out[..., -aligned.shape[-2] :, :] = aligned
    return out


def batch_align_and_replace(xs_vacuum, x_solvent):
    """align_and_replace of each of K vacuum conformers (JAX's vmap of it)."""
    return align_and_replace(xs_vacuum, x_solvent)


def aligned_batch_propose(xvb, K, key, vacuum_samples, vacuum_log_weights):
    """K solvent proposals, the ligand swapped for vacuum samples drawn by
    weight from the numpy Generator `key` and aligned onto it."""
    chosen = jax_sample_from_log_weights(vacuum_samples, vacuum_log_weights, K, key)
    replaced = batch_align_and_replace(chosen, xvb.coords).cpu().numpy()
    return [CoordsVelBox(x_r, xvb.velocities, xvb.box) for x_r in replaced]


def jax_aligned_batch_propose_coords(x, K, key, vacuum_samples, vacuum_log_weights):
    """The coordinates of aligned_batch_propose's K proposals, (K, N, 3)
    float64 numpy: an MTM move's batch_proposal_fn."""
    chosen = jax_sample_from_log_weights(vacuum_samples, vacuum_log_weights, K, key)
    return batch_align_and_replace(chosen, x).cpu().numpy()


def generate_solvent_samples(
    coords,
    box,
    masses,
    potentials,
    params,
    temperature,
    pressure,
    seed,
    n_samples,
    num_equil_steps=50000,
    md_steps_per_move=1000,
    device=None,
):
    """An NPT chain over the solvated system on `device` (None: the card):
    equilibrate once, then each sample md_steps_per_move steps past the
    previous one. Returns n_samples + 1 states, the equilibrated one first."""
    from timemachine_torch.md.moves import NPTMove

    state = equilibrate_solvent_phase(
        potentials, params, masses, coords, box, temperature, pressure, num_equil_steps, seed, device=device
    )
    mover = NPTMove(
        solvent_phase_modules(potentials, params, len(masses), device),
        masses,
        temperature,
        pressure,
        n_steps=md_steps_per_move,
        seed=seed,
    )
    return [state, *mover.sample_chain(state, n_samples)]


def generate_ligand_samples(num_batches, mol, ff, temperature, seed, num_workers=None, device=None):
    """Weighted vacuum conformers by importance sampling from U_easy toward
    U_full, on `device` (None: the card)."""
    state = VacuumState(mol, ff, device=device)
    return generate_log_weighted_samples(
        mol, temperature, state.U_easy, state.U_full, num_batches=num_batches, seed=seed, num_workers=num_workers,
        device=device,
    )


def pregenerate_samples(
    mol,
    ff,
    lamb,
    seed,
    n_solvent_samples=1000,
    n_ligand_batches=30000,
    temperature=300.0,
    pressure=1.0,
    num_workers=None,
    device=None,
):
    """Both ensembles of the aligned-swap MTM move, on `device` (None: the
    card): solvent-phase NPT frames and weighted vacuum conformers."""
    potentials, params, masses, coords, box = get_solvent_phase_system(mol, ff, lamb, device=device)
    print(f"Generating {n_solvent_samples} solvent samples")
    solvent_xvbs = generate_solvent_samples(
        coords, box, masses, potentials, params, temperature, pressure, seed, n_solvent_samples, device=device
    )
    print("Generating ligand samples")
    ligand_samples, ligand_log_weights = generate_ligand_samples(
        n_ligand_batches, mol, ff, temperature, seed, num_workers=num_workers, device=device
    )
    return solvent_xvbs, ligand_samples, ligand_log_weights
