"""Minimization and the host's pre-equilibration (the port of
timemachine_tpu/md/minimizer.py): FIRE over λ windows with the ligands
frozen (fire_minimize_host), an NPT run with the ligands at infinite mass
(pre_equilibrate_host), and subset minimization (local_minimize) by FIRE or
scipy, optionally position-restrained.

The JAX package takes jax.grad of its potentials, and switches to XLA paths
there because its Pallas kernel has no VJP. The port never takes autograd
through a kernel: every energy and force comes from the terms' closed forms
and the sweeps' forces, on the potentials' device. The host all-pairs term
takes the JAX package's form at each call site (potentials.all_pairs_kernel):
the host's FIRE reads JAX's dense form below 4,096 atoms and its "tiled"
form (the port's "v1", exact erfc) from there up, on every device; the
pre-equilibration's NPT run and force check read the Context's form (dense
on the CPU, the rowscan sweep on the card at 4,096 atoms and up); a
minimizer (get_val_and_grad_fn) reads a state's potentials as they are
configured, and an unconfigured all-pairs term as JAX's fresh dense one:
dense on the CPU, "v1" on the card at 4,096 atoms and up, through a
configured copy, so that the state's own term stays unconfigured for the
Context. A minimizer's energy is float64: a sweep's per-atom energies are
summed in float64 and every other term, the exclusions included, is
evaluated in float64, since the host all-pairs term and its exclusions
cancel about 16 times over on an RBFE window and a float32 total would round
away what BFGS's late steps move (ROADMAP P16, P22).

Host-side work stays on the host, as in the JAX package: scipy's BFGS loop,
check_force_norm and the bookkeeping. The pre-equilibration's Langevin noise
and barostat draw from the Context's torch.Generator streams, seeded with
JAX's seeds (ROADMAP P20); equilibrate_host_barker's Barker draws from a
torch.Generator seeded with JAX's seed (ROADMAP P30).
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, Sequence

import numpy as np
import scipy.optimize
import torch

from timemachine_torch.constants import BOLTZ, DEFAULT_PRESSURE, DEFAULT_TEMP, MAX_FORCE_NORM
from timemachine_torch.device import resolve_device, working_dtype
from timemachine_torch.fe import terms, topology
from timemachine_torch.fe.utils import get_romol_conf
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barker import barker_chain
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.context import Context
from timemachine_torch.md.fire import FireMinimizationConfig, ScipyMinimizationConfig
from timemachine_torch.md.fire import fire_minimize as fire_descend
from timemachine_torch.md.utils import get_bond_list, get_group_indices
from timemachine_torch.ops.bonded import harmonic_positional_restraint
from timemachine_torch.ops.pbc import periodic_delta
from timemachine_torch.potentials import NonbondedAllPairs, all_pairs_kernel


class MinimizationError(Exception):
    pass


class MinimizationWarning(UserWarning):
    pass


def check_force_norm(forces, threshold: float = MAX_FORCE_NORM):
    """Raise MinimizationError if any atom's |force| is not finite or
    exceeds threshold (ref minimizer.py:65-77)."""
    per_atom = np.linalg.norm(np.asarray(forces), axis=-1)
    if np.any(~np.isfinite(per_atom)) or np.max(per_atom, initial=0.0) > threshold:
        bad = int(np.argmax(np.where(np.isfinite(per_atom), per_atom, np.inf)))
        raise MinimizationError(f"Forces exceeded threshold {threshold} (atom {bad}: |F| = {per_atom[bad]})")


def parameterize_system(topo, ff, lamb: float):
    """(potentials, params) of a topology at λ: bond, angle, proper,
    improper, nonbonded (ref minimizer.py:80-98)."""
    params_potential_pairs = [
        topo.parameterize_harmonic_bond(ff.hb_handle.params),
        topo.parameterize_harmonic_angle(ff.ha_handle.params),
        topo.parameterize_proper_torsion(ff.pt_handle.params),
        topo.parameterize_improper_torsion(ff.it_handle.params),
        topo.parameterize_nonbonded(
            ff.q_handle.params,
            ff.q_handle_intra.params,
            ff.lj_handle.params,
            ff.lj_handle_intra.params,
            lamb,
        ),
    ]
    return [pot for _, pot in params_potential_pairs], [p for p, _ in params_potential_pairs]


def _guest_topology(mols, ff):
    if len(mols) == 1:
        return topology.BaseTopology(mols[0], ff)
    if len(mols) == 2:
        return topology.DualTopology(mols[0], mols[1], ff)
    raise ValueError("mols must be length 1 or 2")


def host_guest_modules(mols, host_config, ff, lamb: float, device=None) -> tuple:
    """(modules, bond potential) of the host with mols inserted at λ
    (HostGuestTopology over a Base- or DualTopology), the modules on
    `device` (None: the card) in its working dtype:
    the valence terms, the guests' pair list, the host term over every atom
    with the guests masked out, and the guests x environment interaction
    group. The JAX package's SummedPotential of the last three is split into
    its terms; their sum is the same energy."""
    hgt = topology.HostGuestTopology(
        host_config.host_system.get_U_fns(), _guest_topology(mols, ff), host_config.num_water_atoms, ff,
        host_config.host_topology,
    )
    pots, params = parameterize_system(hgt, ff, lamb)
    bond, angle, proper, improper = (pot.bind(p) for pot, p in zip(pots[:4], params[:4]))
    host_nb, ixn, *intra = pots[4].bound_potentials(params[4])
    if not intra:
        intra = [terms.NonbondedPairListPrecomputed(np.zeros((0, 2), np.int32), ixn.potential.beta, ixn.potential.cutoff).bind(np.zeros((0, 4)))]
    empty = np.zeros((0, 4), dtype=np.int32)
    system = terms.HostGuestTerms(
        bond=bond, angle=angle, proper=proper, improper=improper,
        chiral_atom=terms.ChiralAtomRestraint(empty).bind(np.zeros(0)),
        chiral_bond=terms.ChiralBondRestraint(empty, np.zeros(0, dtype=np.int32)).bind(np.zeros(0)),
        nonbonded_pair_list=intra[0], nonbonded_all_pairs=host_nb, nonbonded_ixn_group=ixn,
    )
    device = resolve_device(device)
    modules = system.to_system(device=device, dtype=working_dtype(device)).get_U_fns()
    return [m for m in modules if m.params.numel() > 0], bond.potential


def configure_nonbonded(modules, x, box, site: str):
    """Give every all-pairs module not yet configured, in place, the
    configuration of the JAX package's form at `site`
    (potentials.all_pairs_kernel), sized at x and box."""
    for pot in modules:
        if isinstance(pot, NonbondedAllPairs) and pot.kernel is None:
            dt = pot.params.dtype
            kernel = all_pairs_kernel(site, pot.num_atoms, pot.params.device)
            pot.configure(box.to(dt), x.to(dt), kernel=kernel)


def exact_modules(modules, x, box) -> list:
    """The modules as a minimizer reads them: every all-pairs term not yet
    configured replaced by a copy configured at the "minimize" site (JAX's
    fresh impl="dense": exact erfc), so that the term itself stays
    unconfigured, as JAX's stays dense, until a Context configures it; a
    configured term as it is (JAX's get_context configures in place)."""
    out = []
    for pot in modules:
        if isinstance(pot, NonbondedAllPairs) and pot.kernel is None:
            pot = copy.deepcopy(pot)
            configure_nonbonded([pot], x, box, site="minimize")
        out.append(pot)
    return out


def total_force(modules, x, box):
    """The force of every module at x and box, in x's dtype on its device."""
    return sum(pot.energy_force(x, box)[1] for pot in modules)


def total_energy_force_f64(modules, x, box) -> tuple:
    """(u, force), float64 sums over the modules: the all-pairs terms by
    energy_force_f64 (the sweep in its own dtype, its energies summed in
    float64, the exclusions in float64), every other term's closed form
    u_force in float64."""
    f64 = torch.float64
    x64, box64 = x.to(f64), None if box is None else box.to(f64)
    u, f = x64.new_zeros(()), torch.zeros_like(x64)
    for pot in modules:
        if isinstance(pot, NonbondedAllPairs):
            u_t, f_t = pot.energy_force_f64(x64, box64)
        else:
            u_t, f_t = pot.u_force(x64, pot.params.to(f64), box64)
        u, f = u + u_t, f + f_t
    return u, f


def fire_minimize(x0, du_dx_fxn: Callable, config: FireMinimizationConfig) -> np.ndarray:
    """FIRE descent (ref minimizer.py:110-157): du_dx_fxn maps a tensor x
    (x0's device and dtype; numpy x0 becomes a CPU tensor) to dU/dx; every
    step stays on that device. Returns numpy."""
    x = torch.as_tensor(x0)
    return fire_descend(x, lambda xx: -du_dx_fxn(xx), config).cpu().numpy()


def make_host_du_dx_fxn(mols, host_config, ff, mol_coords=None, lamb: float = 0.0, device=None):
    """du/dx of the host atoms with mols inserted at λ, ligands frozen
    (ref minimizer.py:371-427): a function of the host coordinates, a
    tensor on `device` (None: the card) in its working dtype, to dU/dx of
    the host rows there."""
    modules, _ = host_guest_modules(mols, host_config, ff, lamb, device)
    device = resolve_device(device)
    dt = modules[0].params.dtype
    if mol_coords is None:
        mol_coords = [get_romol_conf(mol) for mol in mols]
    lig = torch.as_tensor(np.concatenate(mol_coords), device=device, dtype=dt)
    box = torch.as_tensor(host_config.box, device=device, dtype=dt)
    num_host_atoms = host_config.conf.shape[0]
    x0 = torch.cat([torch.as_tensor(host_config.conf, device=device, dtype=dt), lig])
    configure_nonbonded(modules, x0, box, site="host_du_dx")

    def du_dx_host_fxn(x_host):
        x = torch.cat([x_host, lig])
        return -total_force(modules, x, box)[:num_host_atoms]

    return du_dx_host_fxn


def fire_minimize_host(
    mols,
    host_config,
    ff,
    mol_coords=None,
    n_steps_per_window: int = 500,
    max_lambda: float = 0.1,
    n_windows: int = 2,
    device=None,
) -> np.ndarray:
    """Minimize the host's coordinates with mols inserted over decreasing
    λ windows, ligands fixed (ref minimizer.py:310-369), on `device` (None:
    the card); raises MinimizationError if the final forces are too large."""
    assert 1.0 >= max_lambda > 0.0
    device = resolve_device(device)
    x_host = torch.as_tensor(host_config.conf, device=device, dtype=working_dtype(device))
    config = FireMinimizationConfig(n_steps_per_window)
    du_dx_fxn = None
    for lamb in np.linspace(max_lambda, 0.0, n_windows):
        du_dx_fxn = make_host_du_dx_fxn(mols, host_config, ff, mol_coords=mol_coords, lamb=lamb, device=device)
        x_host = torch.as_tensor(fire_minimize(x_host, du_dx_fxn, config), device=device)
    check_force_norm(-du_dx_fxn(x_host).cpu().numpy())
    return x_host.cpu().numpy()


def pre_equilibrate_host(
    mols,
    host_config,
    ff,
    mol_coords=None,
    minimizer_steps_per_window: int = 500,
    minimizer_windows: int = 2,
    minimizer_max_lambda: float = 0.1,
    equilibration_steps: int = 1000,
    pressure: float = DEFAULT_PRESSURE,
    temperature: float = DEFAULT_TEMP,
    barostat_interval: int = 5,
    seed: int = 2024,
    device=None,
) -> tuple:
    """FIRE-minimize, then NPT-equilibrate the host with the ligands frozen
    at infinite mass and left out of the barostat's groups (ref
    minimizer.py:159-307), on `device` (None: the card). Returns (host
    coordinates, box) as numpy; asserts the ligands bitwise unmoved in the
    simulation dtype and raises MinimizationError if the host's final forces
    are too large."""
    box = np.asarray(host_config.box)
    assert box.shape == (3, 3)
    device = resolve_device(device)
    dtype = working_dtype(device)

    minimized_host_coords = fire_minimize_host(
        mols,
        host_config,
        ff,
        mol_coords=mol_coords,
        n_windows=minimizer_windows,
        n_steps_per_window=minimizer_steps_per_window,
        max_lambda=minimizer_max_lambda,
        device=device,
    )
    num_host_atoms = minimized_host_coords.shape[0]
    if mol_coords is None:
        mol_coords = [get_romol_conf(mol) for mol in mols]

    combined_masses = np.concatenate([np.array(host_config.masses)] + [np.ones(mol.num_atoms) * np.inf for mol in mols])
    combined_coords = np.concatenate([minimized_host_coords] + list(mol_coords))

    modules, bond_pot = host_guest_modules(mols, host_config, ff, 0.0, device)
    x0 = torch.as_tensor(combined_coords, device=device, dtype=dtype)
    configure_nonbonded(modules, x0, torch.as_tensor(box, device=device, dtype=dtype), site="context")

    group_idxs = get_group_indices(get_bond_list(bond_pot), combined_coords.shape[0])
    non_ligand_group_idxs = [g for g in group_idxs if np.all(g < num_host_atoms)]

    intg = LangevinIntegrator(temperature, 1.5e-3, 1.0, combined_masses, seed)
    baro = MonteCarloBarostat(
        combined_coords.shape[0], pressure, temperature, non_ligand_group_idxs, barostat_interval, seed + 1
    )
    ctxt = Context(x0, np.zeros_like(combined_coords), box, intg, modules, movers=[baro], device=device)
    ctxt.multiple_steps(equilibration_steps)
    x = ctxt.get_x_t()
    box = ctxt.get_box()

    # frozen ligand atoms are bitwise unmoved in the simulation dtype
    expected_ligand = np.concatenate(mol_coords).astype(x.dtype)
    assert np.all(x[num_host_atoms:] == expected_ligand), "Ligand atoms unexpectedly moved"

    forces = total_force(modules, torch.as_tensor(x, device=device), torch.as_tensor(box, device=device))
    check_force_norm(forces[:num_host_atoms].cpu().numpy())
    return x[:num_host_atoms], box


def equilibrate_host_barker(
    mols,
    host_config,
    ff,
    mol_coords=None,
    temperature: float = DEFAULT_TEMP,
    proposal_stddev: float = 0.0001,
    n_steps: int = 1000,
    seed=None,
    device=None,
) -> np.ndarray:
    """Clash-robust host equilibration by n_steps un-Metropolized Barker
    proposals (md/barker.py) with the mols inserted at λ 0 and frozen (ref
    minimizer.py:429-471), on `device` (None: the card) in its working
    dtype: grad log q = -dU/dx / kT from make_host_du_dx_fxn, one evaluation
    a step. The draws come from a torch.Generator seeded with `seed` (None:
    numpy's global stream picks one, as JAX's does). Returns the host's
    coordinates as numpy; raises MinimizationError if its final forces are
    too large."""
    if not 0 < proposal_stddev <= 0.0001:
        raise ValueError(f"proposal_stddev must be in (0, 1e-4], got {proposal_stddev}")
    device = resolve_device(device)
    du_dx_host_fxn = make_host_du_dx_fxn(mols, host_config, ff, mol_coords, device=device)
    kT = BOLTZ * temperature
    if seed is None:
        seed = np.random.randint(100000)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x0 = torch.as_tensor(host_config.conf, device=device, dtype=working_dtype(device))
    x_host = barker_chain(gen, x0, lambda x: -du_dx_host_fxn(x) / kT, proposal_stddev, n_steps)
    check_force_norm(-du_dx_host_fxn(x_host).cpu().numpy())
    return x_host.cpu().numpy()


def get_val_and_grad_fn(modules: Sequence, box) -> Callable:
    """coords (numpy) -> (U, dU/dx) of the modules at box (None: vacuum),
    float64 on the host (ref minimizer.py:473-497): one call of
    total_energy_force_f64 on the modules' device, each a deterministic
    sweep and one host round trip. The modules are read as exact_modules
    gives them at the first call's coordinates (`modules` holds them then).
    `calls` counts the calls."""
    device = modules[0].params.device
    box_t = None if box is None else torch.as_tensor(np.asarray(box), device=device, dtype=torch.float64)
    held = []

    def val_and_grad_fn(coords):
        x = torch.as_tensor(np.asarray(coords), device=device, dtype=torch.float64)
        if not held:
            held.extend(exact_modules(modules, x, box_t))
        val_and_grad_fn.calls += 1
        with torch.no_grad():
            u, f = total_energy_force_f64(held, x, box_t)
        return float(u), (-f).cpu().numpy()

    val_and_grad_fn.calls = 0
    val_and_grad_fn.modules = held
    return val_and_grad_fn


def wrap_val_and_grad_with_positional_restraint(val_and_grad_fn, x0, box0, restrained_idxs, k: float):
    """val_and_grad_fn plus k/2 |x - x0|^2 over restrained_idxs, in float64
    on the host (ref minimizer.py:500-518)."""
    idx = np.asarray(restrained_idxs)
    x_ref = torch.as_tensor(np.asarray(x0)[idx], dtype=torch.float64)
    box_t = None if box0 is None else torch.as_tensor(np.asarray(box0), dtype=torch.float64)

    def wrapped(x):
        u, g = val_and_grad_fn(x)
        x_r = torch.as_tensor(np.asarray(x)[idx], dtype=torch.float64)
        u_r = harmonic_positional_restraint(x_ref, x_r, box_t, k=k)
        g = np.array(g, dtype=np.float64)
        g[idx] += (k * periodic_delta(x_r, x_ref, box_t)).numpy()
        return u + float(u_r), g

    return wrapped


def scipy_minimize(x0, val_and_grad_fn, config: ScipyMinimizationConfig):
    """(ref minimizer.py:521-544)"""
    shape = x0.shape

    def f(x_flat):
        u, g = val_and_grad_fn(x_flat.reshape(shape))
        return u, np.asarray(g, dtype=np.float64).reshape(-1)

    res = scipy.optimize.minimize(
        f, np.asarray(x0).reshape(-1), method=config.method, jac=True, bounds=config.bounds, options=config.options or {}
    )
    return res.x.reshape(shape)


def local_minimize(
    x0,
    box0,
    val_and_grad_fn,
    local_idxs,
    minimizer_config,
    verbose: bool = True,
    assert_energy_decreased: bool = True,
    restraint_k: float = 0.0,
    restrained_idxs=None,
):
    """Minimize only local_idxs, everything else frozen (ref
    minimizer.py:546-680); val_and_grad_fn maps numpy coordinates to (U,
    dU/dx) as numpy."""
    if not isinstance(minimizer_config, (FireMinimizationConfig, ScipyMinimizationConfig)):
        raise ValueError(f"Invalid minimizer config: {type(minimizer_config)}")
    assert restraint_k >= 0.0
    if restrained_idxs is not None:
        assert restraint_k > 0.0
        assert set(map(int, restrained_idxs)).issubset(set(map(int, local_idxs)))

    method = minimizer_config.method if isinstance(minimizer_config, ScipyMinimizationConfig) else "FIRE"
    assert len(local_idxs) == len(set(map(int, local_idxs)))
    free_idxs = np.asarray(local_idxs)
    x0 = np.asarray(x0)

    u_0, _ = val_and_grad_fn(x0)

    minimizer_val_and_grad = val_and_grad_fn
    if restraint_k > 0.0:
        if restrained_idxs is None:
            restrained_idxs = free_idxs
        minimizer_val_and_grad = wrap_val_and_grad_with_positional_restraint(
            val_and_grad_fn, x0, box0, np.asarray(restrained_idxs), restraint_k
        )

    def val_and_grad_local(x_local):
        x_prime = x0.copy()
        x_prime[free_idxs] = x_local
        u_full, grad_full = minimizer_val_and_grad(x_prime)
        if method != "FIRE" and np.isnan(u_full):
            u_full = np.inf
            grad_full = np.nan * grad_full
        return u_full, grad_full[free_idxs]

    if verbose:
        print(f"performing {method} minimization on {len(free_idxs)} atoms (holding {len(x0) - len(free_idxs)} frozen)")
        print(f"U(x_0) = {u_0:.3f}")

    x_local_0 = x0[free_idxs]
    if isinstance(minimizer_config, ScipyMinimizationConfig):
        x_local_final = scipy_minimize(x_local_0, val_and_grad_local, minimizer_config)
    else:
        x_local_final = fire_minimize(
            x_local_0, lambda x: torch.as_tensor(val_and_grad_local(x.numpy())[1]), minimizer_config
        )

    x_final = x0.copy()
    x_final[free_idxs] = x_local_final

    u_final, grad_final = val_and_grad_fn(x_final)
    forces = -grad_final
    if verbose:
        print(f"U(x_final) = {u_final:.3f}")
    check_force_norm(forces)

    if assert_energy_decreased:
        if not np.isnan(u_0):
            assert u_final < u_0, f"U_0: {u_0:.3f}, U_f: {u_final:.3f}"
        else:
            assert np.isfinite(u_final), f"U_0: {u_0:.3f}, U_f: {u_final:.3f}"
    elif u_final >= u_0:
        warnings.warn(f"Energy did not decrease: U_0: {u_0:.3f}, U_f: {u_final:.3f}", MinimizationWarning)

    return x_final


def replace_conformer_with_minimized(mol, ff, minimizer_config=None, device=None):
    """Minimize mol's conformer in vacuum, in place (ref minimizer.py:683-713),
    the energies on `device` (None: the card)."""
    from timemachine_torch.fe.model_utils import get_vacuum_val_and_grad_fn

    config = minimizer_config or ScipyMinimizationConfig(method="BFGS")
    val_and_grad = get_vacuum_val_and_grad_fn(mol, ff, device=device)
    x0 = get_romol_conf(mol)
    x_min = local_minimize(x0, None, val_and_grad, np.arange(mol.num_atoms), config, verbose=False)
    mol.set_conf(x_min)
