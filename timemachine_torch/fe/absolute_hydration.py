"""Absolute hydration free energies (AHFE): a ligand decoupled from water in
4D, estimated by windowed pair BAR or by SMC (the port of
timemachine_tpu/fe/absolute_hydration.py).

The windowed leg (run_solvent, estimate_absolute_free_energy,
setup_initial_states) builds one InitialState per λ of the pre-optimized
decoupling schedule, run decoupled (λ = 1) to coupled (λ = 0): the host's
all-pairs term under the atom subset, the ligand's interaction group with
w = λ cutoff, its intramolecular pair list, HMR masses, a barostat every 15
steps, every window the same integrator and barostat seed. The windows are
sampled in one reused Context (run_sims_sequential: the masked rowscan
sweep on the card), the host's FIRE on nb_tiles' exact form (site
"host_du_dx"). The pair-BAR plots are rendered where matplotlib imports;
where it does not, plots=None with one warning (ROADMAP P21).

The SMC path anneals walkers made of equilibrium solvent frames and
importance-resampled vacuum conformers (md/enhanced.py) with one NPTMove,
whose parameters are swapped per λ without a rebuild (params_list_at caches
each λ's parameters). SMC's reduced potential is float64 (P22's
energy_force_f64: an f32 sweep summed in float64, every other term in
float64, ROADMAP P27), on potentials no Context configured (site "fresh").
Where the JAX package draws from numpy's global stream after
np.random.seed(seed), the port draws from np.random.RandomState(seed)
through the same calls in the same order (P25).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ, DEFAULT_TEMP
from timemachine_torch.device import resolve_device, working_dtype
from timemachine_torch.fe import model_utils
from timemachine_torch.fe.free_energy import (
    AbsoluteFreeEnergy,
    InitialState,
    MDParams,
    SimulationResult,
    make_pair_bar_plots,
    run_sims_sequential,
)
from timemachine_torch.fe.lambda_schedule import construct_pre_optimized_absolute_lambda_schedule_solvent
from timemachine_torch.fe.plots import plots_available
from timemachine_torch.fe.rbfe import _postmortem_on_failure
from timemachine_torch.fe.topology import BaseTopology
from timemachine_torch.fe.utils import get_mol_name, get_romol_conf
from timemachine_torch.ff import Forcefield
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md import builders, enhanced, minimizer, smc
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.moves import NPTMove
from timemachine_torch.md.states import CoordsVelBox
from timemachine_torch.md.utils import get_bond_list, get_group_indices

DEFAULT_AHFE_MD_PARAMS = MDParams(n_frames=1000, n_eq_steps=10_000, steps_per_frame=400, seed=2023)

N_ENDSTATE_SAMPLES = 5000


def generate_endstate_samples(
    num_samples: int,
    solvent_samples: Sequence[CoordsVelBox],
    ligand_samples: Sequence,
    ligand_log_weights,
    num_ligand_atoms: int,
    rng=None,
) -> list:
    """Decoupled-endstate samples: each pairs a uniformly drawn solvent
    frame with an importance-resampled vacuum conformer (valid at λ = 1,
    where the two are independent). The ligand atoms are the last
    num_ligand_atoms of each frame. Draws from `rng` (a numpy RandomState
    or Generator; None: a fresh default_rng()): the conformers, then the
    frames."""
    n_solvent_atoms = len(solvent_samples[0].coords) - num_ligand_atoms
    assert n_solvent_atoms > 0, "Oops, did you really mean num_ligand_atoms >= num_total_atoms?"
    rng = np.random.default_rng() if rng is None else rng

    lig_draws = enhanced.sample_from_log_weights(ligand_samples, ligand_log_weights, size=num_samples, rng=rng)
    env_draws = rng.choice(len(solvent_samples), size=num_samples, replace=True)

    def splice(env: CoordsVelBox, lig_xv) -> CoordsVelBox:
        lig_x, lig_v = lig_xv
        return CoordsVelBox(
            np.concatenate([env.coords[:n_solvent_atoms], lig_x]),
            np.concatenate([env.velocities[:n_solvent_atoms], lig_v]),
            env.box,
        )

    return [splice(solvent_samples[e], lig) for e, lig in zip(env_draws, lig_draws)]


def _endpoint_machinery(
    mol, ff, system, solvent_xvbs, ligand_samples, ligand_log_weights, num_endstate_samples: int,
    temperature, pressure, n_steps, seed, rng, device=None,
):
    """(reduced_potential_fxn, npt_mover, endstate samples) of the solvated
    system `system` (get_solvent_phase_system's output at λ = 1) from
    pregenerated samples: the body of
    setup_absolute_hydration_with_endpoint_samples."""
    potentials, params, masses, _, _ = system
    kBT = BOLTZ * temperature

    # λ enters only through the parameters (the decoupling terms' w), so one
    # set of modules and one mover serve every window: swap parameters, never rebuild
    per_lambda_params = {1.0: [np.asarray(torch.as_tensor(p).detach()) for p in params]}

    def params_list_at(lam: float):
        lam = float(lam)
        if lam not in per_lambda_params:
            _, p_lam, *_ = enhanced.get_solvent_phase_system(mol, ff, lamb=lam, minimize_energy=False)
            per_lambda_params[lam] = [np.asarray(torch.as_tensor(p).detach()) for p in p_lam]
        return per_lambda_params[lam]

    U_modules = enhanced.solvent_phase_modules(potentials, params, len(masses), device)

    def reduced_potential_fxn(xvb, lam):
        """u(x, λ) / kT in float64 (P27), the all-pairs term as a fresh
        potential's form (site "fresh"), sized at the first call."""
        dev = U_modules[0].params.device
        x = torch.as_tensor(np.asarray(xvb.coords), device=dev, dtype=torch.float64)
        box = torch.as_tensor(np.asarray(xvb.box), device=dev, dtype=torch.float64)
        minimizer.configure_nonbonded(U_modules, x, box, site="fresh")
        with torch.no_grad():
            for pot, p in zip(U_modules, params_list_at(lam)):
                pot.params.copy_(torch.as_tensor(p))
            u, _ = minimizer.total_energy_force_f64(U_modules, x, box)
        return float(u) / kBT

    npt_mover = NPTMove(
        enhanced.solvent_phase_modules(potentials, params, len(masses), device), masses, temperature, pressure,
        n_steps=n_steps, seed=seed,
    )
    npt_mover.params_list_at = params_list_at  # what SMC's propagate reads

    endstate_samples = generate_endstate_samples(
        num_endstate_samples, solvent_xvbs, ligand_samples, ligand_log_weights, mol.num_atoms, rng=rng
    )
    return reduced_potential_fxn, npt_mover, endstate_samples


def setup_absolute_hydration_with_endpoint_samples(
    mol, temperature=300.0, pressure=1.0, n_steps=1000, seed=2022, ff=None, num_workers=None, device=None
):
    """Decoupled-endstate (λ = 1) equilibrium samples and what anneals them,
    (reduced_potential_fxn, npt_mover, initial_samples), on `device` (None:
    the card)."""
    if not isinstance(seed, int):
        seed = int(np.random.default_rng().integers(1000))
        print(f"setting seed randomly to {seed}")
    else:
        print(f"setting seed to {seed}")
    rng = np.random.RandomState(seed)  # JAX's np.random.seed(seed)

    ff = ff or Forcefield.load_default()
    system = enhanced.get_solvent_phase_system(mol, ff, lamb=1.0, device=device)
    solvent_xvbs, ligand_samples, ligand_log_weights = enhanced.pregenerate_samples(
        mol, ff, 1.0, seed, temperature=temperature, pressure=pressure, num_workers=num_workers, device=device
    )
    return _endpoint_machinery(
        mol, ff, system, solvent_xvbs, ligand_samples, ligand_log_weights, N_ENDSTATE_SAMPLES, temperature, pressure,
        n_steps, seed, rng, device,
    )


def _smc_ingredients(reduced_potential, mover, endstate_samples, n_walkers, n_windows, resample_thresh, seed):
    """(samples, lambdas, propagate, log_prob, resample) from the endpoint
    machinery: the body of set_up_ahfe_system_for_smc. The walkers and the
    resampler draw from one RandomState(seed) (JAX's np.random.seed(seed),
    then its global stream)."""
    rng = np.random.RandomState(seed)
    walkers = [endstate_samples[i] for i in rng.choice(len(endstate_samples), size=n_walkers)]

    # the package's convention: λ = 1 decoupled, λ = 0 coupled
    lambdas = construct_pre_optimized_absolute_lambda_schedule_solvent(n_windows)

    def propagate(xs, lam):
        mover.set_params(mover.params_list_at(lam))  # a window switch without a rebuild
        return [mover.move(x) for x in xs]

    def log_prob(xs, lam):
        return -np.array([reduced_potential(x, lam) for x in xs])

    resample = partial(smc.conditional_multinomial_resample, thresh=resample_thresh, rng=rng)
    return walkers, lambdas, propagate, log_prob, resample


def set_up_ahfe_system_for_smc(
    mol, n_walkers, n_windows, n_md_steps, resample_thresh, seed=2022, ff=None, num_workers=None, device=None
):
    """SMC's ingredients, (samples, lambdas, propagate, log_prob, resample),
    on `device` (None: the card)."""
    reduced_potential, mover, endstate_samples = setup_absolute_hydration_with_endpoint_samples(
        mol, n_steps=n_md_steps, seed=seed, ff=ff, num_workers=num_workers, device=device
    )
    return _smc_ingredients(reduced_potential, mover, endstate_samples, n_walkers, n_windows, resample_thresh, seed)


def _initial_state_at(
    afe: AbsoluteFreeEnergy, ff: Forcefield, host_config, host_conf, temperature, lamb, seed, device=None
) -> InitialState:
    """One InitialState of the decoupling leg at `lamb` (NPT, HMR, the
    ligand appended after the host atoms), its potentials the port's
    modules on `device` (None: the card) in its working dtype."""
    from timemachine_torch.convert import modules_from_bound_potentials
    from timemachine_torch.fe import terms

    ubps, params, masses = afe.prepare_host_edge(ff, host_config, lamb)
    bps = [ubp.bind(param) for ubp, param in zip(ubps, params)]
    x0 = afe.prepare_combined_coords(host_coords=host_conf)
    v0 = np.zeros_like(x0)

    bond_pot = next(pot for pot in ubps if isinstance(pot, terms.HarmonicBond))
    hmr_masses = model_utils.apply_hmr(masses, bond_pot.idxs)
    groups = get_group_indices(get_bond_list(bond_pot), len(masses))
    barostat = MonteCarloBarostat(len(hmr_masses), 1.0, temperature, groups, 15, seed)

    n_lig = len(get_romol_conf(afe.mol))
    ligand_idxs = np.arange(len(x0) - n_lig, len(x0))
    integrator = LangevinIntegrator(temperature, 2.5e-3, 1.0, hmr_masses, seed)
    device = resolve_device(device)
    potentials = modules_from_bound_potentials(bps, len(x0), device, working_dtype(device))
    return InitialState(
        potentials, integrator, barostat, x0, v0, host_config.box, lamb, ligand_idxs, np.array([], dtype=np.int32)
    )


def setup_initial_states(
    afe: AbsoluteFreeEnergy,
    ff: Forcefield,
    host_config,
    temperature: float,
    lambda_schedule,
    seed: int,
    device=None,
) -> list:
    """An InitialState per window of a strictly decreasing (decoupled ->
    coupled) schedule, all from one FIRE-minimized host conformation, on
    `device` (None: the card)."""
    assert np.all(np.diff(lambda_schedule) < 0)
    host_conf = minimizer.fire_minimize_host([afe.mol], host_config, ff, device=device)
    return [
        _initial_state_at(afe, ff, host_config, host_conf, temperature, lamb, seed, device) for lamb in lambda_schedule
    ]


def estimate_absolute_free_energy(
    mol,
    ff: Forcefield,
    host_config,
    prefix="",
    md_params: MDParams = DEFAULT_AHFE_MD_PARAMS,
    n_windows=None,
    device=None,
):
    """Windowed AHFE on `device` (None: the card): the windows sampled one
    after another in one Context, then pair BAR. On a failure the inputs
    are pickled to failed_ahfe_result_<name>.pkl."""
    if md_params is None:
        md_params = MDParams(n_frames=2000, steps_per_frame=400, n_eq_steps=200000, seed=2023)
    afe = AbsoluteFreeEnergy(mol, BaseTopology(mol, ff))

    # the package's convention: λ = 1 decoupled; run the schedule decoupled -> coupled
    schedule = construct_pre_optimized_absolute_lambda_schedule_solvent(n_windows)[::-1]
    assert np.isclose(schedule[0], 1.0) and np.isclose(schedule[-1], 0.0)

    temperature = DEFAULT_TEMP
    initial_states = setup_initial_states(afe, ff, host_config, temperature, schedule, md_params.seed, device)

    run_name = f"{get_mol_name(mol)}_{prefix}"
    with _postmortem_on_failure(run_name, (initial_states, md_params), kind="ahfe"):
        result, stored_trajectories = run_sims_sequential(initial_states, md_params, temperature)
    plots = make_pair_bar_plots(result, temperature, run_name) if plots_available("plots") else None
    return SimulationResult(result, plots, stored_trajectories, md_params, [])


def run_solvent(mol, forcefield: Forcefield, _, md_params: MDParams, n_windows=16, device=None) -> tuple:
    """A 4 nm water box around the ligand, 0.1 nm of slack for the
    barostat, and its windowed AHFE on `device` (None: the card). Returns
    (result, host config)."""
    host_config = builders.build_water_system(4.0, forcefield.water_ff, mols=[mol])
    host_config.box += np.diag([0.1, 0.1, 0.1])  # barostat equilibration slack
    result = estimate_absolute_free_energy(
        mol, forcefield, host_config, md_params=md_params, prefix="solvent", n_windows=n_windows, device=device
    )
    return result, host_config
