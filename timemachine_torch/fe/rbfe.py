"""Relative binding free energy (RBFE) drivers over a single-topology
edge: window states, the λ-chain minimization of their coordinates, the
fixed-grid, bisection and HREX estimators, and the vacuum, solvent and
complex legs (the port of timemachine_tpu/fe/rbfe.py).

An AlchemicalEdge holds the edge's SingleTopology, its pre-equilibrated host
(md/minimizer.py pre_equilibrate_host), its seed and the anchor states whose
coordinates build_grid_states minimizes in two λ chains; new λ points take
their coordinates from the nearest anchor. Sampling runs through
fe/free_energy.py. Every state's potentials live on the edge's device (None:
the card) in its working dtype (float32 on the card); the minimizations'
energies are float64 (md/minimizer.py).

Seeds are derived as the JAX package derives them, from this package's own
bytes: the velocities' and the barostat's from the ligand conformer, the
integrator's from every potential's f64 parameters (ROADMAP P18, P20).
With REST parameters the edge's topology is fe/rest/'s SingleTopologyREST,
whose intermediate states run the hot region at a raised effective
temperature (DEFAULT_REST_PARAMS). The estimators render their plots
(fe/plots.py) where matplotlib imports; where it does not they return
plots=None and hrex_plots=None, with one warning (ROADMAP P21).
rebalance_lambda_schedule raises (ROADMAP R8).
"""

from __future__ import annotations

import pickle
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional, Sequence, Union, cast

import numpy as np
import torch

from timemachine_torch.constants import (
    BAROSTAT_INTERVAL,
    DEFAULT_POSITIONAL_RESTRAINT_K,
    DEFAULT_PRESSURE,
    DEFAULT_TEMP,
    MAX_SEED_VALUE,
    MD_DT,
    MD_FRICTION,
)
from timemachine_torch.device import resolve_device, working_dtype
from timemachine_torch.fe import model_utils
from timemachine_torch.fe.free_energy import (
    HREXParams,
    HREXPlots,
    HREXSimulationResult,
    InitialState,
    MDParams,
    RESTParams,
    SimulationResult,
    Trajectory,
    make_pair_bar_plots,
    run_sims_bisection,
    run_sims_hrex,
    run_sims_sequential,
)
from timemachine_torch.fe.lambda_schedule import bisection_lambda_schedule
from timemachine_torch.fe.plots import plots_available
from timemachine_torch.fe.rest.single_topology import SingleTopologyREST
from timemachine_torch.fe.single_topology import AtomMapFlags, SingleTopology
from timemachine_torch.fe.terms import HostTerms
from timemachine_torch.fe.utils import bytes_to_id, get_mol_name, get_romol_conf
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md import builders, minimizer
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.fire import ScipyMinimizationConfig
from timemachine_torch.md.utils import get_bond_list, get_group_indices, sample_velocities
from timemachine_torch.ops.pbc import idxs_within_cutoff, lifted_distance_on_pairs

DEFAULT_NUM_WINDOWS = 48

DEFAULT_MD_PARAMS = MDParams(n_frames=1000, n_eq_steps=10_000, steps_per_frame=400, seed=2023, hrex_params=None)

DEFAULT_HREX_PARAMS = replace(DEFAULT_MD_PARAMS, hrex_params=HREXParams(n_frames_bisection=100))

DEFAULT_REST_PARAMS = replace(
    DEFAULT_HREX_PARAMS,
    hrex_params=replace(
        DEFAULT_HREX_PARAMS.hrex_params,
        rest_params=RESTParams(max_temperature_scale=3.0, temperature_scale_interpolation="exponential"),
    ),
)


def make_single_topology(mol_a, mol_b, core, ff, rest_params: Optional[RESTParams] = None) -> SingleTopology:
    """The edge's SingleTopology, or with rest_params its SingleTopologyREST."""
    if rest_params is None:
        return SingleTopology(mol_a, mol_b, core, ff)
    return SingleTopologyREST(
        mol_a,
        mol_b,
        core,
        ff,
        max_temperature_scale=rest_params.max_temperature_scale,
        temperature_scale_interpolation=rest_params.temperature_scale_interpolation,
    )


@dataclass
class Host:
    system: HostTerms
    physical_masses: list
    conf: np.ndarray
    box: np.ndarray
    num_water_atoms: int
    host_topology: object


def setup_in_vacuum(st: SingleTopology, ligand_conf, lamb):
    """Vacuum leg environment: ligand-only terms in a big fixed box."""
    system = st.setup_intermediate_state(lamb)
    return (
        ligand_conf,
        np.eye(3, dtype=np.float64) * 10.0,
        np.array(st.combine_masses(use_hmr=True)),
        system,
        None,
    )


def setup_in_env(st: SingleTopology, host: Host, ligand_conf: np.ndarray, lamb: float, temperature: float, run_seed: int):
    """Host leg environment: combined terms, HMR masses, NPT barostat."""
    system = st.combine_with_host(host.system, lamb, host.num_water_atoms, st.ff, host.host_topology)
    host_hmr_masses = model_utils.apply_hmr(host.physical_masses, host.system.bond.potential.idxs)
    hmr_masses = np.concatenate([host_hmr_masses, st.combine_masses(use_hmr=True)])

    group_idxs = get_group_indices(get_bond_list(system.bond.potential), len(hmr_masses))
    barostat = MonteCarloBarostat(len(hmr_masses), DEFAULT_PRESSURE, temperature, group_idxs, BAROSTAT_INTERVAL, run_seed + 1)
    return np.concatenate([host.conf, ligand_conf]), hmr_masses, system, barostat


def _interacting_ligand_atoms(st: SingleTopology, ligand_idxs, lamb: float):
    """Ligand atoms in the w=0 plane (fully interacting) at this λ."""
    if lamb == 0.0:
        keep = st.c_flags != AtomMapFlags.MOL_B
    elif lamb == 1.0:
        keep = st.c_flags != AtomMapFlags.MOL_A
    else:
        keep = st.c_flags == AtomMapFlags.CORE
    return ligand_idxs[keep]


def param_bytes(terms) -> bytes:
    """The bytes the integrator seed hashes: every potential's f64
    parameters in get_U_fns order."""
    return b"".join(bp.params.detach().cpu().numpy().astype(np.float64, copy=False).tobytes() for bp in terms)


def setup_initial_state(
    st: SingleTopology,
    lamb: float,
    host: Optional[Host],
    temperature: float,
    seed: int,
    device=None,
    dtype=None,
) -> InitialState:
    """One λ-window's InitialState, potentials on `device` (None: the card)
    in `dtype` (None: the device's working dtype), with
    edge-direction-symmetric seeding (the derived seed depends on the
    combined conformer / parameter bytes, not on which molecule is called A)."""
    ligand_conf = st.combine_confs(get_romol_conf(st.mol_a), get_romol_conf(st.mol_b), lamb)
    init_seed = int(seed + bytes_to_id(ligand_conf.tobytes())) % MAX_SEED_VALUE
    device = resolve_device(device)
    dtype = working_dtype(device, dtype)

    if host is not None:
        x0, hmr_masses, system, barostat = setup_in_env(st, host, ligand_conf, lamb, temperature, init_seed)
        box0 = host.box
        protein_idxs = np.arange(0, len(host.physical_masses) - host.num_water_atoms)
        potentials = system.to_system(device=device, dtype=dtype).get_U_fns()
    else:
        x0, box0, hmr_masses, system, barostat = setup_in_vacuum(st, ligand_conf, lamb)
        protein_idxs = np.array([], dtype=np.int32)
        potentials = system.to_system(len(x0), device=device, dtype=dtype).get_U_fns()

    run_seed = int(seed + bytes_to_id(param_bytes(system.get_U_fns()))) % MAX_SEED_VALUE

    n_total = len(x0)
    ligand_idxs = np.arange(n_total - len(ligand_conf), n_total, dtype=np.int32)

    return InitialState(
        potentials,
        LangevinIntegrator(temperature, MD_DT, MD_FRICTION, hmr_masses, run_seed),
        barostat,
        x0,
        sample_velocities(hmr_masses, temperature, init_seed),
        box0,
        lamb,
        ligand_idxs,
        protein_idxs.astype(np.int32),
        interacting_atoms=_interacting_ligand_atoms(st, ligand_idxs, lamb),
    )


def assert_all_states_have_same_masses(initial_states: Sequence[InitialState]):
    masses = np.array([s.integrator.masses for s in initial_states])
    np.testing.assert_array_almost_equal(masses.std(0), 0, err_msg="masses assumed constant w.r.t. lambda")


def _default_minimization_config():
    return ScipyMinimizationConfig(method="BFGS", options={"disp": False})


@contextmanager
def _postmortem_on_failure(tag: str, payload, kind: str = "rbfe"):
    """Pickle enough context to replay a failed estimate to
    failed_<kind>_result_<tag>.pkl, then re-raise the failure (whatever
    becomes of the pickle)."""
    try:
        yield
    except Exception as err:
        try:
            with open(f"failed_{kind}_result_{tag}.pkl", "wb") as fh:
                pickle.dump((*payload, err), fh)
        except Exception as dump_err:  # the failure, not the pickle, is what the caller needs
            warnings.warn(f"could not pickle the failed estimate's context: {dump_err}")
        raise


def setup_optimized_host(st: SingleTopology, config, device=None) -> Host:
    """FIRE-minimize and NPT pre-equilibrate the host around the ligand pair
    on `device` (None: the card)."""
    conf, box = minimizer.pre_equilibrate_host([st.mol_a, st.mol_b], config, st.ff, device=device)
    return Host(config.host_system, config.masses, conf, box, config.num_water_atoms, config.host_topology)


# -- schedule-sweep coordinate optimization -----------------------------------


def get_free_idxs(initial_state: InitialState, cutoff: float = 0.5) -> list[int]:
    """Particles within cutoff of the ligand."""
    x = initial_state.x0
    return idxs_within_cutoff(x, x[initial_state.ligand_idxs], initial_state.box0, cutoff=cutoff).tolist()


def optimize_coords_state(
    potentials: Sequence,
    x0: np.ndarray,
    box: np.ndarray,
    free_idxs: list[int],
    assert_energy_decreased: bool,
    k: float,
    restrained_idxs: Optional[np.ndarray] = None,
    minimization_config=None,
) -> np.ndarray:
    """Minimize the free subset of a state's potentials (modules),
    optionally position-restrained; float64 energies on their device."""
    val_and_grad_fn = minimizer.get_val_and_grad_fn(potentials, box)
    assert np.all(np.isfinite(x0)), "Initial coordinates contain nan or inf"
    x_opt = minimizer.local_minimize(
        x0,
        box,
        val_and_grad_fn,
        free_idxs,
        minimization_config or _default_minimization_config(),
        verbose=False,
        assert_energy_decreased=assert_energy_decreased,
        restrained_idxs=restrained_idxs,
        restraint_k=k,
    )
    assert np.all(np.isfinite(x_opt)), "Minimization resulted in a nan"
    return x_opt


def _minimize_chain(states: Sequence[InitialState], k: float, config) -> list[np.ndarray]:
    """Minimize states in order, each starting from the previous optimum:
    the λ-sweep that keeps dummy-group geometries continuous."""
    xs: list[np.ndarray] = []
    x_carry = states[0].x0
    for i, state in enumerate(states):
        print(f"Optimizing initial state at λ={state.lamb}")
        try:
            x_carry = optimize_coords_state(
                state.potentials,
                x_carry,
                state.box0,
                get_free_idxs(state),
                minimization_config=config,
                assert_energy_decreased=(i == 0),
                restrained_idxs=state.interacting_atoms,
                k=k,
            )
        except (AssertionError, minimizer.MinimizationError) as e:
            raise minimizer.MinimizationError(f"Failed to optimized state at λ={state.lamb}") from e
        xs.append(x_carry)
    return xs


def displacements(state: InitialState, coords: np.ndarray) -> tuple:
    """(watched atoms, their minimum-image distance from the state's x0):
    the interacting ligand atoms and the protein."""
    watched = (
        state.protein_idxs
        if state.interacting_atoms is None
        else np.concatenate([state.interacting_atoms, state.protein_idxs])
    )
    f64 = torch.float64
    distances = lifted_distance_on_pairs(
        torch.as_tensor(state.x0[watched], dtype=f64), torch.as_tensor(coords[watched], dtype=f64),
        box=torch.as_tensor(np.asarray(state.box0), dtype=f64),
    ).numpy()
    return watched, distances


def _check_displacements(state: InitialState, coords: np.ndarray, min_cutoff: float):
    """Physical (interacting + protein) atoms must not have walked far during
    minimization: large displacements flag a bad mapping or clash."""
    watched, distances = displacements(state, coords)
    moved = watched[distances >= min_cutoff]
    assert len(moved) == 0, (
        f"λ = {state.lamb} moved atoms {np.asarray(moved).tolist()} > {min_cutoff * 10} Å "
        f"from initial state during minimization. Largest displacement was "
        f"{(distances.max() if len(distances) else 0.0) * 10} Å"
    )


def optimize_coordinates(
    initial_states: Sequence[InitialState],
    min_cutoff: Optional[float] = 0.7,
    k: float = DEFAULT_POSITIONAL_RESTRAINT_K,
    minimization_config=None,
) -> list[np.ndarray]:
    """Per-state optimized coordinates: sweep λ 0 -> 0.5 and 1 -> 0.5 so both
    end-state geometries relax toward the midpoint."""
    config = minimization_config or _default_minimization_config()
    lambdas = np.array([s.lamb for s in initial_states])
    assert np.all(np.diff(lambdas) > 0)

    left = [s for s in initial_states if s.lamb < 0.5]
    right = [s for s in initial_states if s.lamb >= 0.5]

    xs: list[np.ndarray] = []
    if left:
        xs.extend(_minimize_chain(left, k, config))
    if right:
        xs.extend(_minimize_chain(right[::-1], k, config)[::-1])

    if min_cutoff is not None:
        for state, coords in zip(initial_states, xs):
            _check_displacements(state, coords, min_cutoff)
    return xs


def setup_initial_states(
    st: SingleTopology,
    host: Optional[Host],
    temperature: float,
    lambda_schedule: Union[np.ndarray, Sequence[float]],
    seed: int,
    min_cutoff: Optional[float] = None,
    device=None,
) -> list[InitialState]:
    """InitialState per λ with schedule-swept optimized coordinates,
    potentials on `device` (None: the card)."""
    assert np.all(np.diff(lambda_schedule) > 0)
    states = [setup_initial_state(st, lamb, host, temperature, seed, device) for lamb in lambda_schedule]
    for state, x_opt in zip(states, optimize_coordinates(states, min_cutoff=min_cutoff)):
        state.x0 = x_opt
    assert_all_states_have_same_masses(states)
    return states


def get_nearest_state_idx(lamb: float, initial_states: Sequence[InitialState]) -> int:
    """Nearest pre-built state on the same side of λ = 0.5."""
    same_side = [(i, s.lamb) for i, s in enumerate(initial_states) if (s.lamb <= 0.5) == (lamb <= 0.5)]
    return min(same_side, key=lambda pair: abs(lamb - pair[1]))[0]


def optimize_initial_state_from_pre_optimized(
    initial_state: InitialState,
    optimized_initial_states: Sequence[InitialState],
    k: float = DEFAULT_POSITIONAL_RESTRAINT_K,
) -> InitialState:
    """Seed a new λ point from the nearest already-optimized state."""
    nearest = optimized_initial_states[get_nearest_state_idx(initial_state.lamb, optimized_initial_states)]
    if np.isclose(initial_state.lamb, nearest.lamb):
        return nearest
    initial_state.x0 = optimize_coords_state(
        initial_state.potentials,
        nearest.x0,
        initial_state.box0,
        get_free_idxs(nearest),
        assert_energy_decreased=False,
        k=k,
    )
    return initial_state


def rebalance_lambda_schedule(*args, **kwargs):
    """Re-spacing λ by MBAR overlap: JAX's reads a key its MBAR does not
    return (ROADMAP R8), so the port raises."""
    raise NotImplementedError("rebalance_lambda_schedule raises KeyError in the JAX package (ROADMAP R8); not ported")


# -- the edge object ----------------------------------------------------------


@dataclass
class AlchemicalEdge:
    """One A -> B transformation in one environment, ready to be estimated,
    its states' potentials on `device`."""

    st: SingleTopology
    host: Optional[Host]
    temperature: float
    seed: int
    tag: str
    lambda_interval: tuple[float, float] = (0.0, 1.0)
    device: torch.device = field(default_factory=resolve_device)
    _anchors: list = field(default_factory=list)  # optimized grid states

    @classmethod
    def create(
        cls,
        mol_a,
        mol_b,
        core,
        ff,
        host_config,
        prefix: str,
        seed: int,
        lambda_interval: Optional[tuple[float, float]] = None,
        rest_params: Optional[RESTParams] = None,
        device=None,
    ) -> "AlchemicalEdge":
        """The edge's SingleTopology (SingleTopologyREST with rest_params)
        and, with host_config, its host pre-equilibrated on `device` (None:
        the card)."""
        device = resolve_device(device)
        st = make_single_topology(mol_a, mol_b, core, ff, rest_params)
        host = setup_optimized_host(st, host_config, device) if host_config else None
        tag = f"{get_mol_name(mol_a)}_{get_mol_name(mol_b)}_{prefix}"
        return cls(st, host, DEFAULT_TEMP, seed, tag, lambda_interval or (0.0, 1.0), device)

    def state_at(self, lamb: float) -> InitialState:
        return setup_initial_state(self.st, lamb, self.host, self.temperature, self.seed, self.device)

    def optimized_state_at(self, lamb: float) -> InitialState:
        """New λ state, coordinates seeded from the nearest anchor."""
        assert self._anchors, "build_grid_states must run first"
        return optimize_initial_state_from_pre_optimized(self.state_at(lamb), self._anchors)

    def build_grid_states(self, lambda_schedule, min_cutoff: Optional[float]) -> list[InitialState]:
        self._anchors = setup_initial_states(
            self.st, self.host, self.temperature, lambda_schedule, self.seed, min_cutoff, self.device
        )
        return self._anchors


# -- estimators ---------------------------------------------------------------


def estimate_relative_free_energy(
    mol_a,
    mol_b,
    core: np.ndarray,
    ff,
    host_config,
    prefix: str = "",
    lambda_interval: Optional[tuple[float, float]] = None,
    n_windows: Optional[int] = None,
    md_params: MDParams = DEFAULT_MD_PARAMS,
    min_cutoff: Optional[float] = 0.7,
    device=None,
) -> SimulationResult:
    """Fixed linear λ grid; window simulations in one Context + pair BAR."""
    n_windows = n_windows or DEFAULT_NUM_WINDOWS
    assert n_windows >= 2

    edge = AlchemicalEdge.create(
        mol_a, mol_b, core, ff, host_config, prefix, md_params.seed, lambda_interval, device=device
    )
    schedule = np.linspace(*edge.lambda_interval, n_windows)
    initial_states = edge.build_grid_states(schedule, min_cutoff)

    with _postmortem_on_failure(edge.tag, (initial_states, md_params)):
        result, stored_trajectories = run_sims_sequential(initial_states, md_params, edge.temperature)
        plots = make_pair_bar_plots(result, edge.temperature, edge.tag) if plots_available("plots") else None
        return SimulationResult(result, plots, stored_trajectories, md_params, [])


def estimate_relative_free_energy_bisection(
    mol_a,
    mol_b,
    core: np.ndarray,
    ff,
    host_config,
    md_params: MDParams = DEFAULT_MD_PARAMS,
    prefix: str = "",
    lambda_interval: Optional[tuple[float, float]] = None,
    n_windows: Optional[int] = None,
    min_overlap: Optional[float] = None,
    min_cutoff: Optional[float] = 0.7,
    device=None,
) -> SimulationResult:
    """Greedy overlap-driven λ placement (bisection), then pair BAR."""
    n_windows = n_windows or DEFAULT_NUM_WINDOWS
    assert n_windows >= 2

    edge = AlchemicalEdge.create(
        mol_a, mol_b, core, ff, host_config, prefix, md_params.seed, lambda_interval, device=device
    )
    edge.build_grid_states(bisection_lambda_schedule(n_windows, edge.lambda_interval), min_cutoff)

    with _postmortem_on_failure(edge.tag, (md_params,)):
        results, trajectories = run_sims_bisection(
            list(edge.lambda_interval),
            edge.optimized_state_at,
            md_params,
            n_bisections=n_windows - 2,
            temperature=edge.temperature,
            min_overlap=min_overlap,
        )
        final_result = results[-1]
        plots = make_pair_bar_plots(final_result, edge.temperature, edge.tag) if plots_available("plots") else None
        return SimulationResult(final_result, plots, trajectories, md_params, results)


def _mean_final_barostat_volume_scale(trajs: Iterable[Trajectory]) -> Optional[float]:
    scales = [traj.final_barostat_volume_scale_factor for traj in trajs]
    if any(x is not None for x in scales):
        assert all(x is not None for x in scales)
        return float(np.mean(cast(list, scales)))
    return None


def estimate_relative_free_energy_bisection_hrex(
    mol_a,
    mol_b,
    core: np.ndarray,
    ff,
    host_config,
    md_params: MDParams = DEFAULT_HREX_PARAMS,
    prefix: str = "",
    lambda_interval: Optional[tuple[float, float]] = None,
    n_windows: Optional[int] = None,
    min_overlap: Optional[float] = None,
    min_cutoff: Optional[float] = 0.7,
    device=None,
) -> HREXSimulationResult:
    """Two phases: bisection spaces the λ ladder and equilibrates each
    window, then HREX (every replica in one batched step) produces the
    final samples and the pair-BAR estimate."""
    hrex_params = md_params.hrex_params
    assert hrex_params, "hrex_params must be set to use HREX"
    n_windows = n_windows or DEFAULT_NUM_WINDOWS
    assert n_windows >= 2

    edge = AlchemicalEdge.create(
        mol_a, mol_b, core, ff, host_config, prefix, md_params.seed, lambda_interval,
        rest_params=hrex_params.rest_params, device=device,
    )
    edge.build_grid_states(bisection_lambda_schedule(n_windows, edge.lambda_interval), min_cutoff)

    with _postmortem_on_failure(edge.tag, (md_params,)):
        # phase 1: place the ladder
        results, trajectories_by_state = run_sims_bisection(
            list(edge.lambda_interval),
            edge.optimized_state_at,
            replace(md_params, n_frames=hrex_params.n_frames_bisection),
            n_bisections=n_windows - 2,
            temperature=edge.temperature,
            min_overlap=min_overlap,
        )
        assert all(traj.final_velocities is not None for traj in trajectories_by_state)

        initial_states = results[-1].initial_states
        has_barostat = [s.barostat is not None for s in initial_states]
        assert all(has_barostat) or not any(has_barostat)
        mean_scale = _mean_final_barostat_volume_scale(trajectories_by_state)
        assert (mean_scale is not None) == all(has_barostat)

        def hrex_state_at(lamb: float) -> InitialState:
            """HREX window state: the bisection's final coordinates and
            velocities, the adaptive barostat frozen at the mean final scale."""
            idx = get_nearest_state_idx(lamb, initial_states)
            nearest, traj = initial_states[idx], trajectories_by_state[idx]
            if np.isclose(nearest.lamb, lamb):
                state = nearest
            else:
                state = edge.state_at(lamb)
                # frames came from a different λ: fail fast on crazy forces, read as JAX's
                # jax.grad reads the fresh state's dense term (exact erfc)
                dev, dt = state.potentials[0].params.device, state.potentials[0].params.dtype
                x = torch.as_tensor(traj.frames[-1], device=dev, dtype=dt)
                box = torch.as_tensor(traj.boxes[-1], device=dev, dtype=dt)
                with torch.no_grad():
                    pots = minimizer.exact_modules(state.potentials, x, box)
                    minimizer.check_force_norm(minimizer.total_force(pots, x, box).cpu().numpy())
            return replace(
                state,
                x0=traj.frames[-1],
                v0=traj.final_velocities,
                box0=traj.boxes[-1],
                barostat=(
                    replace(state.barostat, adaptive_scaling_enabled=False, initial_volume_scale_factor=mean_scale)
                    if state.barostat
                    else None
                ),
            )

        # phase 2: HREX over the bisection's ladder
        if hrex_params.optimize_target_overlap is not None:
            rebalance_lambda_schedule()
        initial_states_hrex = [hrex_state_at(s.lamb) for s in initial_states]

        pair_bar_result, trajectories_by_state, hrex_diagnostics, ws_diagnostics = run_sims_hrex(
            initial_states_hrex,
            replace(md_params, n_eq_steps=0),  # bisection already equilibrated
        )
        plots = hrex_plots = None
        if plots_available("plots and hrex_plots"):
            plots = make_pair_bar_plots(pair_bar_result, edge.temperature, edge.tag)
            hrex_plots = _render_hrex_plots(hrex_diagnostics, initial_states_hrex, edge.tag)
        return HREXSimulationResult(
            pair_bar_result,
            plots,
            trajectories_by_state,
            md_params,
            results,
            hrex_diagnostics,
            hrex_plots,
            water_sampling_diagnostics=ws_diagnostics,
        )


def _render_hrex_plots(hrex_diagnostics, initial_states, tag: str) -> HREXPlots:
    from timemachine_torch.fe.plots import (
        plot_as_png_fxn,
        plot_hrex_replica_state_distribution_heatmap,
        plot_hrex_swap_acceptance_rates_convergence,
        plot_hrex_transition_matrix,
    )

    return HREXPlots(
        transition_matrix_png=plot_as_png_fxn(plot_hrex_transition_matrix, hrex_diagnostics.transition_matrix, prefix=tag),
        swap_acceptance_rates_convergence_png=plot_as_png_fxn(
            plot_hrex_swap_acceptance_rates_convergence, hrex_diagnostics.cumulative_swap_acceptance_rates, prefix=tag
        ),
        replica_state_distribution_heatmap_png=plot_as_png_fxn(
            plot_hrex_replica_state_distribution_heatmap,
            hrex_diagnostics.cumulative_replica_state_counts,
            [state.lamb for state in initial_states],
            prefix=tag,
        ),
    )


def estimate_relative_free_energy_bisection_or_hrex(*args, **kwargs) -> SimulationResult:
    """Dispatch on whether MDParams carries HREXParams."""
    if kwargs["md_params"].hrex_params is not None:
        return estimate_relative_free_energy_bisection_hrex(*args, **kwargs)
    return estimate_relative_free_energy_bisection(*args, **kwargs)


# -- leg wrappers -------------------------------------------------------------


def _strip_unsupported(md_params: MDParams, *, local_md: bool, water_sampling: bool, why: str) -> MDParams:
    if md_params is None:
        return md_params
    if local_md and md_params.local_md_params is not None:
        md_params = replace(md_params, local_md_params=None)
        warnings.warn(f"{why} don't support local steps, will use all global steps")
    if water_sampling and md_params.water_sampling_params is not None:
        md_params = replace(md_params, water_sampling_params=None)
        warnings.warn(f"{why} don't support water sampling, disabling")
    return md_params


def run_vacuum(
    mol_a,
    mol_b,
    core: np.ndarray,
    forcefield,
    _,
    md_params: MDParams = DEFAULT_HREX_PARAMS,
    n_windows: Optional[int] = None,
    min_overlap: Optional[float] = None,
    min_cutoff: Optional[float] = None,
    device=None,
):
    """The vacuum leg on `device` (None: the card)."""
    md_params = _strip_unsupported(md_params, local_md=True, water_sampling=True, why="Vacuum simulations")
    return estimate_relative_free_energy_bisection_or_hrex(
        mol_a,
        mol_b,
        core,
        forcefield,
        md_params=md_params,
        host_config=None,
        prefix="vacuum",
        n_windows=n_windows,
        min_overlap=min_overlap,
        min_cutoff=min_cutoff,
        device=device,
    )


def run_solvent(
    mol_a,
    mol_b,
    core: np.ndarray,
    forcefield,
    _,
    md_params: MDParams = DEFAULT_HREX_PARAMS,
    n_windows: Optional[int] = None,
    min_overlap: Optional[float] = None,
    min_cutoff: Optional[float] = None,
    device=None,
):
    """The solvent leg on `device` (None: the card): a 4.0 nm TIP3P box
    around both ligands plus 0.1 nm of headroom, pre-equilibrated, then
    the estimator MDParams asks for. Returns (result, host config)."""
    if md_params is not None and md_params.water_sampling_params is not None:
        md_params = replace(md_params, water_sampling_params=None)
        warnings.warn("Solvent simulations don't benefit from water sampling, disabling")
    host_config = builders.build_water_system(4.0, forcefield.water_ff, mols=[mol_a, mol_b])
    host_config.box += np.diag([0.1, 0.1, 0.1])  # headroom against clashes
    result = estimate_relative_free_energy_bisection_or_hrex(
        mol_a,
        mol_b,
        core,
        forcefield,
        host_config,
        md_params=md_params,
        prefix="solvent",
        n_windows=n_windows,
        min_overlap=min_overlap,
        min_cutoff=min_cutoff,
        device=device,
    )
    return result, host_config


def run_complex(
    mol_a,
    mol_b,
    core: np.ndarray,
    forcefield,
    protein,
    md_params: MDParams = DEFAULT_HREX_PARAMS,
    n_windows: Optional[int] = None,
    min_overlap: Optional[float] = None,
    min_cutoff: Optional[float] = 0.7,
    device=None,
):
    """The complex leg on `device` (None: the card): the protein (a PDB path
    or its text) solvated natively by md/builders.py's build_protein_system
    around both ligands plus 0.1 nm of headroom, pre-equilibrated, then the
    estimator MDParams asks for. Returns (result, host config)."""
    host_config = builders.build_protein_system(protein, forcefield.protein_ff, forcefield.water_ff, mols=[mol_a, mol_b])
    host_config.box += np.diag([0.1, 0.1, 0.1])  # headroom against clashes
    result = estimate_relative_free_energy_bisection_or_hrex(
        mol_a,
        mol_b,
        core,
        forcefield,
        host_config,
        prefix="complex",
        md_params=md_params,
        n_windows=n_windows,
        min_overlap=min_overlap,
        min_cutoff=min_cutoff,
        device=device,
    )
    return result, host_config
