"""Free-energy driver: λ-window states, sampling in one reused Context or
by HREX with every replica in one batched step, and pair BAR (counterpart
of timemachine_tpu/fe/free_energy.py: run_sims_sequential, the greedy
bisection run_sims_bisection, run_sims_hrex and what they run).

With MDParams.local_md_params every frame ends in a segment of local MD
(Context.multiple_steps_local around the ligand), and run_sims_hrex runs
the replicas one after another in one Context, as the JAX package's
time-multiplexed driver does; REST reaches the drivers through the states'
parameters (fe/rest/). With MDParams.water_sampling_params every Context
carries the TIBD water sampler (md/exchange/targeted_insertion.py) after the
barostat, and run_sims_hrex returns WaterSamplingDiagnostics. BaseFreeEnergy
and AbsoluteFreeEnergy build the absolute hydration leg's edges
(fe/absolute_hydration.py).

An InitialState holds the port's potential modules on their device. Frames
come back from the card as numpy and go to disk: a Trajectory's frames are
a StoredArrays (fe/stored_arrays.py), one .npy file a chunk in a temporary
directory under TMPDIR, as JAX's. The host term takes
JAX's get_context form (configure_all_pairs): dense on the CPU and below
4,096 atoms, the rowscan sweep on the card from there up.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, replace
from functools import cache
from typing import Callable, Iterator, Optional, Sequence
from warnings import warn

import numpy as np
import torch
import torch.distributed as dist

from timemachine_torch.constants import BOLTZ
from timemachine_torch.fe import model_utils
from timemachine_torch.fe.bar import (
    bar_with_pessimistic_uncertainty,
    df_and_err_from_u_kln,
    pair_overlap_from_ukln,
    works_from_ukln,
)
from timemachine_torch.fe.stored_arrays import StoredArrays
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.context import Context
from timemachine_torch.md.hrex import HREX, HREXDiagnostics, get_swap_attempts_per_iter_heuristic
from timemachine_torch.md.states import CoordsVelBox
from timemachine_torch.md.utils import get_bond_list, get_group_indices
from timemachine_torch.potentials import (
    HarmonicBond,
    Nonbonded,
    NonbondedAllPairs,
    NonbondedInteractionGroup,
    all_pairs_kernel,
    get_potential_by_type,
)
from timemachine_torch.utils import batches

InterpolationFxnName = str


@dataclass(frozen=True)
class RESTParams:
    """REST(2)-style effective-temperature scaling of a region: the
    intermediate states' hot region runs at up to max_temperature_scale
    (fe/rest/single_topology.py)."""

    max_temperature_scale: float
    temperature_scale_interpolation: InterpolationFxnName = "exponential"


@dataclass(frozen=True)
class HREXParams:
    """HREX's protocol: n_frames_bisection frames a bisection step, one
    frame an iteration, swaps between states at most max_delta_states apart
    scored by the banded U_kl (None: every state), an overlap target for
    the bisection, and REST's parameters (the edge's SingleTopologyREST)."""

    n_frames_bisection: int = 100
    n_frames_per_iter: int = 1
    max_delta_states: Optional[int] = 4
    optimize_target_overlap: Optional[float] = None
    rest_params: Optional[RESTParams] = None

    def __post_init__(self):
        assert self.n_frames_bisection > 0
        assert self.n_frames_per_iter == 1, "n_frames_per_iter must be 1"
        assert self.max_delta_states is None or self.max_delta_states > 0
        assert self.optimize_target_overlap is None or 0.0 < self.optimize_target_overlap < 1.0


@dataclass(frozen=True)
class WaterSamplingParams:
    """The TIBD water sampler: n_proposals exchanges every `interval`
    steps into and out of a sphere of `radius` nm about the ligand's
    centroid (batch_size is JAX's, kept for its signature)."""

    interval: int = 400
    n_proposals: int = 1000
    batch_size: int = 250
    radius: float = 1.0

    def __post_init__(self):
        assert self.interval > 0
        assert self.n_proposals > 0
        assert self.radius > 0.0
        assert 0 < self.batch_size <= self.n_proposals


@dataclass(frozen=True)
class LocalMDParams:
    """Local MD at the end of every frame: local_steps steps moving a region
    around a ligand atom, selected with stiffness k (kJ/mol/nm^4) and a
    radius drawn uniformly from [min_radius, max_radius] nm."""

    local_steps: int
    k: float = 1_000.0
    min_radius: float = 1.0
    max_radius: float = 3.0
    freeze_reference: bool = True

    def __post_init__(self):
        assert 0.1 <= self.min_radius <= self.max_radius
        assert self.local_steps > 0
        assert 1.0 <= self.k <= 1.0e6


@dataclass(frozen=True)
class MDParams:
    """Sampling protocol: n_eq_steps of equilibration, then n_frames frames
    steps_per_frame steps apart, from seed; with local_md_params each frame's
    last local_steps steps are local MD; with hrex_params, run_sims_hrex's
    protocol; with water_sampling_params, the water sampler in every
    Context."""

    n_frames: int
    n_eq_steps: int
    steps_per_frame: int
    seed: int
    local_md_params: Optional[LocalMDParams] = None
    hrex_params: Optional[HREXParams] = None
    water_sampling_params: Optional[WaterSamplingParams] = None

    def __post_init__(self):
        assert self.steps_per_frame > 0
        assert self.n_frames > 0
        assert self.n_eq_steps >= 0
        if self.local_md_params is not None:
            assert self.local_md_params.local_steps <= self.steps_per_frame


@dataclass
class InitialState:
    """Everything a window's trajectory is reproduced from, given MDParams."""

    potentials: list  # the port's potential modules, in the system's get_U_fns order
    integrator: LangevinIntegrator
    barostat: Optional[MonteCarloBarostat]
    x0: np.ndarray
    v0: np.ndarray
    box0: np.ndarray
    lamb: float
    ligand_idxs: np.ndarray
    protein_idxs: np.ndarray
    interacting_atoms: Optional[np.ndarray] = None

    def __post_init__(self):
        assert self.ligand_idxs.dtype in (np.int32, np.int64)
        assert self.protein_idxs.dtype in (np.int32, np.int64)

    def total_energy_fn(self) -> Callable:
        """U(x, box) with this state's parameters bound: the sum of every
        potential's u(x, params, box)."""
        pots = self.potentials

        def U(x, box):
            return sum(pot.u(x, pot.params, box) for pot in pots)

        return U


@dataclass
class BarResult:
    dG: float
    dG_err: float
    dG_err_by_component: np.ndarray  # (n_components,)
    overlap: float
    overlap_by_component: np.ndarray  # (n_components,)
    u_kln_by_component: np.ndarray  # (n_components, 2, 2, N)


@dataclass
class PairBarResult:
    """BAR on the L - 1 adjacent pairs of L states."""

    initial_states: list  # length L
    bar_results: list  # length L - 1

    def __post_init__(self):
        if len(self.bar_results) != len(self.initial_states) - 1:
            raise ValueError("expected one BAR result per adjacent pair of states")

    def _per_pair(self, field: str) -> list:
        return [getattr(r, field) for r in self.bar_results]

    @property
    def dGs(self) -> list:
        return self._per_pair("dG")

    @property
    def dG_errs(self) -> list:
        return self._per_pair("dG_err")

    @property
    def dG_err_by_component_by_lambda(self) -> np.ndarray:
        return np.array(self._per_pair("dG_err_by_component"))

    @property
    def overlaps(self) -> list:
        return self._per_pair("overlap")

    @property
    def overlap_by_component_by_lambda(self) -> np.ndarray:
        return np.array(self._per_pair("overlap_by_component"))

    @property
    def u_kln_by_component_by_lambda(self) -> np.ndarray:
        return np.array(self._per_pair("u_kln_by_component"))


@dataclass
class PairBarPlots:
    dG_errs_png: bytes
    overlap_summary_png: bytes
    overlap_detail_png: bytes


@dataclass
class HREXPlots:
    transition_matrix_png: bytes
    swap_acceptance_rates_convergence_png: bytes
    replica_state_distribution_heatmap_png: bytes


@dataclass
class Trajectory:
    """Frames and boxes, with the final MD state needed to continue a run."""

    frames: StoredArrays  # (frame, atom, dim)
    boxes: list  # (dim, dim) numpy arrays
    final_velocities: Optional[np.ndarray]
    final_barostat_volume_scale_factor: Optional[float] = None

    def __post_init__(self):
        if len(self.boxes) != len(self.frames):
            raise ValueError("frames and boxes must have equal length")
        if len(self.frames):
            n_atoms, n_dims = self.frames[0].shape
            assert self.boxes[0].shape == (n_dims, n_dims)
            if self.final_velocities is not None:
                assert self.final_velocities.shape == (n_atoms, n_dims)

    def extend(self, other: "Trajectory"):
        """Append other's frames; other's final state wins."""
        self.frames.extend(other.frames)
        self.boxes.extend(other.boxes)
        self.final_velocities = other.final_velocities
        self.final_barostat_volume_scale_factor = other.final_barostat_volume_scale_factor

    @classmethod
    def empty(cls) -> "Trajectory":
        return Trajectory(StoredArrays(), [], None, None)


@dataclass
class SimulationResult:
    final_result: PairBarResult
    plots: Optional[PairBarPlots]
    trajectories: list
    md_params: MDParams
    intermediate_results: list

    @property
    def frames(self) -> list[StoredArrays]:
        return [traj.frames for traj in self.trajectories]

    @property
    def boxes(self) -> list:
        return [np.array(traj.boxes) for traj in self.trajectories]

    def compute_u_kn(self) -> tuple:
        return compute_u_kn(self.trajectories, self.final_result.initial_states)


@dataclass
class WaterSamplingDiagnostics:
    """(n_iters, n_states, 2) counts of the water sampler's (accepted,
    proposed) moves of each state in each HREX iteration."""

    proposals_by_state_by_iter: np.ndarray

    def cumulative_proposals_by_state(self) -> np.ndarray:
        return np.sum(self.proposals_by_state_by_iter, axis=0)


@dataclass
class HREXSimulationResult(SimulationResult):
    hrex_diagnostics: HREXDiagnostics = None  # type: ignore[assignment]
    hrex_plots: Optional[HREXPlots] = None
    water_sampling_diagnostics: Optional[WaterSamplingDiagnostics] = None

    def extract_trajectories_by_replica(self, atom_idxs) -> np.ndarray:
        """(n_replicas, n_frames, len(atom_idxs), 3) trajectories per replica."""
        trajs_by_state = np.array([np.asarray(traj.frames)[:, atom_idxs] for traj in self.trajectories])
        replica_idx_by_iter_by_state = np.asarray(self.hrex_diagnostics.replica_idx_by_state_by_iter).T
        state_idx_by_iter_by_replica = np.argsort(replica_idx_by_iter_by_state, axis=0)
        return np.take_along_axis(trajs_by_state, state_idx_by_iter_by_replica[:, :, None, None], axis=0)

    def extract_ligand_trajectories_by_replica(self) -> np.ndarray:
        ligand_idxs = self.final_result.initial_states[0].ligand_idxs
        assert all(np.all(s.ligand_idxs == ligand_idxs) for s in self.final_result.initial_states)
        return self.extract_trajectories_by_replica(ligand_idxs)


def trajectories_by_replica_to_by_state(trajectory_by_iter_by_replica: np.ndarray, replica_idx_by_state_by_iter) -> np.ndarray:
    """(replica, iter, ...) trajectories reordered to (state, iter, ...)."""
    assert len(trajectory_by_iter_by_replica.shape) == 4
    replica_idx_by_iter_by_state = np.asarray(replica_idx_by_state_by_iter).T
    assert replica_idx_by_iter_by_state.shape == trajectory_by_iter_by_replica.shape[:2]
    return np.take_along_axis(trajectory_by_iter_by_replica, replica_idx_by_iter_by_state[:, :, None, None], axis=0)


def image_frames(initial_state: InitialState, frames, boxes) -> np.ndarray:
    """Frames imaged into the periodic box, each molecule whole, with the
    ligand's centroid at the box's center (for viewing)."""
    assert np.array(boxes).shape[1:] == (3, 3), "Boxes are not 3x3"
    assert len(frames) == len(boxes), "Number of frames and boxes don't match"
    hb = get_potential_by_type(initial_state.potentials, HarmonicBond)
    group_indices = get_group_indices(get_bond_list(hb), len(initial_state.integrator.masses))

    def image_one(frame, box):
        assert frame.ndim == 2 and frame.shape[-1] == 3, "frames must have shape (N, 3)"
        shift = np.mean(frame[initial_state.ligand_idxs], axis=0) + np.diagonal(box) / 2
        return model_utils.image_frame(group_indices, frame - shift, box)

    return np.array([image_one(np.asarray(frame), np.asarray(box)) for frame, box in zip(frames, boxes)])


class BaseFreeEnergy:
    """(JAX free_energy.py:418-437)"""

    @staticmethod
    def _get_system_params_and_potentials(ff_params, topology, lamb: float):
        params_potential_pairs = [
            topology.parameterize_harmonic_bond(ff_params.hb_params),
            topology.parameterize_harmonic_angle(ff_params.ha_params),
            topology.parameterize_proper_torsion(ff_params.pt_params),
            topology.parameterize_improper_torsion(ff_params.it_params),
            topology.parameterize_nonbonded(
                ff_params.q_params, ff_params.q_params_intra, ff_params.lj_params, ff_params.lj_params_intra, lamb
            ),
        ]
        params, potentials = zip(*params_potential_pairs)
        return params, potentials


class AbsoluteFreeEnergy(BaseFreeEnergy):
    """Absolute free energy of a molecule by 4D decoupling (JAX
    free_energy.py:440-559). The edges are the builders' terms
    (fe/terms.py), which convert.modules_from_bound_potentials places on a
    device."""

    def __init__(self, mol, top):
        self.mol = mol
        self.top = top

    def prepare_host_edge(self, ff, host_config, lamb: float):
        """(potentials, params, combined masses) of the host with the
        molecule appended at λ: bond, angle, proper, improper, then
        HostGuestTopology's nonbonded SummedPotential flattened into the
        host's all-pairs term under the atom subset, the molecule's
        interaction group (w = λ cutoff) and its intramolecular pair list."""
        from timemachine_torch.fe.terms import SummedPotential
        from timemachine_torch.fe.topology import HostGuestTopology
        from timemachine_torch.fe.utils import get_mol_masses

        hgt = HostGuestTopology(
            host_config.host_system.get_U_fns(), self.top, host_config.num_water_atoms, ff, host_config.host_topology
        )
        final_params, final_potentials = [], []
        for params, pot in zip(*self._get_system_params_and_potentials(ff.get_params(), hgt, lamb)):
            if isinstance(pot, SummedPotential):
                for partial_params, sub_pot in zip(pot.params_init, pot.potentials):
                    assert not isinstance(sub_pot, SummedPotential), "nested SummedPotential"
                    final_params.append(partial_params)
                    final_potentials.append(sub_pot)
            else:
                final_params.append(params)
                final_potentials.append(pot)
        combined_masses = self._combine(get_mol_masses(self.mol), np.array(host_config.masses))
        return tuple(final_potentials), tuple(final_params), combined_masses

    def prepare_vacuum_edge(self, ff):
        """(potentials, params, masses) of the molecule alone at λ = 0."""
        from timemachine_torch.fe.utils import get_mol_masses

        final_params, final_potentials = self._get_system_params_and_potentials(ff.get_params(), self.top, 0.0)
        return final_potentials, final_params, get_mol_masses(self.mol)

    def prepare_combined_coords(self, host_coords=None):
        from timemachine_torch.fe.utils import get_romol_conf

        return self._combine(get_romol_conf(self.mol), host_coords)

    def _combine(self, ligand_values, host_values=None):
        if host_values is None:
            return ligand_values
        return np.concatenate([host_values, ligand_values])


def assert_deep_eq(obj1, obj2, custom_assertion=lambda path, x1, x2: False):
    """obj1 and obj2 equal through dataclasses, lists and tuples, arrays and
    tensors compared elementwise; an AssertionError names the first path at
    which they differ. custom_assertion(path, x1, x2) returning True
    accepts a node as it is."""
    import dataclasses

    def is_dataclass_instance(obj):
        return dataclasses.is_dataclass(obj) and not isinstance(obj, type)

    def as_numpy(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def go(x1, x2, path=("$",)):
        if custom_assertion(path, x1, x2):
            pass
        elif is_dataclass_instance(x1) and is_dataclass_instance(x2):
            assert type(x1) is type(x2), f"types differ at {path}"
            for f in dataclasses.fields(x1):
                go(getattr(x1, f.name), getattr(x2, f.name), (*path, f.name))
        elif isinstance(x1, (np.ndarray, torch.Tensor)) or isinstance(x2, (np.ndarray, torch.Tensor)):
            assert np.array_equal(as_numpy(x1), as_numpy(x2)), f"arrays differ at {path}"
        elif isinstance(x1, (list, tuple)) and isinstance(x2, (list, tuple)):
            assert len(x1) == len(x2), f"lengths differ at {path}"
            for i, (y1, y2) in enumerate(zip(x1, x2)):
                go(y1, y2, (*path, i))
        else:
            assert x1 == x2, f"values differ at {path}: {x1} != {x2}"

    go(obj1, obj2)


def _buffers(pot) -> dict:
    return {k: v for k, v in pot.named_buffers() if k != "params"}


def assert_potentials_compatible(pots1: Sequence, pots2: Sequence):
    """Two states' potentials differ only in their parameters: the same
    types, index buffers and scalars (the contract of a reused Context)."""
    assert len(pots1) == len(pots2)
    for p1, p2 in zip(pots1, pots2):
        assert type(p1) is type(p2)
        b1, b2 = _buffers(p1), _buffers(p2)
        assert b1.keys() == b2.keys(), type(p1).__name__
        for k in b1:
            assert b1[k].shape == b2[k].shape and torch.equal(b1[k].cpu(), b2[k].cpu()), f"{type(p1).__name__}.{k}"
        for attr in ("num_atoms", "beta", "cutoff"):
            assert getattr(p1, attr, None) == getattr(p2, attr, None), f"{type(p1).__name__}.{attr}"
        assert p1.params.shape == p2.params.shape


def get_water_sampler_params(initial_state: InitialState) -> np.ndarray:
    """Nonbonded parameters of the whole system as a water sampler sees
    them: the ligand's from the interaction group, the host's from the
    host term when there is a host."""
    ixn = get_potential_by_type(initial_state.potentials, NonbondedInteractionGroup)
    params = ixn.params.cpu().numpy().copy()
    if initial_state.barostat is not None:
        host_idxs = np.delete(np.arange(initial_state.x0.shape[0]), initial_state.ligand_idxs)
        water_idxs = np.delete(host_idxs, initial_state.protein_idxs)
        host_params = get_potential_by_type(initial_state.potentials, Nonbonded).params.cpu().numpy()
        assert (host_params[water_idxs] == params[water_idxs]).all()
        params[host_idxs] = host_params[host_idxs]
    assert params.shape[1] == 4
    return params


def assert_ensembles_compatible(state_a: InitialState, state_b: InitialState):
    """Swapping x, v and box between a and b must be valid."""
    intg_a, intg_b = state_a.integrator, state_b.integrator
    assert (np.asarray(intg_a.masses) == np.asarray(intg_b.masses)).all()
    assert intg_a.temperature == intg_b.temperature
    assert (state_a.barostat is None) == (state_b.barostat is None), "should both be NVT or both be NPT"
    if state_a.barostat and state_b.barostat:
        baro_a, baro_b = state_a.barostat, state_b.barostat
        assert baro_a.pressure == baro_b.pressure
        assert baro_a.temperature == baro_b.temperature
        assert intg_a.temperature == baro_a.temperature
        assert (state_a.ligand_idxs == state_b.ligand_idxs).all()
        non_ligand = np.delete(np.arange(state_a.x0.shape[0]), state_a.ligand_idxs)
        assert (get_water_sampler_params(state_a)[non_ligand] == get_water_sampler_params(state_b)[non_ligand]).all()
    else:
        assert (state_a.box0 == state_b.box0).all()


def configure_all_pairs(initial_state: InitialState):
    """Give every all-pairs term of the state not yet configured the form
    of JAX's get_context (free_energy.py:477-489): dense on the CPU and
    below 4,096 atoms, else the rowscan sweep (potentials.all_pairs_kernel,
    site "context"), sized from the state's geometry. In place, as JAX's
    configure_pallas: it selects a kernel, not the physics, and the sites
    that read the state's terms afterwards (pair BAR, bisection's u_kln,
    MBAR) read this form, as JAX's do."""
    for pot in initial_state.potentials:
        if isinstance(pot, NonbondedAllPairs) and pot.kernel is None:
            dev, dt = pot.params.device, pot.params.dtype
            box = torch.as_tensor(initial_state.box0, device=dev, dtype=dt)
            kernel = all_pairs_kernel("context", pot.num_atoms, dev)
            pot.configure(box, torch.as_tensor(initial_state.x0, device=dev, dtype=dt), kernel=kernel)


def get_water_idxs(group_idxs: Sequence[np.ndarray], ligand_idxs: Optional[np.ndarray] = None) -> list:
    """The groups of exactly three atoms that share no atom with the
    ligand: the waters. (md/exchange/exchange_mover.py get_water_idxs drops
    only a group equal to the ligand's atoms; both are JAX's.)"""
    ligand_set = set(np.asarray(ligand_idxs).tolist()) if ligand_idxs is not None else set()
    return [g for g in group_idxs if len(g) == 3 and not (set(g.tolist()) & ligand_set)]


def make_water_sampler(initial_state: InitialState, water_sampling_params: WaterSamplingParams):
    """The state's TIBD water sampler, as JAX's get_context builds it: the
    waters are the bond graph's three-atom groups off the ligand, the
    parameters get_water_sampler_params', beta and cutoff the interaction
    group's, the seed the first int32 of default_rng(the integrator's seed)."""
    from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove, water_sampler_seed
    from timemachine_torch.md.utils import get_group_indices
    from timemachine_torch.potentials import HarmonicBond

    bonds = get_potential_by_type(initial_state.potentials, HarmonicBond).idxs.cpu().numpy()
    groups = get_group_indices(bonds.tolist(), len(initial_state.integrator.masses))
    ixn = get_potential_by_type(initial_state.potentials, NonbondedInteractionGroup)
    wsp = water_sampling_params
    return TIBDExchangeMove(
        n_atoms=initial_state.x0.shape[0],
        ligand_idxs=np.asarray(initial_state.ligand_idxs),
        water_idxs=get_water_idxs(groups, ligand_idxs=initial_state.ligand_idxs),
        params=get_water_sampler_params(initial_state),
        temperature=initial_state.integrator.temperature,
        beta=ixn.beta,
        cutoff=ixn.cutoff,
        radius=wsp.radius,
        seed=water_sampler_seed(initial_state.integrator.seed),
        n_proposals=wsp.n_proposals,
        interval=wsp.interval,
        batch_size=wsp.batch_size,
    )


def get_context(initial_state: InitialState, md_params: Optional[MDParams] = None) -> Context:
    """A Context over copies of the state's potentials, so that set_params
    and reset_for_state leave the state as it is, after
    configure_all_pairs; its movers the state's barostat, then, with
    md_params.water_sampling_params, the water sampler. The Context's
    device and dtype are the potentials': a state loaded on the card (the
    loaders' default) runs there."""
    configure_all_pairs(initial_state)
    params = initial_state.potentials[0].params
    movers = [initial_state.barostat] if initial_state.barostat is not None else []
    if md_params is not None and md_params.water_sampling_params is not None:
        movers.append(make_water_sampler(initial_state, md_params.water_sampling_params))
    return Context(
        torch.as_tensor(initial_state.x0, dtype=params.dtype),
        initial_state.v0,
        initial_state.box0,
        initial_state.integrator,
        [copy.deepcopy(pot) for pot in initial_state.potentials],
        movers=movers,
        device=params.device,
    )


def sample_with_context_iter(
    ctxt: Context, md_params: MDParams, temperature: float, ligand_idxs: np.ndarray, batch_size: int
) -> Iterator[tuple]:
    """Equilibrate (the barostat every 15 steps, then its own interval
    again), then yield (frames, boxes, final velocities) up to batch_size
    frames at a time. With local_md_params a frame is steps_per_frame -
    local_steps global steps, then local_steps of local MD around a ligand
    atom, each segment's radius and seed drawn from
    default_rng(md_params.seed) in the JAX package's order."""
    if md_params.n_eq_steps:
        original = ctxt.set_barostat_interval(15)
        ctxt.multiple_steps(n_steps=md_params.n_eq_steps, store_x_interval=0)
        if original is not None:
            ctxt.set_barostat_interval(original)
    assert np.all(np.isfinite(ctxt.get_x_t())), "Equilibration resulted in a nan"

    local = md_params.local_md_params
    rng = np.random.default_rng(md_params.seed)

    def local_frame():
        if md_params.steps_per_frame > local.local_steps:
            ctxt.multiple_steps(n_steps=md_params.steps_per_frame - local.local_steps)
        return ctxt.multiple_steps_local(
            local.local_steps,
            np.asarray(ligand_idxs, dtype=np.int32),
            k=local.k,
            radius=float(rng.uniform(local.min_radius, local.max_radius)),
            seed=int(rng.integers(np.iinfo(np.int32).max)),
            temperature=temperature,
            freeze_reference=local.freeze_reference,
        )

    for n_frames in batches(md_params.n_frames, batch_size):
        if local is None:
            coords, boxes = ctxt.multiple_steps(
                n_steps=n_frames * md_params.steps_per_frame, store_x_interval=md_params.steps_per_frame
            )
        else:
            coords, boxes = (np.concatenate(a) for a in zip(*[local_frame() for _ in range(n_frames)]))
        yield coords, boxes, ctxt.get_v_t()


def sample_with_context(
    ctxt: Context, md_params: MDParams, temperature: float, ligand_idxs: np.ndarray, max_buffer_frames: int
) -> Trajectory:
    frames, boxes, final_velocities = StoredArrays(), [], None
    for batch_coords, batch_boxes, final_velocities in sample_with_context_iter(
        ctxt, md_params, temperature, ligand_idxs, max_buffer_frames
    ):
        frames.extend(batch_coords)
        boxes.extend(batch_boxes)
    assert len(frames) == md_params.n_frames and len(boxes) == md_params.n_frames
    assert np.all(np.isfinite(frames[-1])), "Production resulted in a nan"
    barostat = ctxt.get_barostat()
    final_scale = float(barostat[1].volume_scale) if barostat is not None else None
    return Trajectory(frames, boxes, final_velocities, final_scale)


def sample(initial_state: InitialState, md_params: MDParams, max_buffer_frames: int) -> Trajectory:
    """One window in a Context of its own, on its potentials' device."""
    ctxt = get_context(initial_state, md_params)
    return sample_with_context(
        ctxt, md_params, initial_state.integrator.temperature, initial_state.ligand_idxs, max_buffer_frames
    )


class IndeterminateEnergyWarning(UserWarning):
    pass


class MinOverlapWarning(UserWarning):
    pass


def make_pair_bar_plots(res: PairBarResult, temperature: float, prefix: str) -> PairBarPlots:
    """The pair-BAR figures of a result as PNG bytes (matplotlib must import)."""
    from timemachine_torch.fe import plots

    U_names = [type(p).__name__ for p in res.initial_states[0].potentials]
    lambdas = [s.lamb for s in res.initial_states]
    overlap_detail_png = plots.plot_as_png_fxn(
        plots.plot_overlap_detail_figure, U_names, res.dGs, res.dG_errs, res.u_kln_by_component_by_lambda, temperature,
        prefix,
    )
    dG_errs_png = plots.plot_as_png_fxn(
        plots.plot_dG_errs_figure, U_names, lambdas, res.dG_errs, res.dG_err_by_component_by_lambda
    )
    overlap_summary_png = plots.plot_as_png_fxn(
        plots.plot_overlap_summary_figure, U_names, lambdas, res.overlaps, res.overlap_by_component_by_lambda
    )
    return PairBarPlots(dG_errs_png, overlap_summary_png, overlap_detail_png)


def estimate_free_energy_bar(u_kln_by_component: np.ndarray, temperature: float) -> BarResult:
    """Pair BAR with the error split by component; NaN energies become +inf."""
    if np.any(np.isnan(u_kln_by_component)):
        warn(
            "Encountered NaNs in u_kln matrix. Replacing each instance with inf prior to MBAR calculation",
            IndeterminateEnergyWarning,
        )
        u_kln_by_component = np.where(np.isnan(u_kln_by_component), np.inf, u_kln_by_component)

    kBT = BOLTZ * temperature
    u_kln = u_kln_by_component.sum(0)
    df, df_err = bar_with_pessimistic_uncertainty(u_kln)

    def component_err(comp) -> float:
        # a component whose forward and reverse works are all zero does not
        # depend on λ: its error is 0 by convention
        w_fwd, w_rev = works_from_ukln(comp)
        if np.all(np.isclose(w_fwd, 0.0)) and np.all(np.isclose(w_rev, 0.0)):
            return 0.0
        return df_and_err_from_u_kln(comp)[1] * kBT

    return BarResult(
        dG=df * kBT,
        dG_err=df_err * kBT,
        dG_err_by_component=np.array([component_err(comp) for comp in u_kln_by_component]),
        overlap=pair_overlap_from_ukln(u_kln),
        overlap_by_component=np.array([pair_overlap_from_ukln(comp) for comp in u_kln_by_component]),
        u_kln_by_component=u_kln_by_component,
    )


def generate_pair_bar_ulkns(
    initial_states: Sequence[InitialState], samples_by_state: Sequence[Trajectory], temperature: float
) -> np.ndarray:
    """(n_states - 1, n_components, 2, 2, n_frames) reduced energies: each
    state's frames under its own and its neighbours' parameters, per
    potential, through the first state's modules on their device."""
    assert len(initial_states) > 0
    assert len(initial_states) == len(samples_by_state)
    configure_all_pairs(initial_states[0])
    pots = initial_states[0].potentials
    n_comp = len(pots)
    kBT = temperature * BOLTZ
    n_states = len(initial_states)
    energies = {}
    with torch.no_grad():
        for i in range(n_states):
            dev, dt = pots[0].params.device, pots[0].params.dtype
            frames = torch.as_tensor(np.asarray(samples_by_state[i].frames), device=dev, dtype=dt)
            boxes = torch.as_tensor(np.asarray(samples_by_state[i].boxes), device=dev, dtype=dt)
            for p_idx in (idx for idx in (i - 1, i, i + 1) if 0 <= idx < n_states):
                for j, pot in enumerate(pots):
                    params = initial_states[p_idx].potentials[j].params
                    us = torch.stack([pot.u(x, params, b) for x, b in zip(frames, boxes)])
                    energies[i, p_idx, j] = us.cpu().numpy().astype(np.float64) / kBT

    n_frames = len(samples_by_state[0].frames)
    out = np.empty((n_states - 1, n_comp, 2, 2, n_frames))
    for i in range(n_states - 1):
        states = (i, i + 1)
        for j in range(n_comp):
            for l in range(2):
                for k in range(2):
                    out[i, j, k, l] = energies[states[k], states[l], j]
    return out


def run_sims_sequential(
    initial_states: Sequence[InitialState], md_params: MDParams, temperature: float
) -> tuple[PairBarResult, list]:
    """Sample every state in one Context on the states' device, reset
    between windows, then BAR on each adjacent pair."""
    for s in initial_states[1:]:
        assert_potentials_compatible(initial_states[0].potentials, s.potentials)
    ctxt = get_context(initial_states[0], md_params)
    trajectories = []
    for initial_state in initial_states:
        ctxt.reset_for_state(initial_state)
        trajectories.append(
            sample_with_context(
                ctxt, md_params, initial_state.integrator.temperature, initial_state.ligand_idxs, max_buffer_frames=100
            )
        )
    neighbor_ulkns = generate_pair_bar_ulkns(initial_states, trajectories, temperature)
    pair_bar_results = [estimate_free_energy_bar(u, temperature) for u in neighbor_ulkns]
    return PairBarResult(list(initial_states), pair_bar_results), trajectories


def run_sims_bisection(
    initial_lambdas: Sequence[float],
    make_initial_state: Callable[[float], InitialState],
    md_params: MDParams,
    n_bisections: int,
    temperature: float,
    min_overlap: Optional[float] = None,
    verbose: bool = True,
) -> tuple[list, list]:
    """Greedy bisection of the λ interval: sample the states of
    initial_lambdas, then n_bisections times split the adjacent pair of the
    lowest BAR overlap at its midpoint and sample the new state, stopping
    early once every overlap exceeds min_overlap (ref free_energy.py:1006-1146).
    Every state is sampled in one reused Context, reset between states.
    Returns (a PairBarResult per iteration, the final schedule's
    trajectories)."""
    from timemachine_torch.fe.energy_decomposition import (
        EnergyDecomposedState,
        compute_energy_decomposed_u_kln,
        get_batch_u_fns,
    )
    from timemachine_torch.fe.protocol_refinement import greedy_bisection_step

    assert len(initial_lambdas) >= 2
    assert np.all(np.diff(initial_lambdas) > 0), "initial lambda schedule must be monotonically increasing"

    lambdas = list(initial_lambdas)
    get_initial_state = cache(make_initial_state)
    contexts: list = []  # the one Context, made for the first state sampled

    @cache
    def get_samples(lamb: float) -> Trajectory:
        initial_state = get_initial_state(lamb)
        if not contexts:
            contexts.append(get_context(initial_state, md_params))
        ctxt = contexts[0]
        ctxt.reset_for_state(initial_state)
        return sample_with_context(
            ctxt, md_params, initial_state.integrator.temperature, initial_state.ligand_idxs, max_buffer_frames=100
        )

    state_0 = get_initial_state(lambdas[0])
    configure_all_pairs(state_0)
    pots = state_0.potentials

    def get_state(lamb: float):
        initial_state = get_initial_state(lamb)
        assert_potentials_compatible(initial_state.potentials, pots)
        traj = get_samples(lamb)
        batch_u_fns = get_batch_u_fns(pots, [p.params for p in initial_state.potentials], temperature)
        return EnergyDecomposedState(traj.frames, traj.boxes, batch_u_fns)

    @cache
    def get_bar_result(lamb1: float, lamb2: float) -> BarResult:
        u_kln_by_component = compute_energy_decomposed_u_kln([get_state(lamb1), get_state(lamb2)])
        return estimate_free_energy_bar(u_kln_by_component, temperature)

    # the greedy step splits the pair with the highest cost = -log(overlap)
    def cost_fn(lamb1: float, lamb2: float) -> float:
        overlap = get_bar_result(lamb1, lamb2).overlap
        return -np.log(overlap) if overlap != 0.0 else float("inf")

    def schedule_result(schedule: Sequence[float]) -> PairBarResult:
        return PairBarResult(
            [get_initial_state(lamb) for lamb in schedule],
            [get_bar_result(l1, l2) for l1, l2 in zip(schedule, schedule[1:])],
        )

    def narrate(schedule, iteration, costs, left_idx, lamb_new):
        lo, hi = schedule[left_idx], schedule[left_idx + 1]
        threshold = f" <= {min_overlap:.3g} " if min_overlap is not None else " (min_overlap == None) "
        print(
            f"Bisection iteration {iteration} (of {n_bisections}): "
            f"Current minimum BAR overlap {np.exp(-max(costs)):.3g}{threshold}"
            f"between states at λ={lo:.3g} and λ={hi:.3g}. Sampling new state at λ={lamb_new:.3g}…"
        )

    results = [schedule_result(lambdas)]
    converged = False
    for iteration in range(n_bisections):
        if min_overlap is not None and min(results[-1].overlaps) > min_overlap:
            converged = True
            if verbose:
                print(f"All BAR overlaps exceed min_overlap={min_overlap}. Returning after {iteration} iterations.")
            break

        prev_schedule = lambdas
        lambdas, info = greedy_bisection_step(lambdas, cost_fn, lambda a, b: (a + b) / 2.0)
        if verbose:
            narrate(prev_schedule, iteration, *info)
        results.append(schedule_result(lambdas))

    if not converged and min_overlap is not None and min(results[-1].overlaps) < min_overlap:
        warn(
            f"Reached n_bisections={n_bisections} iterations without achieving min_overlap={min_overlap}. "
            f"The minimum BAR overlap was {np.min(results[-1].overlaps)}.",
            MinOverlapWarning,
        )

    trajectories = [get_samples(lamb) for lamb in lambdas]
    return results, trajectories


def _state_energies(pots, params, frames, boxes) -> np.ndarray:
    """(n_frames,) f64 total energy of frames under one state's parameters
    (one per potential), through the modules `pots` on their device."""
    dev, dt = pots[0].params.device, pots[0].params.dtype
    xs = torch.as_tensor(np.asarray(frames), device=dev, dtype=dt)
    bs = torch.as_tensor(np.asarray(boxes), device=dev, dtype=dt)
    with torch.no_grad():
        us = [sum(pot.u(x, p, b) for pot, p in zip(pots, params)) for x, b in zip(xs, bs)]
    return torch.stack(us).cpu().numpy().astype(np.float64)


def make_u_kl_fxn(trajs: Sequence[Trajectory], initial_states: Sequence[InitialState]) -> Callable:
    """fxn(k, l): the reduced energies of trajs[k]'s frames in state l's
    ensemble, NaN -> +inf, through the first state's modules."""
    kBTs = [BOLTZ * state.integrator.temperature for state in initial_states]
    assert len(set(kBTs)) == 1
    s_0 = initial_states[0]
    for s in initial_states[1:]:
        assert_ensembles_compatible(s_0, s)
        assert_potentials_compatible(s_0.potentials, s.potentials)
    configure_all_pairs(s_0)

    def u_kl(k: int, l: int) -> np.ndarray:
        params = [pot.params for pot in initial_states[l].potentials]
        us = _state_energies(s_0.potentials, params, trajs[k].frames, trajs[k].boxes)
        return np.nan_to_num(us, nan=+np.inf) / kBTs[l]

    return u_kl


def compute_u_kn(trajs: Sequence[Trajectory], initial_states: Sequence[InitialState]) -> tuple:
    """MBAR's input (u_kn, N_k) over all states."""
    from timemachine_torch.fe.mbar import kln_to_kn

    u_kl = make_u_kl_fxn(trajs, initial_states)
    N_k = [len(traj.frames) for traj in trajs]
    K = len(N_k)
    assert len(initial_states) == K
    u_kln = np.nan * np.zeros((K, K, max(N_k)))
    for k in range(K):
        for l in range(K):
            u_kln[k, l, : N_k[k]] = u_kl(k, l)
    return kln_to_kn(u_kln, np.array(N_k)), np.array(N_k)


def compute_potential_matrix(
    potential: Callable, hrex: HREX, params_by_state: Sequence, max_delta_states: Optional[int] = None
) -> np.ndarray:
    """(n_replicas, n_states) energies potential(x_r, params_by_state[l],
    box_r) of each replica (a CoordsVelBox) under each state's parameters,
    +inf for states more than max_delta_states from the replica's own; one
    call a (replica, state) pair (the plain form of the replica-exchange
    runner's banded energies)."""
    n_states = len(hrex.replicas)
    state_idx = np.argsort(hrex.replica_idx_by_state)
    k = n_states if max_delta_states is None else max_delta_states
    U_kl = np.full((n_states, n_states), np.inf)
    with torch.no_grad():
        for r, replica in enumerate(hrex.replicas):
            for l in range(max(0, state_idx[r] - k), min(n_states, state_idx[r] + k + 1)):
                U_kl[r, l] = float(potential(replica.coords, params_by_state[l], replica.box))
    return U_kl


def verify_and_sanitize_potential_matrix(U_kl: np.ndarray, replica_idx_by_state, abs_energy_threshold: float = 1e9) -> np.ndarray:
    """Check that every replica's energy at its own state is finite and
    below abs_energy_threshold in magnitude; NaN -> +inf, with a warning."""
    replica_energies = np.diagonal(U_kl[np.asarray(replica_idx_by_state)])
    assert np.all(np.isfinite(replica_energies)), "Replicas have non-finite energies"
    assert np.all(np.abs(replica_energies) < abs_energy_threshold), "Energies larger in magnitude than tolerated"
    if np.any(np.isnan(U_kl)):
        warn("Encountered NaNs in potential matrix. Replacing each instance with inf", IndeterminateEnergyWarning)
        U_kl = np.where(np.isnan(U_kl), np.inf, U_kl)
    return U_kl


def run_sims_hrex(
    initial_states: Sequence[InitialState],
    md_params: MDParams,
    n_swap_attempts_per_iter: Optional[int] = None,
    print_diagnostics_interval: Optional[int] = 10,
) -> tuple:
    """Nearest-neighbor HREX over a ladder of states on one card: every
    iteration advances all K replicas' segments in one batched step
    (parallel/replica_exchange.py), computes the banded U_kl on the card
    and runs the swap batch on the host. Where a process group is
    initialized, the replicas are sharded over gcd(K, world size) of its
    ranks (a replica mesh, as JAX shards over gcd(K, devices)); every rank
    returns the result, the ranks outside the shards by broadcast. With local MD the replicas run one
    after another in one Context (_run_sims_hrex_time_multiplexed). With
    water sampling each replica's sampler takes its state's parameters
    every iteration. Returns (PairBarResult, trajectories by state,
    HREXDiagnostics, WaterSamplingDiagnostics or None without water
    sampling): the sampler's counts of each iteration's segment by state,
    equilibration left out."""
    from timemachine_torch.md.barostat import MonteCarloBarostat
    from timemachine_torch.parallel.mesh import make_mesh
    from timemachine_torch.parallel.replica_exchange import ReplicaExchangeRunner

    assert md_params.hrex_params is not None
    for s in initial_states[1:]:
        assert_ensembles_compatible(initial_states[0], s)
        assert_potentials_compatible(initial_states[0].potentials, s.potentials)
    if md_params.local_md_params is not None:
        return _run_sims_hrex_time_multiplexed(initial_states, md_params, n_swap_attempts_per_iter, print_diagnostics_interval)

    n_states = len(initial_states)
    if n_swap_attempts_per_iter is None:
        n_swap_attempts_per_iter = get_swap_attempts_per_iter_heuristic(n_states)
    context = get_context(initial_states[0], md_params=md_params)
    temperature = initial_states[0].integrator.temperature

    state_idxs = list(range(n_states))
    neighbor_pairs = list(zip(state_idxs, state_idxs[1:]))
    strip_identity_pair = False
    if n_states == 2:
        # an identity move keeps the two-state chain aperiodic
        neighbor_pairs = [(0, 0), *neighbor_pairs]
        strip_identity_pair = True

    # shard the replica axis over as many ranks of a process group as divide K
    n_shards = math.gcd(n_states, dist.get_world_size()) if dist.is_initialized() else 1
    mesh = make_mesh(context.device, "replica", ranks=range(n_shards)) if n_shards > 1 else None
    if dist.is_initialized() and dist.get_rank() >= n_shards:
        return _broadcast_result(None)

    runner = ReplicaExchangeRunner(
        context,
        [[pot.params for pot in s.potentials] for s in initial_states],
        temperature=temperature,
        neighbor_pairs=neighbor_pairs,
        n_swap_attempts_per_iter=n_swap_attempts_per_iter,
        max_delta_states=md_params.hrex_params.max_delta_states,
        seed=md_params.seed,
        water_params_by_state=_water_params_by_state(initial_states, md_params),
        mesh=mesh,
    )
    runner.initialize([s.x0 for s in initial_states], [s.v0 for s in initial_states], [s.box0 for s in initial_states])
    runner.equilibrate(md_params.n_eq_steps)
    barostat_idx = [i for i, m in enumerate(context.movers) if isinstance(m, MonteCarloBarostat)]

    samples_by_state = [Trajectory.empty() for _ in initial_states]
    replica_idx_by_state_by_iter: list = []
    fraction_accepted_by_pair_by_iter: list = []
    water_counts_by_state_by_iter: list = []
    begin_loop_time = last_update_time = time.perf_counter()

    for current_frame in range(md_params.n_frames):
        counters_before = runner.water_counters_by_replica()
        res = runner.advance_frame(md_params.steps_per_frame)
        perm = res.replica_idx_by_state
        if counters_before is not None:
            counts = np.stack(runner.water_counters_by_replica(), -1) - np.stack(counters_before, -1)
            water_counts_by_state_by_iter.append([tuple(int(c) for c in counts[perm[s]]) for s in range(n_states)])
        for s, samples in enumerate(samples_by_state):
            samples.frames.extend(res.frames_by_state[s][None])
            samples.boxes.append(res.boxes_by_state[s])
        pair_stats = list(zip(res.accepted_by_pair.tolist(), res.proposed_by_pair.tolist()))
        if strip_identity_pair:
            pair_stats = pair_stats[1:]
        replica_idx_by_state_by_iter.append(perm.tolist())
        fraction_accepted_by_pair_by_iter.append(pair_stats)

        if print_diagnostics_interval and (current_frame + 1) % print_diagnostics_interval == 0:
            current_time = time.perf_counter()
            _print_hrex_progress(
                current_frame, md_params.n_frames, begin_loop_time, last_update_time, print_diagnostics_interval,
                pair_stats, fraction_accepted_by_pair_by_iter, perm,
            )
            last_update_time = current_time

    final_x, final_v, final_boxes = runner.final_state_arrays()
    final_scales = runner.mover_state_field_by_state(barostat_idx[0], "volume_scale") if barostat_idx else None
    for s, samples in enumerate(samples_by_state):
        samples.final_velocities = final_v[s]
        samples.final_barostat_volume_scale_factor = float(final_scales[s]) if final_scales is not None else None

    neighbor_ulkns_by_component = generate_pair_bar_ulkns(initial_states, samples_by_state, temperature)
    pair_bar_results = [estimate_free_energy_bar(u, temperature) for u in neighbor_ulkns_by_component]
    diagnostics = HREXDiagnostics(replica_idx_by_state_by_iter, fraction_accepted_by_pair_by_iter)
    result = (PairBarResult(list(initial_states), pair_bar_results), samples_by_state, diagnostics,
              _water_diagnostics(md_params, water_counts_by_state_by_iter))
    return _broadcast_result(result) if dist.is_initialized() and n_shards < dist.get_world_size() else result


def _broadcast_result(result):
    """run_sims_hrex's result from rank 0 on every rank of the default
    process group (the ranks outside its shards ran nothing)."""
    box = [result]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _water_params_by_state(initial_states: Sequence[InitialState], md_params: MDParams) -> Optional[list]:
    """Each state's water sampler parameters, or None without water sampling."""
    if md_params.water_sampling_params is None:
        return None
    return [get_water_sampler_params(s) for s in initial_states]


def _water_diagnostics(md_params: MDParams, counts_by_state_by_iter: list) -> Optional[WaterSamplingDiagnostics]:
    if md_params.water_sampling_params is None:
        return None
    return WaterSamplingDiagnostics(np.array(counts_by_state_by_iter))


def _run_sims_hrex_time_multiplexed(
    initial_states: Sequence[InitialState],
    md_params: MDParams,
    n_swap_attempts_per_iter: Optional[int] = None,
    print_diagnostics_interval: Optional[int] = 10,
) -> tuple:
    """HREX one replica at a time, for segments that end in local MD (the
    JAX package's _run_sims_hrex_time_multiplexed): one Context takes each
    replica's x, v, box and its state's parameters in turn and samples one
    frame with sample_with_context_iter, seeded seed + state * n_frames +
    frame (n_eq_steps at frame 0 only), the water sampler (if any) given
    its state's parameters, its counts taken around the segment; then the
    banded U_kl of the summed potential (compute_potential_matrix) and the
    swap batch seeded seed + frame + 1, the identity pair added at K = 2.
    The Langevin noise and the sampler's draws are the Context's
    generators, carried from segment to segment."""
    from timemachine_torch.fe.terms import make_summed_potential  # terms imports this module through convert

    assert md_params.hrex_params is not None
    if n_swap_attempts_per_iter is None:
        n_swap_attempts_per_iter = get_swap_attempts_per_iter_heuristic(len(initial_states))

    context = get_context(initial_states[0], md_params=md_params)
    temperature = initial_states[0].integrator.temperature
    ligand_idxs = initial_states[0].ligand_idxs
    summed = make_summed_potential(initial_states[0].potentials)
    params_by_state = [make_summed_potential(s.potentials).params for s in initial_states]
    params_list_by_state = [[pot.params for pot in s.potentials] for s in initial_states]
    water_params_by_state = _water_params_by_state(initial_states, md_params)

    def water_counts() -> tuple:
        return tuple(sum(getattr(m, field)(st) for m, st in zip(context.movers, context.get_mover_states())
                         if getattr(m, "moves_atoms_nonlocally", False)) for field in ("n_accepted", "n_proposed"))

    n_states = len(initial_states)
    state_idxs = list(range(n_states))
    neighbor_pairs = list(zip(state_idxs, state_idxs[1:]))
    if n_states == 2:
        # an identity move keeps the two-state chain aperiodic
        neighbor_pairs = [(0, 0), *neighbor_pairs]

    hrex = HREX.from_replicas([CoordsVelBox(s.x0, s.v0, s.box0) for s in initial_states])
    samples_by_state = [Trajectory.empty() for _ in initial_states]
    replica_idx_by_state_by_iter: list = []
    fraction_accepted_by_pair_by_iter: list = []
    water_counts_by_state_by_iter: list = []
    begin_loop_time = last_update_time = time.perf_counter()

    for current_frame in range(md_params.n_frames):
        water_counts_iter = [(0, 0)] * n_states

        def sample_replica(xvb: CoordsVelBox, state_idx: int):
            context.set_x_t(xvb.coords)
            context.set_v_t(xvb.velocities)
            context.set_box(xvb.box)
            context.set_params(params_list_by_state[state_idx])
            if water_params_by_state is not None:
                context.set_water_sampler_params(water_params_by_state[state_idx])
            acc0, prop0 = water_counts()
            md_params_replica = replace(
                md_params,
                n_frames=1,
                n_eq_steps=md_params.n_eq_steps if current_frame == 0 else 0,
                seed=md_params.seed + state_idx * md_params.n_frames + current_frame,
            )
            frame, box, final_velos = next(
                sample_with_context_iter(context, md_params_replica, temperature, ligand_idxs, batch_size=1)
            )
            assert frame.shape[0] == 1
            barostat = context.get_barostat()
            scale = float(barostat[1].volume_scale) if barostat is not None else None
            acc1, prop1 = water_counts()
            water_counts_iter[state_idx] = (acc1 - acc0, prop1 - prop0)
            return frame[-1], box[-1], final_velos, scale

        def replica_from_samples(last_sample) -> CoordsVelBox:
            frame, box, velos, _ = last_sample
            return CoordsVelBox(frame, velos, box)

        hrex, samples_by_state_iter = hrex.sample_replicas(sample_replica, replica_from_samples)
        U_kl_raw = compute_potential_matrix(
            summed.potential, hrex, params_by_state, md_params.hrex_params.max_delta_states
        )
        U_kl = verify_and_sanitize_potential_matrix(U_kl_raw, hrex.replica_idx_by_state)
        log_q_kl = -U_kl / (BOLTZ * temperature)
        replica_idx_by_state_by_iter.append(list(hrex.replica_idx_by_state))
        hrex, fraction_accepted_by_pair = hrex.attempt_neighbor_swaps_fast(
            neighbor_pairs, log_q_kl, n_swap_attempts_per_iter, md_params.seed + current_frame + 1
        )
        if n_states == 2:
            fraction_accepted_by_pair = fraction_accepted_by_pair[1:]

        for samples, (xs, boxes, velos, scale) in zip(samples_by_state, samples_by_state_iter):
            samples.frames.extend([xs])
            samples.boxes.append(boxes)
            samples.final_velocities = velos
            samples.final_barostat_volume_scale_factor = scale
        fraction_accepted_by_pair_by_iter.append(fraction_accepted_by_pair)
        water_counts_by_state_by_iter.append(water_counts_iter)

        if print_diagnostics_interval and (current_frame + 1) % print_diagnostics_interval == 0:
            _print_hrex_progress(
                current_frame, md_params.n_frames, begin_loop_time, last_update_time, print_diagnostics_interval,
                fraction_accepted_by_pair, fraction_accepted_by_pair_by_iter, np.asarray(hrex.replica_idx_by_state),
            )
            last_update_time = time.perf_counter()

    neighbor_ulkns_by_component = generate_pair_bar_ulkns(initial_states, samples_by_state, temperature)
    pair_bar_results = [estimate_free_energy_bar(u, temperature) for u in neighbor_ulkns_by_component]
    diagnostics = HREXDiagnostics(replica_idx_by_state_by_iter, fraction_accepted_by_pair_by_iter)
    return (PairBarResult(list(initial_states), pair_bar_results), samples_by_state, diagnostics,
            _water_diagnostics(md_params, water_counts_by_state_by_iter))


def _print_hrex_progress(
    current_frame, n_frames, begin_loop_time, last_update_time, interval, pair_stats, stats_by_iter, perm,
):
    current_time = time.perf_counter()

    def rates(stats):
        return [acc / prop if prop else np.nan for acc, prop in stats]

    def format_rates(rs):
        return " |".join(f"{r * 100.0:5.1f}%" for r in rs)

    per_frame = (current_time - begin_loop_time) / (current_frame + 1)
    per_frame_now = (current_time - last_update_time) / interval
    print("Frame", current_frame + 1)
    print(
        f"{per_frame * (n_frames - (current_frame + 1)):.1f} s remaining at {per_frame:.2f} s/frame "
        f"({per_frame_now:.2f} s/frame since last message)"
    )
    print("HREX acceptance rates, current:", format_rates(rates(pair_stats)))
    print("HREX acceptance rates, average:", format_rates(rates(np.sum(stats_by_iter, axis=0))))
    print("HREX replica permutation      :", perm.tolist())
    print()
