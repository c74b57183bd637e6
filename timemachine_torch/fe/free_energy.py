"""Free-energy driver: λ-window states, sampling in one reused Context and
pair BAR (counterpart of the fixed-grid path of
timemachine_tpu/fe/free_energy.py: run_sims_sequential and what it runs).

An InitialState holds the port's potential modules on their device. Frames
come back from the card as numpy and stay in memory (the JAX package's
StoredArrays, which spills them to disk, is not ported). The host term runs
the rowscan configuration at every size, since the port has no dense MD path.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence
from warnings import warn

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ
from timemachine_torch.fe.bar import (
    bar_with_pessimistic_uncertainty,
    df_and_err_from_u_kln,
    pair_overlap_from_ukln,
    works_from_ukln,
)
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.context import Context
from timemachine_torch.potentials import Nonbonded, NonbondedAllPairs, NonbondedInteractionGroup


@dataclass(frozen=True)
class MDParams:
    """Sampling protocol: n_eq_steps of equilibration, then n_frames frames
    steps_per_frame steps apart, from seed. local MD and water sampling are
    not ported yet: the drivers raise where either is asked for."""

    n_frames: int
    n_eq_steps: int
    steps_per_frame: int
    seed: int
    local_md_params: Optional[object] = None
    water_sampling_params: Optional[object] = None

    def __post_init__(self):
        assert self.steps_per_frame > 0
        assert self.n_frames > 0
        assert self.n_eq_steps >= 0


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
    def overlaps(self) -> list:
        return self._per_pair("overlap")

    @property
    def u_kln_by_component_by_lambda(self) -> np.ndarray:
        return np.array(self._per_pair("u_kln_by_component"))


@dataclass
class Trajectory:
    """Frames and boxes, with the final MD state needed to continue a run."""

    frames: list  # (atom, dim) numpy arrays
    boxes: list  # (dim, dim) numpy arrays
    final_velocities: Optional[np.ndarray]
    final_barostat_volume_scale_factor: Optional[float] = None

    def __post_init__(self):
        if len(self.boxes) != len(self.frames):
            raise ValueError("frames and boxes must have equal length")


def get_potential_by_type(potentials: Sequence, pot_type):
    for pot in potentials:
        if type(pot) is pot_type:
            return pot
    raise ValueError(f"Unable to find potential of type: {pot_type}")


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
    """Give every all-pairs term of the state not yet configured the rowscan
    configuration, sized from the state's geometry (in place: it selects a
    kernel, not the physics)."""
    for pot in initial_state.potentials:
        if isinstance(pot, NonbondedAllPairs) and pot.kernel is None:
            dev, dt = pot.params.device, pot.params.dtype
            box = torch.as_tensor(initial_state.box0, device=dev, dtype=dt)
            pot.configure(box, torch.as_tensor(initial_state.x0, device=dev, dtype=dt), kernel="rowscan")


def get_context(initial_state: InitialState, md_params: Optional[MDParams] = None) -> Context:
    """A Context over copies of the state's potentials, so that set_params
    and reset_for_state leave the state as it is, after
    configure_all_pairs. The Context's device and dtype are the
    potentials': a state loaded on the card (the loaders' default) runs
    there."""
    if md_params is not None and md_params.water_sampling_params is not None:
        raise NotImplementedError("water sampling is not ported yet (ROADMAP queue 1 item 8)")
    configure_all_pairs(initial_state)
    params = initial_state.potentials[0].params
    movers = [initial_state.barostat] if initial_state.barostat is not None else []
    return Context(
        torch.as_tensor(initial_state.x0, dtype=params.dtype),
        initial_state.v0,
        initial_state.box0,
        initial_state.integrator,
        [copy.deepcopy(pot) for pot in initial_state.potentials],
        movers=movers,
        device=params.device,
    )


def batches(n: int, batch_size: int) -> Iterator[int]:
    """Sizes of consecutive batches covering n items."""
    full, rem = divmod(n, batch_size)
    yield from [batch_size] * full
    if rem:
        yield rem


def sample_with_context_iter(
    ctxt: Context, md_params: MDParams, temperature: float, ligand_idxs: np.ndarray, batch_size: int
) -> Iterator[tuple]:
    """Equilibrate (the barostat every 15 steps, then its own interval
    again), then yield (frames, boxes, final velocities) up to batch_size
    frames at a time. Global MD only: local MD is not ported yet."""
    if md_params.local_md_params is not None:
        raise NotImplementedError("local MD (multiple_steps_local) is not ported yet (ROADMAP queue 1 item 8)")
    if md_params.n_eq_steps:
        original = ctxt.set_barostat_interval(15)
        ctxt.multiple_steps(n_steps=md_params.n_eq_steps, store_x_interval=0)
        if original is not None:
            ctxt.set_barostat_interval(original)
    assert np.all(np.isfinite(ctxt.get_x_t())), "Equilibration resulted in a nan"
    for n_frames in batches(md_params.n_frames, batch_size):
        coords, boxes = ctxt.multiple_steps(n_steps=n_frames * md_params.steps_per_frame, store_x_interval=md_params.steps_per_frame)
        yield coords, boxes, ctxt.get_v_t()


def sample_with_context(
    ctxt: Context, md_params: MDParams, temperature: float, ligand_idxs: np.ndarray, max_buffer_frames: int
) -> Trajectory:
    frames, boxes, final_velocities = [], [], None
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
