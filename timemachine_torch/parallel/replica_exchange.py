"""Replica-parallel HREX (counterpart of
timemachine_tpu/parallel/replica_exchange.py).

All K replicas advance their MD segments together in one BatchedContext
(the JAX runner vmaps the production step over a leading replica axis);
the banded replica-by-state energy matrix U[r, l] (|l - state(r)| <=
max_delta_states, +inf outside, NaN -> +inf) is computed on the card, each
replica's 2 max_delta_states + 1 parameter sets in one batched energy
sweep; then the (K, K) matrix comes to the host, where the neighbor-swap
scan (md/hrex.neighbor_swap_scan) runs. Replicas never move: only the
permutation state -> replica, and with it the parameter rows each replica
reads, changes; with water sampling, so do the water sampler's parameters
(water_params_by_state), which each replica's mover state takes at every
segment, as JAX's runner does.

Randomness: one torch.Generator, seeded from `seed`, draws every step's
(K, N, 3) Langevin noise; the barostat draws (K, 2) uniforms a move from
its own, seeded from the template Context's barostat seed, and the water
sampler its proposals from its own, seeded from its mover's seed (ROADMAP
P28); a swap batch draws from numpy default_rng((seed, iteration)). The JAX runner folds a key
per replica and per step, and draws its swaps from a key folded with the
iteration. Both are reproducible from the seed.

The replica axis over a mesh (mesh=, make_replica_mesh): every rank runs
the same program; replica r lives on rank r // (K / ranks), whose
BatchedContext steps its K / ranks replicas. Every draw of the batch (the
Langevin noise, the barostat's (K, 2) uniforms, the water sampler's draws)
is made whole on every rank and sliced (BatchedContext draw_rows), the
banded U_kl and the frames are all-gathered by replica rows, and the swaps
run replicated, so a mesh run is the no-mesh run and advance_frame returns
the same IterationResult on every rank. JAX's mesh is one process's
devices; this one is a process group's ranks (ROADMAP P40).

Checkpoint and resume: state_dict() holds JAX's keys (xs, vs, boxes,
mover_leaves, perm, t, iteration) and what the port's streams carry where
JAX's are pure functions of the step (ROADMAP P37): the batch's step count
(which times the list rebuilds, the barostat and the water sampler), the
noise generator's state, every mover state's fields with its generator's
state among them, and the device type that wrote it. Every value is a
numpy array, bytes or a plain number, so the pickled dict holds no torch
object. A run resumed by load_state_dict is bitwise the uninterrupted one
on the same device type; another device type raises, since a CUDA
generator's state cannot seed a CPU generator. Under a mesh state_dict
gathers the replicas into the no-mesh form and load_state_dict takes this
rank's rows of it, so a checkpoint taken at one rank count resumes at
another.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Sequence

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ
from timemachine_torch.md.context import BatchedContext
from timemachine_torch.md.hrex import draw_swap_randomness, neighbor_swap_scan
from timemachine_torch.parallel.mesh import all_gather_rows, make_mesh, replica_slice


def make_replica_mesh(devices=None, axis_name: str = "replica"):
    """A 1-D mesh named (axis_name,) over every rank of the default process
    group (a one-rank group on a HashStore where none is initialized), on
    the card unless `devices` names the CPU; see parallel/mesh.py make_mesh."""
    return make_mesh(devices, axis_name)


@dataclass
class IterationResult:
    """One HREX iteration's outputs on the host, ordered by state."""

    frames_by_state: np.ndarray  # (K, N, 3)
    boxes_by_state: np.ndarray  # (K, 3, 3)
    replica_idx_by_state: np.ndarray  # (K,) the permutation during the segment
    accepted_by_pair: np.ndarray  # (n_pairs,)
    proposed_by_pair: np.ndarray  # (n_pairs,)
    U_kl: np.ndarray  # (K, K) replica-by-state energies (+inf outside the band)


class ReplicaExchangeRunner:
    """Drives K states of one topology, all replicas in one batched step.

    Built from a template Context (its potentials, configured, its
    integrator and movers) and per-state parameter lists; the states must
    be potentials-compatible (the same terms, other parameters)."""

    def __init__(
        self,
        context,
        params_list_by_state: Sequence[Sequence],
        *,
        temperature: float,
        neighbor_pairs,
        n_swap_attempts_per_iter: int,
        max_delta_states: Optional[int],
        seed: int,
        water_params_by_state=None,
        mesh=None,
    ):
        self._context = context
        self.n_states = len(params_list_by_state)
        self.kT = BOLTZ * temperature
        self.neighbor_pairs = np.asarray(neighbor_pairs).reshape(-1, 2)
        self.n_swap_attempts = n_swap_attempts_per_iter
        self.max_delta = max_delta_states if max_delta_states is not None else self.n_states
        self.seed = seed
        self.mesh = mesh
        self._rows = replica_slice(self.n_states, mesh)  # this rank's replicas
        dev = context.device
        self._params_by_state = [
            torch.stack([torch.as_tensor(pls[i], device=dev, dtype=pot.params.dtype) for pls in params_list_by_state])
            for i, pot in enumerate(context.potentials)
        ]
        self._water_params = None
        if water_params_by_state is not None:
            self._water_params = torch.stack([torch.as_tensor(np.asarray(w), device=dev) for w in water_params_by_state])
        self._water_mover_idx = [i for i, m in enumerate(context.movers) if getattr(m, "moves_atoms_nonlocally", False)]
        self._batch: Optional[BatchedContext] = None
        self.perm = np.arange(self.n_states)
        self.t = 0
        self.iteration = 0

    # -- setup ----------------------------------------------------------------

    def initialize(self, xs0, vs0, boxes0):
        """Stack the replicas' dynamic state; replica r starts at state r."""
        assert len(xs0) == self.n_states
        self.perm = np.arange(self.n_states)
        rows = self._rows
        self._batch = BatchedContext(
            self._context, np.stack(xs0)[rows], np.stack(vs0)[rows], np.stack(boxes0)[rows], self._params_of_replicas(),
            self.seed, draw_rows=None if self.mesh is None else (rows, self.n_states),
        )
        if self._water_params is not None:
            self._batch.set_water_sampler_params(self._water_params[rows])
        self.t = 0
        self.iteration = 0

    @property
    def batch(self) -> BatchedContext:
        return self._batch

    def _state_of_replica(self) -> np.ndarray:
        return np.argsort(self.perm)

    def _params_of_replicas(self) -> list:
        """Each term's parameters of this rank's replicas at their states."""
        idx = torch.as_tensor(self._state_of_replica()[self._rows], device=self._context.device)
        return [p[idx] for p in self._params_by_state]

    def _gathered(self, t: torch.Tensor) -> np.ndarray:
        """Every replica's rows of t (this rank's replicas' rows), as numpy."""
        return all_gather_rows(t, self.mesh).cpu().numpy()

    def _segment(self, n_steps: int):
        """n_steps of every replica at its current state; the lists are
        rebuilt at the start from the replicas' current parameters (swaps
        re-point replicas at other parameter rows), as in JAX's segment."""
        self._batch.set_params(self._params_of_replicas())
        if self._water_params is not None:
            idx = torch.as_tensor(self._state_of_replica()[self._rows], device=self._context.device)
            self._batch.set_water_sampler_params(self._water_params[idx])
        self._batch.multiple_steps(n_steps)
        self.t += n_steps

    # -- public stepping ------------------------------------------------------

    def equilibrate(self, n_eq_steps: int, barostat_interval: Optional[int] = 15):
        """Advance every replica n_eq_steps at its current state, with no
        swaps and no frames, the barostat every barostat_interval steps."""
        if n_eq_steps <= 0:
            return
        prev = self._batch.set_barostat_interval(barostat_interval) if barostat_interval is not None else None
        self._segment(n_eq_steps)
        if prev is not None:
            self._batch.set_barostat_interval(prev)
        assert np.all(np.isfinite(self._batch.get_x_t())), "Equilibration resulted in a nan"

    def banded_energies(self) -> np.ndarray:
        """(K, K) U[r, l]: replica r's coordinates under state l's
        parameters for |l - state(r)| <= max_delta_states (clipped to the
        ladder, as JAX's), +inf elsewhere and where U is NaN; on the host."""
        K = self.n_states
        delta = min(self.max_delta, K - 1)
        s_r = torch.as_tensor(self._state_of_replica()[self._rows], device=self._context.device)
        cols = torch.clamp(s_r[:, None] + torch.arange(-delta, delta + 1, device=s_r.device), 0, K - 1)  # (K, S)
        u = self._batch.energies_with_params([p[cols] for p in self._params_by_state])
        U = torch.full((len(s_r), K), torch.inf, dtype=u.dtype, device=u.device).scatter_(1, cols, u)
        U = torch.where(torch.isnan(U), torch.inf, U)
        return self._gathered(U).astype(np.float64)

    def advance_frame(self, n_steps: int) -> IterationResult:
        """One HREX iteration: the MD segment, the banded U_kl and a swap batch."""
        perm_during_segment = self.perm.copy()
        self._segment(n_steps)
        frames = self._gathered(self._batch._x)[perm_during_segment]
        boxes = self._gathered(self._batch._box)[perm_during_segment]
        U = self.banded_energies()
        own_state = np.argsort(perm_during_segment)
        assert np.all(np.isfinite(U[np.arange(self.n_states), own_state])), "Replicas have non-finite energies"
        pair_idxs, uniforms = draw_swap_randomness(
            (self.seed, self.iteration), len(self.neighbor_pairs), self.n_swap_attempts
        )
        self.perm, accepted, proposed = neighbor_swap_scan(
            perm_during_segment, -U / self.kT, self.neighbor_pairs, pair_idxs, uniforms
        )
        self.iteration += 1
        return IterationResult(frames, boxes, perm_during_segment, accepted, proposed, U)

    # -- checkpoint / resume ---------------------------------------------------

    def state_dict(self) -> dict:
        """Everything a bitwise resume needs, as numpy arrays and numbers.
        mover_leaves lists every mover state's fields in order, a
        generator as its state's bytes (uint8)."""
        b = self._batch
        return {
            "xs": self._gathered(b._x),
            "vs": self._gathered(b._v),
            "boxes": self._gathered(b._box),
            "mover_leaves": [self._leaf(getattr(st, f.name)) for st in b.get_mover_states() for f in fields(st)],
            "perm": np.asarray(self.perm).copy(),
            "t": int(self.t),
            "iteration": int(self.iteration),
            "step": int(b._step),
            "noise_state": self._leaf(b._noise),
            "device_type": self._context.device.type,
        }

    def load_state_dict(self, state: dict):
        """Restore from state_dict(). The runner must be built as the one
        that wrote it (the same context, parameters and seed): the batch is
        built as initialize builds it, then every field is restored, the
        mover states' structure from the fresh batch and their leaves from
        the checkpoint."""
        here = self._context.device.type
        if state["device_type"] != here:
            raise ValueError(
                f"the checkpoint was written on {state['device_type']!r} and cannot resume on {here!r}: "
                "its generator states are that device type's"
            )
        self.initialize(state["xs"], state["vs"], state["boxes"])
        b = self._batch
        leaves = list(state["mover_leaves"])
        if len(leaves) != sum(len(fields(st)) for st in b._mover_states):
            raise ValueError("the checkpoint's mover states do not match this runner's movers")
        leaves.reverse()
        b._mover_states = [
            replace(st, **{f.name: self._restore_rows(getattr(st, f.name), leaves.pop()) for f in fields(st)})
            for st in b._mover_states
        ]
        b._noise = _restore(b._noise, state["noise_state"])
        b._step = int(state["step"])
        self.perm = np.asarray(state["perm"]).copy()
        self.t = int(state["t"])
        self.iteration = int(state["iteration"])

    # -- state-ordered observers ----------------------------------------------

    def final_state_arrays(self):
        """(coords, velocities, boxes) ordered by state."""
        b = self._batch
        return self._gathered(b._x)[self.perm], self._gathered(b._v)[self.perm], self._gathered(b._box)[self.perm]

    def water_counters_by_replica(self) -> Optional[tuple]:
        """(accepted (K,), proposed (K,)) of the water sampler by replica, or None without one."""
        if not self._water_mover_idx:
            return None
        st = self._batch.get_mover_states()[self._water_mover_idx[0]]
        return self._gathered(st.n_accepted).astype(np.int64), self._gathered(st.n_proposed).astype(np.int64)

    def mover_state_field_by_state(self, mover_idx: int, field: str) -> np.ndarray:
        """A per-replica mover-state field, ordered by state."""
        return self._gathered(getattr(self._batch.get_mover_states()[mover_idx], field))[self.perm]

    def _leaf(self, value) -> np.ndarray:
        """A mover-state field of every replica, or a generator, as a numpy
        array (a generator: its state's bytes, the same on every rank)."""
        if isinstance(value, torch.Generator):
            return value.get_state().numpy().copy()
        return self._gathered(value.detach()).copy()

    def _restore_rows(self, like, leaf):
        """_restore of this rank's rows of a checkpoint's per-replica field (a generator whole)."""
        return _restore(like, leaf if isinstance(like, torch.Generator) else np.asarray(leaf)[self._rows])


def _restore(like, leaf):
    """leaf (from _leaf) as the kind of `like`: a generator on like's device
    in that state, or a tensor of like's dtype and device."""
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        gen.set_state(torch.as_tensor(np.asarray(leaf, dtype=np.uint8)))
        return gen
    return torch.as_tensor(np.asarray(leaf), device=like.device, dtype=like.dtype).clone()
