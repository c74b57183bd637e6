"""HREX over a bare (u_fn, parameter ladder) interface on a mesh
(counterpart of timemachine_tpu/parallel/hrex_sharded.py).

The production replica engine is parallel/replica_exchange.py's
ReplicaExchangeRunner (the full Context step, movers, banded U_kl); this
is the minimal standalone form, for a u_fn(x, box, params) of torch
tensors. Every rank of the mesh runs the same program:

* replica r lives on rank r // (K / ranks) and never moves; swaps change
  which parameter row each replica reads;
* each step's force is -dU/dx by torch.autograd.grad of the sum of the
  rank's replicas' u_fn (each replica's gradient is its own u_fn's);
* each step's (K, N, 3) Langevin noise is drawn whole on every rank from
  one torch.Generator seeded with `seed`, and each rank takes its
  replicas' rows, so a run over any number of ranks is the one-rank run
  (JAX folds a key per replica and step);
* the (K, K) reduced log-probabilities log_q[r, k] = -u_fn(x_r, box_r,
  params_k) / kT are computed by each rank for its replicas and
  all-gathered by replica rows, NaN mapped to -inf;
* the neighbour swap scan runs replicated on every rank (md/hrex.py), its
  draws from numpy default_rng((seed, iteration)), as the production
  runner's;
* frames are emitted ordered by state (the permutation after the swaps,
  as JAX's).

mesh None runs every replica on this process. The barostat arguments are
JAX's signature; as in JAX, neither runs a barostat here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ
from timemachine_torch.device import resolve_device
from timemachine_torch.integrators import langevin_coefficients, langevin_step
from timemachine_torch.md.hrex import draw_swap_randomness, neighbor_swap_scan
from timemachine_torch.parallel.mesh import all_gather_rows, replica_slice
from timemachine_torch.parallel.replica_exchange import make_replica_mesh  # noqa: F401  (JAX's name here too)


@dataclass
class ShardedHREXResult:
    frames: np.ndarray  # (n_iters, K, N, 3) coords by state
    boxes: np.ndarray  # (n_iters, K, 3, 3)
    replica_idx_by_state_by_iter: np.ndarray  # (n_iters, K)
    accepted_by_pair_by_iter: np.ndarray  # (n_iters, n_pairs)
    proposed_by_pair_by_iter: np.ndarray  # (n_iters, n_pairs)
    final_coords: np.ndarray  # (K, N, 3) by replica
    final_velocities: np.ndarray
    final_boxes: np.ndarray
    log_q_kl_by_iter: np.ndarray  # (n_iters, K, K) replica-state reduced log-probs


def run_hrex_sharded(
    u_fn: Callable,  # (x, box, params) -> potential energy (kJ/mol), torch tensors
    params_by_state,  # (K, P) parameter rows per state
    xs0,  # (K, N, 3) initial coords per replica
    vs0,  # (K, N, 3)
    boxes0,  # (K, 3, 3)
    masses,  # (N,)
    temperature: float,
    dt: float,
    friction: float,
    n_iters: int,
    steps_per_iter: int,
    neighbor_pairs,  # (n_pairs, 2)
    n_swap_attempts_per_iter: int,
    seed: int,
    mesh=None,
    barostat_move: Optional[Callable] = None,
    barostat_interval: int = 0,
    device=None,
    dtype=None,
) -> ShardedHREXResult:
    """Run n_iters HREX iterations (an MD segment of steps_per_iter steps,
    log_q, a swap batch) of K replicas over the mesh's ranks; every rank
    returns the same result. The replicas' state is held on `device` (the
    card unless the caller asks for the CPU) in `dtype` (xs0's where None)."""
    del barostat_move, barostat_interval
    dev = resolve_device(device)

    def tensor(a, dt):
        return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a), device=dev, dtype=dt)

    xs0 = tensor(xs0, dtype)
    dt_ = xs0.dtype
    params_by_state = tensor(params_by_state, dt_)
    k_states = params_by_state.shape[0]
    mine = replica_slice(k_states, mesh)
    neighbor_pairs = np.asarray(neighbor_pairs).reshape(-1, 2)
    kt = BOLTZ * temperature

    ca, cb, cc = langevin_coefficients(temperature, dt, friction, np.asarray(masses))
    cb = torch.as_tensor(cb[:, None], device=dev, dtype=dt_)
    cc = torch.as_tensor(cc[:, None], device=dev, dtype=dt_)
    noise = torch.Generator(device=dev)
    noise.manual_seed(seed)

    xs, vs, boxes = xs0[mine].clone(), tensor(vs0, dt_)[mine].clone(), tensor(boxes0, dt_)[mine]
    perm = np.arange(k_states)

    def forces(x, params):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            u = sum(u_fn(x[r], boxes[r], params[r]) for r in range(x.shape[0]))
            (grad,) = torch.autograd.grad(u, x)
        return -grad

    outputs = []
    for _ in range(n_iters):
        state_of_replica = np.argsort(perm)
        params = params_by_state[torch.as_tensor(state_of_replica[mine], device=dev)]
        for _ in range(steps_per_iter):
            xi = torch.randn((k_states, *xs.shape[1:]), generator=noise, device=dev, dtype=dt_)[mine]
            xs, vs = langevin_step(xs, vs, forces(xs, params), xi, ca, cb, cc, dt)
        with torch.no_grad():
            u_rk = torch.stack([torch.stack([u_fn(xs[r], boxes[r], p) for p in params_by_state]) for r in range(xs.shape[0])])
        log_q = all_gather_rows(-u_rk / kt, mesh)
        log_q = torch.where(torch.isnan(log_q), -torch.inf, log_q).cpu().numpy()
        all_xs = all_gather_rows(xs, mesh).cpu().numpy()
        all_boxes = all_gather_rows(boxes, mesh).cpu().numpy()
        pair_idxs, uniforms = draw_swap_randomness((seed, len(outputs)), len(neighbor_pairs), n_swap_attempts_per_iter)
        perm, accepted, proposed = neighbor_swap_scan(perm, log_q, neighbor_pairs, pair_idxs, uniforms)
        outputs.append((all_xs[perm], all_boxes[perm], perm.copy(), accepted, proposed, log_q))

    frames, frame_boxes, perms, accepted, proposed, log_qs = (np.stack(o) for o in zip(*outputs)) if outputs else [
        np.zeros((0,))] * 6
    return ShardedHREXResult(
        frames=frames,
        boxes=frame_boxes,
        replica_idx_by_state_by_iter=perms,
        accepted_by_pair_by_iter=accepted,
        proposed_by_pair_by_iter=proposed,
        final_coords=all_gather_rows(xs, mesh).cpu().numpy(),
        final_velocities=all_gather_rows(vs, mesh).cpu().numpy(),
        final_boxes=all_gather_rows(boxes, mesh).cpu().numpy(),
        log_q_kl_by_iter=log_qs,
    )
