"""Hamiltonian replica exchange: permutation sampling and mixing diagnostics
(counterpart of timemachine_tpu/md/hrex.py).

Replicas never move; the K-vector `replica_idx_by_state` (state -> replica)
is what swaps. The swap batch (`neighbor_swap_scan`) runs on the host in
float64 numpy: its input, the (K, K) matrix of reduced log probabilities,
comes to the host every HREX iteration anyway, and K^3 attempts of a few
scalar operations each take about a millisecond at K = 12. The JAX package
runs the same sequence as a `lax.scan` inside its device program.

Randomness: a swap batch draws its pair choices and uniforms from a numpy
Generator seeded from what the caller passes (the replica-exchange runner
passes (seed, iteration)); the JAX package draws them from a jax.random
key. Given the same draws, the two scans give the same permutation and the
same counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Generic, Optional, Sequence, TypeVar

import numpy as np
from scipy.stats import entropy

from timemachine_torch.md.moves import MixtureOfMoves, MonteCarloMove
from timemachine_torch.utils import batches, not_ragged

Replica = TypeVar("Replica")


def get_swap_attempts_per_iter_heuristic(n_states: int) -> int:
    """K^3 attempts mix the permutation chain in one iteration
    (Chodera & Shirts, JCP 135:194110)."""
    return n_states**3


def neighbor_swap_scan(replica_idx_by_state, log_q_kl, neighbor_pairs, pair_idxs, uniforms):
    """Sequential Metropolis swap attempts, in float64 on the host.

    replica_idx_by_state: (K,) int, the current permutation (state -> replica)
    log_q_kl: (K, K) replica-by-state reduced log probabilities (-inf allowed)
    neighbor_pairs: (n_pairs, 2) candidate state pairs
    pair_idxs, uniforms: (n_attempts,) pre-drawn pair choices and uniforms

    Returns (final permutation, accepted per pair, proposed per pair); an
    attempt whose log acceptance is NaN (inf - inf) is rejected, as in JAX's
    scan."""
    perm = [int(r) for r in np.asarray(replica_idx_by_state)]
    log_q = np.asarray(log_q_kl, dtype=np.float64).tolist()
    pairs = [(int(a), int(b)) for a, b in np.asarray(neighbor_pairs).reshape(-1, 2)]
    with np.errstate(divide="ignore"):
        log_u = np.log(np.asarray(uniforms, dtype=np.float64)).tolist()
    n_acc = np.zeros(len(pairs), np.uint32)
    n_prop = np.zeros(len(pairs), np.uint32)
    for which, lu in zip(np.asarray(pair_idxs).tolist(), log_u):
        s_lo, s_hi = pairs[which]
        r_lo, r_hi = perm[s_lo], perm[s_hi]
        gain = log_q[r_lo][s_hi] + log_q[r_hi][s_lo] - log_q[r_lo][s_lo] - log_q[r_hi][s_hi]
        n_prop[which] += 1
        if lu < gain and lu < 0.0:  # log u < min(gain, 0); False for a NaN gain
            perm[s_lo], perm[s_hi] = r_hi, r_lo
            n_acc[which] += 1
    return np.array(perm), n_acc, n_prop


def draw_swap_randomness(seed, n_pairs: int, n_attempts: int):
    """(pair choices, uniforms in [0, 1)) for one swap batch, from a numpy
    Generator seeded with `seed` (an int or a sequence of ints)."""
    rng = np.random.default_rng(seed)
    return rng.integers(n_pairs, size=n_attempts), rng.random(n_attempts)


class NeighborSwapMove(MonteCarloMove):
    """Swap move at one fixed state pair, one attempt at a time (the slow
    path, held statistically against the scan)."""

    def __init__(self, log_q: Callable, s_a: int, s_b: int, rng: Optional[np.random.Generator] = None):
        super().__init__(rng)
        self.log_q = log_q
        self.s_a = s_a
        self.s_b = s_b

    def propose(self, state):
        a, b = self.s_a, self.s_b
        swapped = list(state)
        swapped[a], swapped[b] = state[b], state[a]
        gain = self.log_q(state[a], b) + self.log_q(state[b], a) - self.log_q(state[a], a) - self.log_q(state[b], b)
        return swapped, np.minimum(gain, 0.0)


@dataclass(frozen=True)
class HREX(Generic[Replica]):
    replicas: list
    replica_idx_by_state: list

    @classmethod
    def from_replicas(cls, replicas: Sequence) -> "HREX":
        return HREX(list(replicas), list(range(len(replicas))))

    @property
    def state_replica_pairs(self):
        return [(s, self.replicas[r]) for s, r in enumerate(self.replica_idx_by_state)]

    def sample_replicas(self, sample_replica: Callable, replica_from_samples: Callable):
        """Advance every (state, replica) pairing one segment; returns the
        updated ensemble and the samples by state."""
        samples_by_state = [sample_replica(replica, s) for s, replica in self.state_replica_pairs]
        replicas = list(self.replicas)
        for s, samples in enumerate(samples_by_state):
            replicas[self.replica_idx_by_state[s]] = replica_from_samples(samples)
        return HREX(replicas, self.replica_idx_by_state), samples_by_state

    def attempt_neighbor_swaps(self, neighbor_pairs, log_q: Callable, n_swap_attempts: int, rng=None):
        """Slow path: sequential moves through MixtureOfMoves, every draw
        from `rng` (a numpy Generator)."""
        rng = np.random.default_rng() if rng is None else rng
        move = MixtureOfMoves([NeighborSwapMove(log_q, a, b, rng) for a, b in neighbor_pairs], rng)
        perm = move.move_n(list(self.replica_idx_by_state), n_swap_attempts)
        stats = list(zip(move.n_accepted_by_move, move.n_proposed_by_move))
        return HREX(self.replicas, perm), stats

    def attempt_neighbor_swaps_fast(self, neighbor_pairs, log_q_kl, n_swap_attempts: int, seed):
        """Production path: neighbor_swap_scan with draws seeded by `seed`."""
        pair_idxs, uniforms = draw_swap_randomness(seed, len(neighbor_pairs), n_swap_attempts)
        perm, n_acc, n_prop = neighbor_swap_scan(
            self.replica_idx_by_state, log_q_kl, np.asarray(neighbor_pairs), pair_idxs, uniforms
        )
        stats = list(zip(n_acc.tolist(), n_prop.tolist()))
        return HREX(self.replicas, [int(r) for r in perm]), stats


# -- diagnostics --------------------------------------------------------------


def get_cumulative_replica_state_counts(replica_idx_by_state_by_iter) -> np.ndarray:
    """(iter, state, replica) cumulative visit counts."""
    perms = np.asarray(replica_idx_by_state_by_iter)  # (T, K): state -> replica
    n_iters, n_states = perms.shape
    occupancy = np.zeros((n_iters, n_states, n_states), dtype=int)
    t_idx = np.repeat(np.arange(n_iters), n_states)
    s_idx = np.tile(np.arange(n_states), n_iters)
    occupancy[t_idx, s_idx, perms.reshape(-1)] = 1
    return occupancy.cumsum(axis=0)


def get_normalized_kl_divergence(replica_idx_by_state_by_iter) -> float:
    """How unevenly replicas visit states: log K minus the mean entropy of
    each replica's visit distribution (0: perfect mixing, log K: frozen)."""
    visits = get_cumulative_replica_state_counts(replica_idx_by_state_by_iter)[-1]
    n_states = visits.shape[0]
    visit_fraction = visits / visits.sum(axis=0, keepdims=True)
    return float(np.log(n_states) - entropy(visit_fraction, axis=0).mean())


def estimate_transition_matrix(replica_idx_by_state_by_iter) -> np.ndarray:
    """(to_state, from_state) one-iteration transition probabilities,
    counted over every replica's track of states."""
    perms = np.asarray(replica_idx_by_state_by_iter)
    n_iters, n_states = perms.shape
    state_track = np.argsort(perms, axis=1)  # state_track[t, r] = state of replica r at iteration t
    counts = np.zeros((n_states, n_states))
    np.add.at(counts, (state_track[1:].reshape(-1), state_track[:-1].reshape(-1)), 1.0)
    return counts / (n_iters - 1)


def estimate_relaxation_time(transition_matrix) -> float:
    """1 / (1 - mu_2) of the symmetrized transition matrix."""
    assert np.allclose(transition_matrix.sum(axis=0), 1.0), "columns of transition matrix must sum to 1"
    reversible = 0.5 * (transition_matrix + transition_matrix.T)
    mu = np.linalg.eigvalsh(reversible)
    return float(1.0 / (1.0 - mu[-2]))


def get_samples_by_iter_by_replica(samples_by_state_by_iter, replica_idx_by_state_by_iter):
    """Regroup (iter, state) samples into (replica, iter) tracks."""
    assert len(samples_by_state_by_iter) == len(replica_idx_by_state_by_iter)
    assert not_ragged(samples_by_state_by_iter)
    assert not_ragged(replica_idx_by_state_by_iter)
    state_of_replica = np.argsort(np.asarray(replica_idx_by_state_by_iter), axis=1)
    n_replicas = state_of_replica.shape[1]
    return [
        [samples_by_state[state_of_replica[t, r]] for t, samples_by_state in enumerate(samples_by_state_by_iter)]
        for r in range(n_replicas)
    ]


@dataclass
class HREXDiagnostics:
    replica_idx_by_state_by_iter: list
    fraction_accepted_by_pair_by_iter: list  # (accepted, proposed) per pair per iteration

    @property
    def cumulative_swap_acceptance_rates(self) -> np.ndarray:
        stats = np.asarray(self.fraction_accepted_by_pair_by_iter)  # (T, n_pairs, 2)
        accepted = stats[..., 0].cumsum(axis=0)
        proposed = stats[..., 1].cumsum(axis=0)
        return accepted / proposed

    @property
    def cumulative_replica_state_counts(self) -> np.ndarray:
        return get_cumulative_replica_state_counts(self.replica_idx_by_state_by_iter)

    @property
    def transition_matrix(self) -> np.ndarray:
        return estimate_transition_matrix(self.replica_idx_by_state_by_iter)

    @property
    def relaxation_time(self) -> float:
        return estimate_relaxation_time(self.transition_matrix)

    @property
    def normalized_kl_divergence(self) -> float:
        return get_normalized_kl_divergence(self.replica_idx_by_state_by_iter)


# -- generic single-host driver ----------------------------------------------


def run_hrex(
    replicas,
    sample_replica: Callable,
    replica_from_samples: Callable,
    neighbor_pairs,
    get_log_q: Callable,
    n_samples: int,
    n_samples_per_iter: int,
    seed: int,
    n_swap_attempts_per_iter: Optional[int] = None,
):
    """HREX over arbitrary replica objects: each iteration swaps (draws
    seeded with seed + iteration), then samples every state.
    get_log_q(replicas) gives the (K, K) matrix or a callable log_q(r, s)."""
    n_states = len(replicas)
    if n_swap_attempts_per_iter is None:
        n_swap_attempts_per_iter = get_swap_attempts_per_iter_heuristic(n_states)

    ensemble = HREX.from_replicas(replicas)
    samples_by_state_by_iter = []
    perm_by_iter = []
    swap_stats_by_iter = []

    for iteration, batch in enumerate(batches(n_samples, n_samples_per_iter)):
        log_q = get_log_q(ensemble.replicas)
        log_q_kl = (
            np.array([[log_q(r, s) for s in range(n_states)] for r in range(n_states)]) if callable(log_q) else log_q
        )
        ensemble, swap_stats = ensemble.attempt_neighbor_swaps_fast(
            neighbor_pairs, log_q_kl, n_swap_attempts_per_iter, seed + iteration
        )
        ensemble, samples_by_state = ensemble.sample_replicas(
            lambda replica, s: sample_replica(replica, s, batch), replica_from_samples
        )
        samples_by_state_by_iter.append(samples_by_state)
        perm_by_iter.append(ensemble.replica_idx_by_state)
        swap_stats_by_iter.append(swap_stats)

    return samples_by_state_by_iter, HREXDiagnostics(perm_by_iter, swap_stats_by_iter)
