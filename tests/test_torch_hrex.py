"""The port's HREX permutation sampler (timemachine_torch/md/hrex.py and
md/moves.py) against timemachine_tpu/md/hrex.py.

Given the same reduced log probabilities, pair choices and uniforms (made
with numpy), the port's host scan and JAX's lax.scan give equal
permutations and equal counts; the diagnostics agree to 1e-12 on one
seeded permutation history. The port draws its own randomness (numpy
Generators), so the sampling tests are ports of tests/test_hrex.py on the
port's generators.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from timemachine_torch.md import hrex as th  # noqa: E402
from timemachine_torch.md.moves import MixtureOfMoves, MonteCarloMove, SequenceOfMoves  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores


def _jax_hrex():
    import jax

    jax.config.update("jax_enable_x64", True)
    from timemachine_tpu.md import hrex as jh

    return jh


def _swap_case(k: int, seed: int, n_attempts: int = None):
    """(perm, log_q_kl with -inf entries, neighbor pairs, pair choices,
    uniforms) for K states, from numpy."""
    rng = np.random.default_rng(seed)
    log_q = rng.normal(0.0, 2.0, (k, k))
    log_q[rng.random((k, k)) < 0.15] = -np.inf  # U = +inf: outside a band, or a NaN energy
    pairs = np.array([(i, i + 1) for i in range(k - 1)] or [(0, 0)])
    if k == 2:
        pairs = np.array([(0, 0), (0, 1)])  # run_sims_hrex's identity pair
    n_attempts = n_attempts or k**3
    return (
        rng.permutation(k), log_q, pairs, rng.integers(len(pairs), size=n_attempts),
        rng.random(n_attempts),
    )


@pytest.mark.parametrize("k", [2, 5, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_neighbor_swap_scan_equals_jax(k, seed):
    """The host scan against JAX's neighbor_swap_scan on the same inputs,
    -inf entries included (their NaN gains reject): perm, accepted and
    proposed equal."""
    jh = _jax_hrex()
    import jax.numpy as jnp

    perm, log_q, pairs, pair_idxs, uniforms = _swap_case(k, seed)
    p, acc, prop = th.neighbor_swap_scan(perm, log_q, pairs, pair_idxs, uniforms)
    jp, jacc, jprop = jh.neighbor_swap_scan(
        jnp.asarray(perm), jnp.asarray(log_q), jnp.asarray(pairs), jnp.asarray(pair_idxs), jnp.asarray(uniforms)
    )
    np.testing.assert_array_equal(p, np.asarray(jp))
    np.testing.assert_array_equal(acc, np.asarray(jacc))
    np.testing.assert_array_equal(prop, np.asarray(jprop))
    assert int(prop.sum()) == k**3 and 0 < int(acc.sum()) < k**3
    assert sorted(p.tolist()) == list(range(k))


def test_draw_swap_randomness_and_the_fast_path():
    """draw_swap_randomness repeats from its seed and differs between
    iterations; attempt_neighbor_swaps_fast is the scan on those draws."""
    a, b = th.draw_swap_randomness((7, 3), 4, 64), th.draw_swap_randomness((7, 3), 4, 64)
    c = th.draw_swap_randomness((7, 4), 4, 64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and not np.array_equal(a[1], c[1])
    assert a[0].min() >= 0 and a[0].max() < 4 and ((a[1] >= 0) & (a[1] < 1)).all()
    _, log_q, pairs, _, _ = _swap_case(5, 3)
    hrex = th.HREX.from_replicas(list("abcde"))
    fast, stats = hrex.attempt_neighbor_swaps_fast(pairs, log_q, 125, seed=(7, 3))
    perm, acc, prop = th.neighbor_swap_scan(np.arange(5), log_q, pairs, *th.draw_swap_randomness((7, 3), len(pairs), 125))
    assert fast.replica_idx_by_state == perm.tolist() and stats == list(zip(acc.tolist(), prop.tolist()))
    assert fast.replicas == hrex.replicas


def _perm_history(k=6, n_iters=40, seed=5):
    """A permutation history from neighbor swaps with seeded draws, and
    its per-iteration swap counts."""
    rng = np.random.default_rng(seed)
    perm, perms, stats = np.arange(k), [], []
    pairs = np.array([(i, i + 1) for i in range(k - 1)])
    for _ in range(n_iters):
        log_q = rng.normal(0.0, 1.0, (k, k))
        perm, acc, prop = th.neighbor_swap_scan(perm, log_q, pairs, rng.integers(k - 1, size=k**2), rng.random(k**2))
        perms.append(perm.tolist())
        stats.append(list(zip(acc.tolist(), prop.tolist())))
    return perms, stats


def test_diagnostics_equal_jax():
    """Counts, transition matrix, relaxation time, normalized KL
    divergence, cumulative acceptance rates and the samples regrouped by
    replica against JAX's on one seeded history, to 1e-12."""
    jh = _jax_hrex()
    perms, stats = _perm_history()
    d, jd = th.HREXDiagnostics(perms, stats), jh.HREXDiagnostics(perms, stats)
    np.testing.assert_array_equal(d.cumulative_replica_state_counts, jd.cumulative_replica_state_counts)
    np.testing.assert_allclose(d.transition_matrix, jd.transition_matrix, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.cumulative_swap_acceptance_rates, jd.cumulative_swap_acceptance_rates, rtol=0, atol=1e-12)
    assert d.relaxation_time == pytest.approx(jd.relaxation_time, rel=1e-12)
    assert d.normalized_kl_divergence == pytest.approx(jd.normalized_kl_divergence, rel=1e-12, abs=1e-12)
    samples = [[(t, s) for s in range(6)] for t in range(len(perms))]
    assert th.get_samples_by_iter_by_replica(samples, perms) == jh.get_samples_by_iter_by_replica(samples, perms)
    assert th.get_swap_attempts_per_iter_heuristic(4) == jh.get_swap_attempts_per_iter_heuristic(4) == 64


def test_run_hrex_gaussian_mixing():
    """Port of tests/test_hrex.py::test_run_hrex_gaussian_mixing: HREX over
    five λ-interpolated 1D Gaussians, each state resampled exactly from a
    numpy Generator, swaps by the host scan: the states mix (every pair
    accepts more than 20%, KL divergence under 0.3, relaxation time under
    50) and the transition matrix is doubly stochastic."""
    lambdas = np.linspace(0, 1, 5)
    n_states = len(lambdas)
    rng = np.random.default_rng(0)

    def mu_sigma(lam):
        return lam * 0.5, (1 - lam) * 1.0 + lam * 1.5

    def u_fn(x, lam):
        mu, sigma = mu_sigma(lam)
        return (x - mu) ** 2 / (2 * sigma**2)

    def sample_replica(replica, state_idx, n_samples):
        return rng.normal(*mu_sigma(lambdas[state_idx]), n_samples)

    def get_log_q(replicas):
        xs = np.array(replicas)
        return -np.stack([u_fn(xs, lam) for lam in lambdas], axis=1)

    samples_by_state_by_iter, diagnostics = th.run_hrex(
        replicas=[rng.normal(*mu_sigma(lam)) for lam in lambdas],
        sample_replica=sample_replica,
        replica_from_samples=lambda samples: samples[-1],
        neighbor_pairs=[(i, i + 1) for i in range(n_states - 1)],
        get_log_q=get_log_q,
        n_samples=200,
        n_samples_per_iter=1,
        seed=2023,
    )
    assert len(samples_by_state_by_iter) == 200
    assert np.all(diagnostics.cumulative_swap_acceptance_rates[-1] > 0.2)
    assert diagnostics.normalized_kl_divergence < 0.3
    assert diagnostics.relaxation_time < 50
    tm = diagnostics.transition_matrix
    np.testing.assert_allclose(tm.sum(0), 1.0, atol=1e-9)
    np.testing.assert_allclose(tm.sum(1), 1.0, atol=1e-9)


def test_neighbor_swaps_fast_matches_slow_statistics():
    """Port of tests/test_hrex.py::test_neighbor_swaps_fast_matches_slow_statistics:
    the scan and the one-move-at-a-time path (NeighborSwapMove through
    MixtureOfMoves, on a numpy Generator) give the same distribution of
    permutations over 300 trials, to 0.12 per entry."""
    n_states = 4
    log_q_kl = np.random.default_rng(1).normal(0, 1, (n_states, n_states))
    neighbor_pairs = [(i, i + 1) for i in range(n_states - 1)]
    counts_fast = np.zeros((n_states, n_states))
    counts_slow = np.zeros((n_states, n_states))
    n_trials = 300
    for t in range(n_trials):
        hrex = th.HREX.from_replicas(list(range(n_states)))
        fast, _ = hrex.attempt_neighbor_swaps_fast(neighbor_pairs, log_q_kl, 64, seed=t)
        slow, stats = hrex.attempt_neighbor_swaps(
            neighbor_pairs, lambda r, s: log_q_kl[r, s], 64, rng=np.random.default_rng(10_000 + t)
        )
        assert sum(p for _, p in stats) == 64
        for s, r in enumerate(fast.replica_idx_by_state):
            counts_fast[s, r] += 1
        for s, r in enumerate(slow.replica_idx_by_state):
            counts_slow[s, r] += 1
    np.testing.assert_allclose(counts_fast / n_trials, counts_slow / n_trials, atol=0.12)


class _Flip(MonteCarloMove):
    """Proposes x + step with log acceptance log_p."""

    def __init__(self, step, log_p, rng):
        super().__init__(rng)
        self.step, self.log_p = step, log_p

    def propose(self, x):
        return x + self.step, self.log_p


def test_moves_count_and_compose():
    """MonteCarloMove tallies its proposals and acceptances (a move with log
    p = 0 always accepts, -inf never); SequenceOfMoves applies every member
    in order; MixtureOfMoves applies one a step, drawn from its Generator,
    reproducibly."""
    rng = np.random.default_rng(0)
    always, never = _Flip(1, 0.0, rng), _Flip(100, -np.inf, rng)
    assert SequenceOfMoves([always, never]).move_n(0, 5) == 5
    assert (always.n_accepted, always.n_proposed, never.n_accepted, never.n_proposed) == (5, 5, 0, 5)
    assert always.acceptance_fraction == 1.0 and never.acceptance_fraction == 0.0

    def chain(seed):
        g = np.random.default_rng(seed)
        mix = MixtureOfMoves([_Flip(1, 0.0, g), _Flip(10, 0.0, g)], g)
        return mix.sample_chain(0, 20), mix.n_proposed_by_move

    a, props = chain(3)
    assert a == chain(3)[0] and sum(props) == 20 and all(p > 0 for p in props)
    assert a[-1] == props[0] + 10 * props[1]
