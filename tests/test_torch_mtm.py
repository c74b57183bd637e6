"""The port's multiple-try Metropolis moves (timemachine_torch/md/moves.py
OptimizedMTMMove, ReferenceMTMMove) on tests/test_mtm.py's targets, and
against the JAX package's acceptance probabilities.

The port draws proposals, selections and uniforms from a numpy Generator
where JAX splits jax.random keys (ROADMAP P26), so its chains are not JAX's:
they are held to the analytic Gaussian's moments as JAX's test holds JAX's.
Given the same forward and reverse proposals and the same selected index
(JAX's categorical draw from its own key, rebuilt here), both moves'
acceptance probabilities and selections equal JAX's within ACCEPT_TOL.
"""

import numpy as np
import pytest

from timemachine_torch.md import moves as tmoves
from timemachine_torch.md.moves import OptimizedMTMMove, ReferenceMTMMove
from timemachine_torch.md.states import CoordsVelBox

MU, SIG = 1.5, 0.7
STEP = 1.0  # proposal scale (deliberately mismatched to the target width)
K = 8
ACCEPT_TOL = 1e-12


def log_pi(x):
    return -0.5 * np.sum((np.asarray(x) - MU) ** 2) / SIG**2


def batch_log_pi(states):
    return np.array([log_pi(s) for s in states])


def propose_batch(x, k, rng):
    return np.asarray(x)[None] + STEP * rng.normal(size=(k,) + np.shape(x))


def batch_log_Q(states, ref):
    return np.array([-0.5 * np.sum((np.asarray(s) - np.asarray(ref)) ** 2) / STEP**2 for s in states])


def batch_log_lambda(states, ref):
    return -2.0 * batch_log_Q(states, ref) + batch_log_Q(states, ref)


def run_chain(move, n_moves, x0):
    xvb = CoordsVelBox(x0, np.zeros_like(x0), np.eye(3))
    samples = []
    for _ in range(n_moves):
        xvb = move.move(xvb)
        samples.append(float(np.asarray(xvb.coords).ravel()[0]))
    return np.asarray(samples)


def check_moments(samples, burn=200):
    s = samples[burn:]
    assert abs(s.mean() - MU) < 0.2, s.mean()
    assert abs(s.std() - SIG) < 0.2, s.std()


def test_optimized_mtm_samples_gaussian():
    move = OptimizedMTMMove(K, propose_batch, lambda states, box: batch_log_pi(states), seed=2026)
    check_moments(run_chain(move, 2500, np.full((1, 1), -2.0)))
    assert 0.05 < move.acceptance_fraction < 1.0
    assert move.n_proposed == 2500


def test_reference_mtm_matches_optimized_special_case():
    move = ReferenceMTMMove(K, propose_batch, batch_log_Q, batch_log_pi, batch_log_lambda, seed=7)
    check_moments(run_chain(move, 2500, np.full((1, 1), 4.0)))
    assert 0.05 < move.acceptance_fraction < 1.0


def test_mtm_acceptance_is_one_for_k1_symmetric_uniform_target():
    move = OptimizedMTMMove(1, propose_batch, lambda states, box: np.zeros(len(states)), seed=3)
    xvb = CoordsVelBox(np.zeros((1, 1)), np.zeros((1, 1)), np.eye(3))
    for _ in range(50):
        xvb = move.move(xvb)
    assert move.n_accepted == move.n_proposed == 50


def test_mtm_chain_is_bitwise_on_repeat():
    chains = [run_chain(OptimizedMTMMove(K, propose_batch, lambda s, box: batch_log_pi(s), seed=11), 100, np.zeros((1, 1)))
              for _ in range(2)]
    np.testing.assert_array_equal(*chains)


@pytest.mark.parametrize("kind", ["optimized", "reference"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_acceptance_probability_matches_jax_given_the_same_proposals_and_draws(kind, seed, monkeypatch):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from timemachine_tpu.md.moves import OptimizedMTMMove as JOpt
    from timemachine_tpu.md.moves import ReferenceMTMMove as JRef

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3))
    proposals = [x[None] + STEP * rng.normal(size=(K, 2, 3)), None]
    box = np.eye(3)

    def fixed(calls):
        """A proposal function handing out the forward set, then a reverse set around the selection."""

        def propose(state, k, _draws):
            calls.append(np.asarray(state))
            if len(calls) == 1:
                return proposals[0]
            if proposals[1] is None:
                proposals[1] = np.asarray(state)[None] + STEP * rng.normal(size=(k, 2, 3))
            return proposals[1]

        return propose

    j_calls, t_calls = [], []
    if kind == "optimized":
        j_move = JOpt(K, fixed(j_calls), lambda s, b: jnp.stack([log_pi(np.asarray(z)) for z in s]), seed=seed)
        t_move = OptimizedMTMMove(K, fixed(t_calls), lambda s, b: batch_log_pi(s), seed=seed)
        log_w_fwd = batch_log_pi(proposals[0])
    else:
        j_move = JRef(K, fixed(j_calls), batch_log_Q, batch_log_pi, batch_log_lambda, seed=seed)
        t_move = ReferenceMTMMove(K, fixed(t_calls), batch_log_Q, batch_log_pi, batch_log_lambda, seed=seed)
        log_w_fwd = batch_log_pi(proposals[0]) + batch_log_Q(proposals[0], x) + batch_log_lambda(proposals[0], x)
    y_j, p_j, _ = j_move.acceptance_probability(x, box, j_move.rng_key)
    # JAX's selection: its categorical draw from the third of the four keys it splits
    k_sel = jax.random.split(jax.random.key(seed), 4)[2]
    j_idx = int(jax.random.categorical(k_sel, jnp.asarray(log_w_fwd)))
    monkeypatch.setattr(tmoves, "_categorical", lambda _rng, _log_w: j_idx)
    y_t, p_t = t_move.acceptance_probability(x, box, t_move.rng)
    np.testing.assert_array_equal(y_t, np.asarray(y_j))
    np.testing.assert_array_equal(y_t, proposals[0][j_idx])
    assert 0.0 <= p_t <= 1.0 and abs(p_t - float(p_j)) <= ACCEPT_TOL
    np.testing.assert_array_equal(t_calls[1], j_calls[1])
