"""HREX over a bare u_fn on a mesh (timemachine_torch/parallel/
hrex_sharded.py) on JAX's harmonic ladder (tests/test_hrex.py
test_run_hrex_sharded_harmonic): K = 8 wells of 4 atoms, k from 1,000 to
3,000, 150 iterations of 40 steps, K^3 swap attempts an iteration, float64
on the CPU. One rank is mesh=None in this process; four are 4 gloo
processes (tests/torch_mesh_ranks.py).

- At one rank and at four: a swap rate above 0.2, every state visited by
  at least K / 2 replicas, and MBAR's f_k over the emitted log_q within
  0.35 of the exact (3N / 2) log(k_k / k_0), JAX's bounds.
- Four ranks against one: identical permutations, accepted and proposed
  counts, and frames and log_q within 1e-12 (the noise is drawn whole on
  every rank and sliced, so they are the same numbers).
- At friction 0 with no swap attempts the noise and the swaps drop out:
  frames within 1e-10 of JAX's run_hrex_sharded with and without its mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_mesh_ranks as ranks
from timemachine_torch.fe.mbar import MBAR
from timemachine_torch.parallel.mesh import spawn_ranks
from timemachine_tpu.parallel.hrex_sharded import make_replica_mesh as jax_mesh
from timemachine_tpu.parallel.hrex_sharded import run_hrex_sharded as jax_hrex

torch.set_num_threads(1)  # the suite's workers share the host's cores

K_STATES, N_ATOMS = 8, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hrex")
    spawn_ranks(ranks.hrex_rank, 4, (str(d),), store_dir=str(d))
    return dict(
        one=ranks.hrex_arrays(ranks.harmonic_hrex(None)),
        one_f0=ranks.hrex_arrays(ranks.harmonic_hrex(None, friction=0.0, n_iters=3, n_attempts=0)),
        four=[ranks.load(d, "hrex", r) for r in range(4)],
        four_f0=ranks.load(d, "hrex_f0", 0),
    )


def _check_ladder(res):
    assert res["frames"].shape == (150, K_STATES, N_ATOMS, 3)
    assert res["accepted_by_pair_by_iter"].sum() / res["proposed_by_pair_by_iter"].sum() > 0.2
    perms = res["replica_idx_by_state_by_iter"]
    visits = np.array([len(set(perms[:, s].tolist())) for s in range(K_STATES)])
    assert np.all(visits >= K_STATES // 2)
    burn = 50
    u_rk = -res["log_q_kl_by_iter"][burn:]
    samples_by_state = [[] for _ in range(K_STATES)]
    for t in range(u_rk.shape[0]):
        state_of_replica = np.argsort(perms[burn + t])
        for r in range(K_STATES):
            samples_by_state[state_of_replica[r]].append(u_rk[t, r, :])
    n_k = np.array([len(s) for s in samples_by_state])
    u_kn = np.concatenate([np.array(s) for s in samples_by_state]).T
    mbar = MBAR(u_kn, n_k)
    spring_ks = np.linspace(1000.0, 3000.0, K_STATES)
    exact_f = 1.5 * N_ATOMS * np.log(spring_ks / spring_ks[0])
    np.testing.assert_allclose(mbar.f_k - mbar.f_k[0], exact_f, atol=0.35)


@pytest.mark.parametrize("n_ranks", [1, 4])
def test_harmonic_ladder_mixes_and_recovers_free_energies(runs, n_ranks):
    _check_ladder(runs["one"] if n_ranks == 1 else runs["four"][0])


def test_four_ranks_are_the_one_rank_run(runs):
    one, four = runs["one"], runs["four"]
    for r in range(4):
        for key in ("replica_idx_by_state_by_iter", "accepted_by_pair_by_iter", "proposed_by_pair_by_iter"):
            np.testing.assert_array_equal(four[r][key], one[key], err_msg=key)
        for key in ("frames", "log_q_kl_by_iter", "final_coords", "final_velocities", "final_boxes"):
            np.testing.assert_allclose(four[r][key], one[key], rtol=0, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("use_mesh", [False, True])
def test_friction_zero_matches_jax(runs, use_mesh):
    """Nose-free, swap-free dynamics from the same start: the port's frames
    at one and four ranks against JAX's, with and without its 8-device mesh."""
    rng = np.random.default_rng(0)
    from timemachine_tpu.constants import BOLTZ

    spring_ks = np.linspace(1000.0, 3000.0, K_STATES)
    xs0 = rng.normal(0, np.sqrt(BOLTZ * 300.0 / spring_ks)[:, None, None], (K_STATES, N_ATOMS, 3))
    vs0 = rng.normal(0, 0.5, xs0.shape)
    res = jax_hrex(
        lambda x, box, p: 0.5 * p[0] * jnp.sum(x**2), spring_ks[:, None], xs0, vs0,
        np.tile(np.eye(3) * 100.0, (K_STATES, 1, 1)), np.full(N_ATOMS, 12.0), temperature=300.0, dt=2e-3, friction=0.0,
        n_iters=3, steps_per_iter=40, neighbor_pairs=np.array([(i, i + 1) for i in range(K_STATES - 1)]),
        n_swap_attempts_per_iter=0, seed=2024, mesh=jax_mesh() if use_mesh else None,
    )
    if use_mesh:
        assert len(jax.devices()) == 8
    for port in (runs["one_f0"], runs["four_f0"]):
        assert np.abs(port["frames"][-1] - xs0).max() > 1e-3  # it moved
        np.testing.assert_allclose(port["frames"], res.frames, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(port["replica_idx_by_state_by_iter"], np.tile(np.arange(K_STATES), (3, 1)))
