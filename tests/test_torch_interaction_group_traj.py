"""The port's fe/interaction_group_traj.py against timemachine_tpu's, on
JAX's tests/test_utils_misc.py::test_interaction_group_traj_roundtrip_and_U
system (3 frames, 4 ligand atoms, 60 environment atoms in a 4 nm box), in
float64 on the CPU.

selected_env_idxs and the kept coordinates equal JAX's exactly (the same
argpartition); U_ig within REL_TOL of JAX's largest |U|; dU/dnb_params by
autograd within REL_TOL of jax.grad's largest |entry|; the padded shell
gives the energies of the unpadded environment; the npz round trip keeps
every field and the energies bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.fe import interaction_group_traj as tig
from timemachine_tpu.fe import interaction_group_traj as jig

torch.set_num_threads(1)  # the suite's workers share the host's cores

REL_TOL = 1e-10


def _system(seed=5, n_frames=3, n_lig=4, n_env=60):
    """JAX's test's system, from its numpy seed."""
    rng = np.random.default_rng(seed)
    box_diags = np.full((n_frames, 3), 4.0)
    xs = np.concatenate(
        [2.0 + 0.3 * rng.standard_normal((n_frames, n_lig, 3)), rng.uniform(0, 4.0, (n_frames, n_env, 3))], axis=1
    )
    params = np.stack(
        [rng.uniform(-1, 1, n_lig + n_env), rng.uniform(0.1, 0.3, n_lig + n_env),
         rng.uniform(0.1, 0.5, n_lig + n_env), np.zeros(n_lig + n_env)], axis=1
    )
    return xs, box_diags, np.arange(n_lig), np.arange(n_lig, n_lig + n_env), params


@pytest.mark.parametrize("cutoff", [1.2, 0.6, 100.0])
def test_selection_matches_jax(cutoff):
    xs, box_diags, lig, env, _ = _system()
    t = tig.InteractionGroupTraj(xs, box_diags, lig, env, cutoff=cutoff, verbose=False)
    j = jig.InteractionGroupTraj(xs, box_diags, lig, env, cutoff=cutoff, verbose=False)
    np.testing.assert_array_equal(t.selected_env_idxs, j.selected_env_idxs)
    assert t.selected_env_idxs.dtype == j.selected_env_idxs.dtype == np.uint32
    np.testing.assert_array_equal(t.xs_env, j.xs_env)
    np.testing.assert_array_equal(t.xs_lig, j.xs_lig)


def test_env_mask_matches_jax():
    xs, box_diags, lig, env, _ = _system(seed=9)
    for f in range(3):
        box = np.diag(box_diags[f])
        t = tig.env_mask_within_cutoff(torch.as_tensor(xs[f, env]), torch.as_tensor(xs[f, lig]), torch.as_tensor(box), 1.2)
        j = jig.env_mask_within_cutoff(xs[f, env], xs[f, lig], box, 1.2)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [5, 6])
def test_energies_and_gradient_match_jax(seed):
    xs, box_diags, lig, env, params = _system(seed=seed)
    params[:, 3] = np.random.default_rng(seed + 100).uniform(0.0, 0.3, len(params))  # 4D offsets too
    j_traj = jig.InteractionGroupTraj(xs, box_diags, lig, env, cutoff=1.2, verbose=False)
    t_traj = tig.InteractionGroupTraj(xs, box_diags, lig, env, cutoff=1.2, verbose=False)
    j_fn = j_traj.make_U_fxn(jig.nb_pair_fxn)
    t_fn = t_traj.make_U_fxn(tig.nb_pair_fxn)
    j_u = np.asarray(j_fn(jnp.asarray(params)))
    p = torch.tensor(params, requires_grad=True)
    t_u = t_fn(p)
    assert t_u.shape == (3,) and t_u.dtype == torch.float64
    np.testing.assert_allclose(t_u.detach().numpy(), j_u, rtol=0, atol=REL_TOL * np.abs(j_u).max())
    j_g = np.asarray(jax.grad(lambda q: jnp.sum(j_fn(q)))(jnp.asarray(params)))
    (t_g,) = torch.autograd.grad(t_u.sum(), p)
    assert np.abs(j_g).max() > 0
    np.testing.assert_allclose(t_g.numpy(), j_g, rtol=0, atol=REL_TOL * np.abs(j_g).max())


def test_padding_is_energy_neutral_and_npz_round_trips(tmp_path):
    xs, box_diags, lig, env, params = _system()
    traj = tig.InteractionGroupTraj(xs, box_diags, lig, env, cutoff=1.2, verbose=False)
    full = tig.InteractionGroupTraj(xs, box_diags, lig, env, cutoff=100.0, verbose=False)
    p = torch.as_tensor(params)
    us = traj.make_U_fxn(tig.nb_pair_fxn)(p)
    assert traj.selected_env_idxs.shape[1] < full.selected_env_idxs.shape[1] == len(env)
    np.testing.assert_allclose(us.numpy(), full.make_U_fxn(tig.nb_pair_fxn)(p).numpy(), rtol=1e-12, atol=0)
    f = tmp_path / "traj.npz"
    traj.to_npz(f)
    back = tig.InteractionGroupTraj.from_npz(f)
    for name in tig._TRAJ_FIELDS:
        np.testing.assert_array_equal(getattr(back, name), getattr(traj, name))
    assert back.n_frames == 3
    assert torch.equal(back.make_U_fxn(tig.nb_pair_fxn)(p), us)
    # a JAX-written archive loads in the port
    j = jig.InteractionGroupTraj(xs, box_diags, lig, env, cutoff=1.2, verbose=False)
    j.to_npz(tmp_path / "jax.npz")
    from_jax = tig.InteractionGroupTraj.from_npz(tmp_path / "jax.npz")
    np.testing.assert_allclose(from_jax.make_U_fxn(tig.nb_pair_fxn)(p).numpy(), us.numpy(), rtol=0, atol=0)
