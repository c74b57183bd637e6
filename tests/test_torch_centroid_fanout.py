"""The port's CentroidRestraint and FanoutSummedPotential
(timemachine_torch/potentials.py, ops/bonded.py) against timemachine_tpu's,
carried across by convert.modules_from_bound_potentials, in float64 on the
CPU, on coordinates made from a numpy seed.

Tolerances: energies, the closed-form force, autograd's dU/dx and dU/dp
each to 1e-10 of their largest magnitude.
"""

import jax
import numpy as np
import pytest
import torch

from timemachine_torch import potentials as tp
from timemachine_torch.convert import modules_from_bound_potentials

torch.set_num_threads(1)  # the suite's workers share the host's cores

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
TOL = 1e-10
N = 40


def _coords(seed=0):
    return np.random.default_rng(seed).uniform(0.0, 2.0, (N, 3))


def _box():
    return np.eye(3) * 3.0


def _jax_u_and_grads(bp, x, box):
    import jax.numpy as jnp

    def u(xx, pp):
        return bp.potential(xx, pp, jnp.asarray(box))

    val, (gx, gp) = jax.value_and_grad(u, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(bp.params))
    return float(val), np.asarray(gx), np.asarray(gp)


def _port_u_and_grads(mod, x, box):
    xt = torch.tensor(x, requires_grad=True)
    p = mod.params.clone().requires_grad_(True)
    u = mod.u(xt, p, torch.as_tensor(box))
    gx, gp = torch.autograd.grad(u, (xt, p), allow_unused=True)
    u_f, f = mod.energy_force(torch.as_tensor(x), torch.as_tensor(box))
    return float(u.detach()), gx.numpy(), (torch.zeros_like(p) if gp is None else gp).numpy(), float(u_f), f.numpy()


def _close(a, b):
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("b0", [0.0, 0.5])
def test_centroid_restraint_matches_jax(b0):
    import timemachine_tpu.potentials as jp

    x = _coords(1)
    a, b = np.arange(0, 10, dtype=np.int32), np.arange(25, 40, dtype=np.int32)
    bp = jp.CentroidRestraint(a, b, kb=200.0, b0=b0).bind(np.zeros(0))
    (mod,) = modules_from_bound_potentials([bp], N, CPU)
    assert isinstance(mod, tp.CentroidRestraint)
    u_j, gx_j, _ = _jax_u_and_grads(bp, x, _box())
    u_t, gx_t, _, u_f, f = _port_u_and_grads(mod, x, _box())
    assert abs(u_t - u_j) <= TOL * abs(u_j) and abs(u_f - u_j) <= TOL * abs(u_j)
    _close(gx_t, gx_j)
    _close(-f, gx_j)
    assert np.abs(gx_j).max() > 0


def test_centroid_restraint_at_coincident_centroids():
    """Both groups' centroids on one point: U = kb b0^2 and no force, as
    JAX's guarded sqrt gives."""
    import timemachine_tpu.potentials as jp

    x = _coords(2)
    x[20:30] = x[0:10]  # identical groups
    a, b = np.arange(0, 10, dtype=np.int32), np.arange(20, 30, dtype=np.int32)
    for b0 in (0.0, 0.3):
        bp = jp.CentroidRestraint(a, b, kb=50.0, b0=b0).bind(np.zeros(0))
        (mod,) = modules_from_bound_potentials([bp], N, CPU)
        u_j, gx_j, _ = _jax_u_and_grads(bp, x, _box())
        u_t, gx_t, _, u_f, f = _port_u_and_grads(mod, x, _box())
        assert u_t == pytest.approx(50.0 * b0**2, abs=1e-12) and u_f == u_t
        assert u_j == pytest.approx(u_t, abs=1e-12)
        np.testing.assert_array_equal(gx_t, 0.0)
        np.testing.assert_array_equal(f, 0.0)
        np.testing.assert_array_equal(gx_j, 0.0)


def test_centroid_restraint_refuses_bad_groups():
    with pytest.raises(ValueError):
        tp.CentroidRestraint([], [1], 1.0, 0.0, np.zeros(0), N, device=CPU)
    with pytest.raises(ValueError):
        tp.CentroidRestraint([0], [N], 1.0, 0.0, np.zeros(0), N, device=CPU)


def _fanout_bp():
    import timemachine_tpu.potentials as jp

    rng = np.random.default_rng(3)
    bonds_1 = rng.choice(N, (6, 2), replace=False).astype(np.int32)
    bonds_2 = rng.choice(N, (6, 2), replace=False).astype(np.int32)
    params = np.stack([rng.uniform(100, 500, 6), rng.uniform(0.1, 0.3, 6)], 1)
    members = [
        jp.HarmonicBond(bonds_1),
        jp.HarmonicBond(bonds_2),
        jp.CentroidRestraint(np.arange(5, dtype=np.int32), np.arange(30, 36, dtype=np.int32), kb=80.0, b0=0.4),
    ]
    return jp.FanoutSummedPotential(members).bind(params)


def test_fanout_summed_potential_matches_jax():
    """Three members on one parameter array: energy, force and dU/dp."""
    bp = _fanout_bp()
    x = _coords(4)
    (mod,) = modules_from_bound_potentials([bp], N, CPU)
    assert isinstance(mod, tp.FanoutSummedPotential) and len(mod.members) == 3
    assert not mod.rigid_group_invariant  # the centroid restraint spans groups
    u_j, gx_j, gp_j = _jax_u_and_grads(bp, x, _box())
    u_t, gx_t, gp_t, u_f, f = _port_u_and_grads(mod, x, _box())
    assert abs(u_t - u_j) <= TOL * abs(u_j) and abs(u_f - u_j) <= TOL * abs(u_j)
    _close(gx_t, gx_j)
    _close(-f, gx_j)
    _close(gp_t, gp_j)
    # the sum of its members at the shared parameters
    members = sum(float(m.energy(torch.as_tensor(x), torch.as_tensor(_box()))) for m in mod.members)
    assert members == pytest.approx(u_t, rel=1e-14)
