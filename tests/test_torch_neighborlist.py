"""The port's cell-list module (timemachine_torch/ops/neighborlist.py) held
against JAX's (timemachine_tpu/ops/neighborlist.py) on the same inputs,
made from a seed with numpy, in float64 on the CPU: the grid, the capacity,
the binning table and its overflow exactly; the energy, its gradients in
the coordinates and the parameters to 1e-12 relative, with 4-D lifted
coordinates and an atom mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.ops import neighborlist as tnl
from timemachine_torch.ops.nonbonded import nonbonded_all_pairs_dense as t_dense
from timemachine_tpu.ops import neighborlist as jnl

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF = 2.0, 1.2


def _system(seed, n, box_width, n_lifted=0):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, box_width, (n, 3))
    params = np.column_stack(
        [rng.normal(0, 1.0, n), rng.uniform(0.05, 0.2, n), rng.uniform(0.1, 0.4, n), np.zeros(n)]
    )
    params[:n_lifted, 3] = rng.uniform(0, 1.2, n_lifted)
    return conf, params, np.eye(3) * box_width


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("n,box_width", [(64, 3.0), (200, 4.8), (300, 2.3)])
def test_grid_capacity_and_cell_list_equal_jax(n, box_width):
    conf, _, box = _system(2031, n, box_width)
    grid = tnl.choose_grid(np.diagonal(box), CUTOFF)
    assert grid == jnl.choose_grid(np.diagonal(box), CUTOFF)
    assert tnl.choose_grid(np.diagonal(box), CUTOFF, padding=0.3) == jnl.choose_grid(np.diagonal(box), CUTOFF, 0.3)
    cap = tnl.choose_capacity(n, grid)
    assert cap == jnl.choose_capacity(n, grid)
    assert tnl.choose_capacity(n, grid, conf=conf, box=box) == jnl.choose_capacity(n, grid, conf=conf, box=box)
    # the fitted capacity, and one too small for the fullest cell
    for capacity in (cap, 2):
        t_table, t_cell, t_over = tnl.build_cell_list(_t(conf), _t(box), grid, capacity)
        j_table, j_cell, j_over = jnl.build_cell_list(jnp.asarray(conf), jnp.asarray(box), grid, capacity)
        np.testing.assert_array_equal(t_table.numpy(), np.asarray(j_table))
        np.testing.assert_array_equal(t_cell.numpy(), np.asarray(j_cell))
        assert int(t_over) == int(j_over)
    assert int(t_over) > 0
    t_table, _, t_over = tnl.build_cell_list(_t(conf), _t(box), grid, cap)
    entries = t_table.numpy().reshape(-1)
    assert int(t_over) == 0 and sorted(entries[entries < n].tolist()) == list(range(n))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,box_width,n_lifted", [(64, 3.0, 0), (300, 4.0, 0), (128, 4.0, 32)])
def test_cell_list_energy_and_gradients_equal_jax(n, box_width, n_lifted, masked):
    conf, params, box = _system(2032 + n, n, box_width, n_lifted)
    mask = (np.arange(n) < n // 2).astype(np.float64) if masked else None
    grid = tnl.choose_grid(np.diagonal(box), CUTOFF)
    cap = tnl.choose_capacity(n, grid)

    def j_energy(c, p):
        return jnl.nonbonded_cell_list_energy(
            c, p, jnp.asarray(box), grid, cap, BETA, CUTOFF, None if mask is None else jnp.asarray(mask)
        )[0]

    j_u = float(j_energy(jnp.asarray(conf), jnp.asarray(params)))
    j_dx, j_dp = jax.grad(j_energy, argnums=(0, 1))(jnp.asarray(conf), jnp.asarray(params))

    x, p = _t(conf).requires_grad_(), _t(params).requires_grad_()
    t_u, t_over = tnl.nonbonded_cell_list_energy(x, p, _t(box), grid, cap, BETA, CUTOFF, atom_mask=mask)
    t_dx, t_dp = torch.autograd.grad(t_u, (x, p))
    assert int(t_over) == 0
    np.testing.assert_allclose(float(t_u.detach()), j_u, rtol=1e-12)
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(j_dx), rtol=1e-12, atol=1e-12 * np.abs(j_dx).max())
    np.testing.assert_allclose(t_dp.numpy(), np.asarray(j_dp), rtol=1e-12, atol=1e-12 * np.abs(j_dp).max())

    # the tiled entry point, and the dense all-pairs energy it stands for
    tiled = tnl.nonbonded_all_pairs_tiled(_t(conf), _t(params), _t(box), BETA, CUTOFF, atom_mask=mask)
    ones = torch.ones((n, n), dtype=torch.float64)
    dense = t_dense(_t(conf), _t(params), _t(box), ones, ones, BETA, CUTOFF, atom_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(float(tiled), float(jnl.nonbonded_all_pairs_tiled(
        jnp.asarray(conf), jnp.asarray(params), jnp.asarray(box), BETA, CUTOFF,
        atom_mask=None if mask is None else jnp.asarray(mask))), rtol=1e-12)
    np.testing.assert_allclose(float(tiled), float(dense), rtol=1e-9)


def test_overflow_count_equals_jax_and_the_tiled_energy_is_nan():
    conf, params, box = _system(2035, 200, 3.6)
    grid = tnl.choose_grid(np.diagonal(box), CUTOFF)
    j_u, j_over = jnl.nonbonded_cell_list_energy(
        jnp.asarray(conf), jnp.asarray(params), jnp.asarray(box), grid, 8, BETA, CUTOFF
    )
    t_u, t_over = tnl.nonbonded_cell_list_energy(_t(conf), _t(params), _t(box), grid, 8, BETA, CUTOFF)
    assert int(t_over) == int(j_over) > 0
    np.testing.assert_allclose(float(t_u), float(j_u), rtol=1e-12)
    # JAX's tiled energy drops the overflowed atoms' pairs; the port's is NaN (ROADMAP R4)
    tiled = tnl.nonbonded_all_pairs_tiled(_t(conf), _t(params), _t(box), BETA, CUTOFF, grid_dims=grid, capacity=8)
    assert torch.isnan(tiled) and issubclass(tnl.CellListOverflow, RuntimeError)
