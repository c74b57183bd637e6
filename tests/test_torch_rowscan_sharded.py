"""The rowscan sweep over row slabs and over a mesh
(timemachine_torch/ops/rowscan_kernel.py rowscan_sweep with row_base and
n_rows_local, rowscan_sweep_sharded) on JAX's case of
tests/test_rowscan_sharded.py: 1,100 random atoms in a 3.2 nm box, Npad
1,280, 40 row chunks.

- The plain slab sweep: D = 2, 4 and 8 slabs summed against the whole
  sweep, F, F+U and U, symmetric and Newton-triangular lists, within 1e-12
  of each column's norm (float64; only the order of the column reactions'
  sums differs); a slab outside the row chunks raises ValueError.
- rowscan_sweep_sharded over 4 gloo ranks (tests/torch_mesh_ranks.py)
  against JAX's rowscan_sweep_sharded over the suite's 8 virtual devices,
  each on its own package's lists at the same geometry (JAX's float32
  values of it on both sides): the energy within
  1e-6 relative, the forces within 1e-5 of the all-pairs force's norm
  (JAX's kernel is float32, the port's plain version float64). Every rank
  returns the same output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_mesh_ranks as ranks
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.parallel.mesh import spawn_ranks

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF = 2.0, 1.2


def waterish(n_atoms, box_width, seed):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0.0, box_width, size=(n_atoms, 3))
    charges = rng.uniform(-0.8, 0.8, size=n_atoms) * np.sqrt(138.935456)
    sigmas = rng.uniform(0.05, 0.16, size=n_atoms)
    epsilons = rng.uniform(0.05, 0.9, size=n_atoms) ** 0.5
    params = np.stack([charges, sigmas, epsilons, np.zeros(n_atoms)], axis=1)
    return conf, params, np.eye(3) * box_width


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("mode", [rs.FORCE, rs.FORCE_ENERGY, rs.ENERGY])
def test_plain_slabs_sum_to_the_whole_sweep(mode, triangular):
    _, args = ranks.sweep_case(*waterish(1100, 3.2, 0), triangular)
    series = rs.es_energy_force_series(BETA, CUTOFF)
    whole = rs.rowscan_sweep(*args, series, mode, triangular)
    n_rows = args[0].shape[0] // rs.ROW
    assert n_rows == 40
    for d in (2, 4, 8):
        local = n_rows // d
        slabs = [rs.rowscan_sweep(*args, series, mode, triangular, None, True, r * local, local) for r in range(d)]
        total = sum(slabs)
        for col in range(4):
            ref = torch.linalg.vector_norm(whole[:, col])
            assert float(torch.linalg.vector_norm(total[:, col] - whole[:, col])) <= 1e-12 * float(ref), (d, col)
        # a slab's own rows hold its row sums: the energy column is zero outside it
        if mode != rs.FORCE:
            assert not slabs[0][local * rs.ROW :, 0].any()
    assert whole.abs().sum() > 0


def test_a_slab_outside_the_rows_raises():
    _, args = ranks.sweep_case(*waterish(1100, 3.2, 0), True)
    series = rs.es_energy_force_series(BETA, CUTOFF)
    for base, local in ((-1, 5), (36, 5), (0, 0), (3, None)):
        with pytest.raises(ValueError):
            rs.rowscan_sweep(*args, series, rs.FORCE, True, None, True, base, local)


def test_sharded_sweep_on_four_ranks_matches_jax(tmp_path):
    from timemachine_tpu.ops.pallas.rowscan_kernel import (
        _assemble,
        _scalars,
        build_rowscan_tiles,
        es_energy_force_series,
        rowscan_sweep_sharded,
        suggest_max_pairs,
    )
    from timemachine_tpu.parallel.replica_exchange import make_replica_mesh

    # JAX's run takes float32 values: the port takes the same values in float64
    conf, params, box = (np.float32(a).astype(np.float64) for a in waterish(1100, 3.2, 0))
    np.savez(tmp_path / "case.npz", conf=conf, params=params, box=box, beta=BETA, cutoff=CUTOFF)
    spawn_ranks(ranks.rowscan_sharded_rank, 4, (str(tmp_path / "case.npz"), str(tmp_path)), store_dir=str(tmp_path))
    port = [ranks.load(tmp_path, "sharded", r) for r in range(4)]
    mesh = make_replica_mesh(__import__("jax").devices()[:8], axis_name="rows")
    h, p = es_energy_force_series(BETA, CUTOFF)
    c32, p32, b32 = (jnp.asarray(a, jnp.float32) for a in (conf, params, box))
    for triangular in (False, True):
        mp = suggest_max_pairs(np.asarray(c32), np.asarray(b32), CUTOFF, triangular=triangular)
        pad_order, row_start, row_count, col_ids, overflow = build_rowscan_tiles(
            c32, p32, b32, CUTOFF, max_pairs=mp, triangular=triangular
        )
        assert int(overflow) == 0
        atoms8 = _assemble(c32, p32, b32, pad_order, len(conf))
        ref = np.asarray(rowscan_sweep_sharded(
            atoms8, atoms8.T, row_start, row_count, col_ids, _scalars(b32, CUTOFF), n_rows=atoms8.shape[1] // 32,
            h_coeffs=h, p_coeffs=p, mesh=mesh, axis_name="rows", compute_u=True, interpret=True, triangular=triangular,
        ))
        # each package's sorted order: compare per atom
        tiles, _ = ranks.sweep_case(conf, params, box, triangular)
        out = port[0][f"tri{int(triangular)}"]
        for r in range(1, 4):
            np.testing.assert_array_equal(port[r][f"tri{int(triangular)}"], out)
        n = len(conf)
        f_port = np.zeros((n, 3))
        f_port[tiles.pad_order[:n].numpy()] = out[:n, 1:4]
        f_jax = np.zeros((n, 3))
        f_jax[np.asarray(pad_order)[:n]] = ref[:n, 1:4]
        assert float(out[:, 0].sum()) == pytest.approx(float(ref[:, 0].sum()), rel=1e-6)
        assert np.linalg.norm(f_port - f_jax) <= 1e-5 * np.linalg.norm(f_port)
