"""timemachine_torch ops against timemachine_tpu: the electrostatics series,
the tile builder, the rowscan sweep's plain PyTorch version, the dense
oracle, and the small helpers (pbc, fixed-order segment sums).

Inputs are made with numpy from a seed and handed to both packages. The
JAX sweep runs as its own tests run it on the CPU: Pallas in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.ops import nonbonded as tnb
from timemachine_torch.ops import pbc as tpbc
from timemachine_torch.ops import rowscan_kernel as trs
from timemachine_torch.ops.segment import SegmentSum
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.ops import nonbonded as jnb
from timemachine_tpu.ops import pbc as jpbc
from timemachine_tpu.ops.pallas import rowscan_kernel as jrs

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF = 2.0, 1.2


@pytest.fixture(scope="module")
def water():
    """3.0 nm TIP3P box (2,697 atoms): the smallest box whose half-width
    exceeds cutoff + skin. w offsets in [0, 0.3) exercise the 4D lift."""
    cfg = build_water_system(3.0)
    rng = np.random.default_rng(7)
    params = np.asarray(cfg.host_system.nonbonded_all_pairs.params, np.float64).copy()
    params[:, 3] = rng.uniform(0.0, 0.3, len(params))
    return np.asarray(cfg.conf, np.float64), params, np.asarray(cfg.box, np.float64)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)  # a copy: JAX arrays read as read-only numpy


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_es_series_equals_jax():
    """The port carries its own copy of the numpy/scipy fit: coefficients
    must be bitwise equal, at the production and at another (beta, cutoff)."""
    for beta, cutoff in ((2.0, 1.2), (2.5, 1.0)):
        assert trs.es_energy_force_series(beta, cutoff) == jrs.es_energy_force_series(beta, cutoff)


@pytest.mark.parametrize("cutoff,cell", [(1.2, 0.65), (1.3, 0.65), (1.3, 1.15)])
def test_tile_builder_matches_jax(water, cutoff, cell):
    """Same snake sort (pad_order bitwise equal) and the same column-chunk
    set for every row chunk as JAX's symmetric (triangular=False) builder."""
    conf, params, box = water
    n_pad = trs.padded_size(len(conf))
    cap = (n_pad // 32) * (n_pad // 128 + 4)
    j_pad, j_start, j_count, j_cols, j_rank, j_over = jrs.build_rowscan_tiles(
        jnp.asarray(conf, jnp.float32), jnp.asarray(params, jnp.float32), jnp.asarray(box, jnp.float32),
        cutoff, max_pairs=cap, cell_size=cell, triangular=False, with_ranks=True,
    )
    t = trs.build_rowscan_tiles(_t(conf, torch.float32), _t(box, torch.float32), cutoff, cap, cell)
    np.testing.assert_array_equal(t.pad_order.numpy(), np.asarray(j_pad))
    assert int(t.overflow) == 0 and int(j_over) == 0
    j_start, j_count, j_cols = np.asarray(j_start), np.asarray(j_count), np.asarray(j_cols)
    for r in range(len(j_start)):
        j_set = set(j_cols[j_start[r] : j_start[r] + j_count[r]].tolist())
        s, c = int(t.row_start[r]), int(t.row_count[r])
        assert set(t.col_ids[s : s + c].tolist()) == j_set
        assert set(np.nonzero(t.rank_mat[r].numpy() >= 0)[0].tolist()) == j_set
    # lists are gap-ascending: rank k sits at row_start + k
    r = int(torch.argmax(t.row_count))
    ranks = t.rank_mat[r, t.col_ids[int(t.row_start[r]) : int(t.row_start[r]) + int(t.row_count[r])].long()]
    np.testing.assert_array_equal(ranks.numpy(), np.arange(int(t.row_count[r])))


@pytest.fixture(scope="module")
def jax_tiles(water):
    conf, params, box = water
    c32, p32, b32 = (jnp.asarray(a, jnp.float32) for a in (conf, params, box))
    n_pad = trs.padded_size(len(conf))
    cap = (n_pad // 32) * (n_pad // 128 + 4)
    pad_order, row_start, row_count, cols, _ = jrs.build_rowscan_tiles(c32, p32, b32, CUTOFF, max_pairs=cap, triangular=False)
    atoms8 = jrs._assemble(c32, p32, b32, pad_order, len(conf))
    return atoms8, row_start, row_count, cols, jrs._scalars(b32, CUTOFF), cap


@pytest.mark.parametrize("mode", [trs.FORCE, trs.FORCE_ENERGY, trs.ENERGY])
def test_plain_sweep_matches_jax_kernel(jax_tiles, mode):
    """The plain sweep (f32) against the Pallas kernel (interpret mode) on the
    same tiles and rows. Both are f32 over the same pairs in different
    summation orders: per-atom gradients and energies agree to 1e-5 in
    relative norm (measured 2.8e-7 and 2.3e-7)."""
    atoms8, row_start, row_count, cols, scalars, cap = jax_tiles
    h, p = jrs.es_energy_force_series(BETA, CUTOFF)
    compute_u = {trs.FORCE: False, trs.FORCE_ENERGY: True, trs.ENERGY: "u_only"}[mode]
    ref = np.asarray(
        jrs.rowscan_sweep(
            atoms8, atoms8.T, row_start, row_count, cols, scalars, n_rows=atoms8.shape[1] // 32, max_pairs=cap,
            h_coeffs=h, p_coeffs=p, compute_u=compute_u, interpret=True, triangular=False,
        )
    )
    i32 = dict(dtype=torch.int32)
    out = trs.rowscan_sweep(
        _t(np.asarray(atoms8).T, torch.float32).contiguous(), _t(row_start, **i32), _t(row_count, **i32),
        _t(cols, **i32), _t(np.asarray(scalars)[0, :4], torch.float32), (h, p), mode,
    ).numpy()
    if mode != trs.ENERGY:
        assert _rel(out[:, 1:4], ref[:, 1:4]) < 1e-5
    else:
        assert not out[:, 1:4].any()
    if mode != trs.FORCE:
        assert _rel(out[:, 0], ref[:, 0]) < 1e-5
    else:
        assert not out[:, 0].any()


def _port_all_pairs(conf, params, box, dtype, mode=trs.FORCE_ENERGY):
    ef = trs.make_nonbonded_rowscan_energy_force(BETA, CUTOFF, max_pairs=10**6)
    u, f = ef(_t(conf, dtype), _t(params, dtype), _t(box, dtype), mode)
    return float(u), f.numpy()


def test_plain_sweep_f64_matches_jax_dense(water):
    """In f64 the sweep differs from JAX's dense exact-erfc all-pairs energy
    only by the deg-10 fit of the switched erfc (max |h - h_fit| = 1.5e-5 at
    r = 1.2 nm): measured 8.2e-6 of the energy scale sum |u_i| and 7.2e-5 of
    the force norm; tolerances 3e-5 and 3e-4."""
    conf, params, box = water
    import jax

    u_ref, g_ref = jax.value_and_grad(
        lambda c: jnb.nonbonded_all_pairs_dense(
            c, jnp.asarray(params), jnp.asarray(box), 1.0, 1.0, BETA, CUTOFF
        )
    )(jnp.asarray(conf))
    u, f = _port_all_pairs(conf, params, box, torch.float64)
    scale = np.abs(_per_atom_u(conf, params, box)).sum()
    assert abs(u - float(u_ref)) / scale < 3e-5
    assert _rel(f, -np.asarray(g_ref)) < 3e-4


def _per_atom_u(conf, params, box):
    tiles = trs.build_rowscan_tiles(_t(conf), _t(box), CUTOFF, 10**6)
    atoms = trs.assemble_atoms(_t(conf), _t(box), tiles.pad_order, trs.param_rows(_t(params), tiles.pad_order, len(conf)))
    out = trs.rowscan_sweep(
        atoms, tiles.row_start, tiles.row_count, tiles.col_ids, trs.sweep_scalars(_t(box), CUTOFF),
        trs.es_energy_force_series(BETA, CUTOFF), trs.ENERGY,
    )
    return out[:, 0].numpy()


def test_dense_oracle_matches_jax(water):
    """The port's dense oracle is the same f64 function as JAX's (1e-12)."""
    conf, params, box = water
    conf, params = conf[:900], params[:900]
    u_ref = float(jnb.nonbonded_all_pairs_dense(jnp.asarray(conf), jnp.asarray(params), jnp.asarray(box), 1.0, 1.0, BETA, CUTOFF))
    u = float(tnb.nonbonded_all_pairs_dense(_t(conf), _t(params), _t(box), None, None, BETA, CUTOFF))
    assert u == pytest.approx(u_ref, rel=1e-12)


def test_energy_mode_matches_force_energy_mode(water):
    """ENERGY, FORCE and FORCE_ENERGY are one function: U-only energies and
    F-only gradients equal the combined mode's bitwise."""
    conf, params, box = water
    u_fu, f_fu = _port_all_pairs(conf, params, box, torch.float32)
    u_u, f_u = _port_all_pairs(conf, params, box, torch.float32, trs.ENERGY)
    _, f_f = _port_all_pairs(conf, params, box, torch.float32, trs.FORCE)
    assert u_u == u_fu and not f_u.any()
    np.testing.assert_array_equal(f_f, f_fu)


def test_pbc_matches_jax(rng):
    a, b = rng.uniform(-4, 4, (50, 3)), rng.uniform(-4, 4, (50, 3))
    box = np.diag([2.1, 2.5, 3.3])
    w = rng.uniform(0, 1, 50)
    np.testing.assert_allclose(tpbc.periodic_delta(_t(a), _t(b), _t(box)).numpy(), np.asarray(jpbc.periodic_delta(a, b, box)), atol=1e-14)
    np.testing.assert_allclose(tpbc.distance(_t(a), _t(b), _t(box)).numpy(), np.asarray(jpbc.distance(a, b, box)), rtol=1e-14)
    np.testing.assert_allclose(
        tpbc.lifted_distance_on_pairs(_t(a), _t(b), _t(box), _t(w)).numpy(),
        np.asarray(jpbc.lifted_distance_on_pairs(a, b, box, w)), rtol=1e-14,
    )


@pytest.mark.parametrize("width", [1, 4, 32])
def test_segment_sum_matches_numpy_and_is_reproducible(rng, width):
    """Fixed-order segment sums equal np.add.at to rounding, with empty
    segments, one segment wider than `width`, and repeat calls bitwise
    equal."""
    seg = np.concatenate([rng.integers(0, 40, 300), np.full(100, 41)])
    src = rng.normal(size=(len(seg), 3))
    ref = np.zeros((45, 3))
    np.add.at(ref, seg, src)
    ss = SegmentSum(seg, 45, device="cpu", width=width)
    out = ss(_t(src))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    assert torch.equal(out, ss(_t(src)))
