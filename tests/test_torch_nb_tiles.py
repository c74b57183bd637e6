"""timemachine_torch block-tile sweep against timemachine_tpu's v1 tile
kernel: the tile builder (symmetric, and the Newton-triangular subset),
nb_tiles_plain in both forms against both Pallas entry points (interpret
mode) in every mode, the kernel's sub-tile cull, NaN on list overflow, the
exact-erfc exclusion functions, and the kernel="v1" energy/force and MD
provider (triangular lists).

The sweeps are f32 on both sides and sum each atom's pairs in different
orders: per-atom outputs agree to a relative norm of 1e-5 per column
(measured 2e-7 to 7e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.ops import nonbonded as tnb
from timemachine_torch.ops import nonbonded_kernel as nbk
from timemachine_torch.potentials import NonbondedAllPairs
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.ops import nonbonded as jnb
from timemachine_tpu.ops.pallas import nonbonded_kernel as jnk

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF = 2.0, 1.2
TOL_COL = 1e-5


@pytest.fixture(scope="module")
def water():
    return build_water_system(2.4)


def _arrays(cfg, w_seed=None):
    conf = np.asarray(cfg.conf, np.float32)
    params = np.array(cfg.host_system.nonbonded_all_pairs.params, np.float32)
    if w_seed is not None:  # nonzero 4D offsets exercise the dw terms
        params[:, 3] = np.random.default_rng(w_seed).uniform(0.0, 0.1, len(params)).astype(np.float32)
    return conf, params, np.asarray(cfg.box, np.float32)


def _tile_set(tiles):
    starts, counts, cols = tiles.row_start.tolist(), tiles.row_count.tolist(), tiles.col_ids.tolist()
    return {(r, cols[s + k]) for r, (s, c) in enumerate(zip(starts, counts)) for k in range(c)}


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("cb,cutoff", [(1, 1.0), (2, 1.2)])
def test_block_tile_set_matches_jax(cb, cutoff, triangular):
    """Same sort, same atom rows and the same set of tiles as the JAX
    build_block_tiles, in a box large enough to cull tiles (triangular:
    JAX's set filtered to the super-blocks that reach the row block's
    diagonal, c cb + cb - 1 >= r); the same overflow count when the budget
    is short, and suggest_max_tiles from the same count."""
    conf, params, box = _arrays(build_water_system(3.4))
    n = len(conf)
    n_blocks = -(-n // (128 * cb)) * cb
    full = n_blocks * (n_blocks // cb)
    args = (jnp.asarray(conf), jnp.asarray(params), jnp.asarray(box), cutoff)
    atom_data, pad_order, row_ids, col_ids, valid, _ = map(np.asarray, jnk.build_block_tiles(*args, max_tiles=full, cb=cb))
    targs = (torch.as_tensor(conf), torch.as_tensor(params), torch.as_tensor(box), cutoff)
    tiles = nbk.build_block_tiles(*targs, full, cb, triangular)
    want = {(r, c) for r, c in zip(row_ids[valid > 0].tolist(), col_ids[valid > 0].tolist())
            if not triangular or c * cb + cb - 1 >= r}
    assert _tile_set(tiles) == want and len(want) < full
    assert all((r, r // cb) in want for r in range(n_blocks))
    np.testing.assert_array_equal(tiles.pad_order[:n].numpy(), pad_order[:n])
    np.testing.assert_array_equal(tiles.atoms[:n].numpy(), atom_data[:, :n].T)
    assert not tiles.atoms[n:].any()
    short = len(want) // 2
    t_over = nbk.build_block_tiles(*targs, short, cb, triangular)
    assert int(t_over.overflow) == len(want) - short
    assert int(t_over.row_count.sum()) == short
    if not triangular:
        assert int(jnk.build_block_tiles(*args, max_tiles=short, cb=cb)[-1]) == len(want) - short
        assert nbk.suggest_max_tiles(conf, box, cutoff, cb=cb) == jnk.suggest_max_tiles(conf, box, cutoff, cb=cb)
    else:
        assert nbk.suggest_max_tiles(conf, box, cutoff, cb=cb, triangular=True) == min(-(-len(want) * 13 // 1280) * 128, full)


def test_es_switch_poly_coeffs_equal_jax():
    assert nbk.es_switch_poly_coeffs(BETA, CUTOFF) == jnk.es_switch_poly_coeffs(BETA, CUTOFF)


@pytest.fixture(scope="module")
def sweep_inputs(water):
    conf, params, box = _arrays(water, w_seed=0)
    cb = 2
    max_tiles = nbk.suggest_max_tiles(conf, box, CUTOFF, cb=cb)
    tiles = nbk.build_block_tiles(torch.as_tensor(conf), torch.as_tensor(params), torch.as_tensor(box), CUTOFF, max_tiles, cb)
    # the flat JAX list: CSR rows in order, invalid tail parked on the last row
    rows = np.repeat(np.arange(len(tiles.row_start)), tiles.row_count.numpy())
    cols = np.array([c for r, c in sorted(_tile_set(tiles))], np.int32)
    n_tail = max_tiles - len(rows)
    flat = (
        jnp.asarray(np.concatenate([rows, np.full(n_tail, len(tiles.row_start) - 1)]), jnp.int32),
        jnp.asarray(np.concatenate([cols, np.zeros(n_tail)]), jnp.int32),
        jnp.asarray(np.arange(max_tiles) < len(rows), jnp.int32),
    )
    scal = np.zeros((1, 8), np.float32)
    scal[0, :5] = [*np.diag(box), BETA, CUTOFF]
    tri = nbk.build_block_tiles(
        torch.as_tensor(conf), torch.as_tensor(params), torch.as_tensor(box), CUTOFF, max_tiles, cb, triangular=True
    )
    return tiles, flat, jnp.asarray(scal), nbk.tile_scalars(torch.as_tensor(box), BETA, CUTOFF), max_tiles, cb, tri


MODES = {
    "DP": (nbk.DP, False),
    "UF-exact": (nbk.UF, False),
    "UF-poly": (nbk.UF, True),
    "F": (nbk.FORCE, False),
}


@pytest.mark.parametrize("form", ["symmetric", "triangular"])
@pytest.mark.parametrize("entry", ["nb_tiles_fused", "nb_tiles_fused_vmem"])
@pytest.mark.parametrize("mode_name", list(MODES))
def test_plain_matches_pallas(sweep_inputs, mode_name, entry, form):
    """nb_tiles_plain against the Pallas kernel run in interpret mode on the
    same sorted rows and JAX's symmetric tiles, column by column (tolerance
    TOL_COL); the triangular form on its own lists of the same sort, where
    the per-atom energies are not JAX's halves and only their sum is
    compared, relative to sum |u_i|."""
    tiles, (rows, cols, valid), scal, scal_t, max_tiles, cb, tri = sweep_inputs
    mode, poly = MODES[mode_name]
    es = nbk.es_switch_poly_coeffs(BETA, CUTOFF) if poly else None
    ref = np.asarray(getattr(jnk, entry)(
        jnp.asarray(tiles.atoms.numpy().T), rows, cols, valid, scal, max_tiles, compute_dp=mode == nbk.DP,
        interpret=True, es_coeffs=es, cb=cb, compute_u=mode != nbk.FORCE,
    ))
    ref = (ref[4:8] if mode == nbk.DP else ref[0:4]).T
    t = tri if form == "triangular" else tiles
    out = nbk.nb_tiles(t.atoms, t.row_start, t.row_count, t.col_ids, scal_t, mode, cb, es, form == "triangular").numpy()
    for col in range(4):
        norm = np.linalg.norm(ref[:, col])
        if norm == 0:  # F mode's energy column
            assert not out[:, col].any()
        elif col == 0 and mode == nbk.UF and form == "triangular":
            assert abs(out[:, 0].sum(dtype=np.float64) - ref[:, 0].sum(dtype=np.float64)) / np.abs(ref[:, 0]).sum() < TOL_COL
        else:
            assert np.linalg.norm(out[:, col] - ref[:, col]) / norm < TOL_COL, col


@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_subtile_cull_never_drops_a_pair(jitter):
    """The kernel's culls (subtile_boxes, subtile_near) keep every pair of
    32-atom groups that holds a pair within the cutoff, and every column
    atom within the cutoff of some atom of the row group, on the 3.4 nm
    water box's sorted rows, and again after 0.02 nm of random jitter that
    puts atoms across box faces (the rows keep the build's sort and each
    group's box is taken at its atoms' images nearest its first atom);
    cull_census counts the slots each cull keeps on the triangular lists."""
    conf, params, box = _arrays(build_water_system(3.4))
    conf_t, box_t = torch.as_tensor(conf), torch.as_tensor(box)
    tiles = nbk.build_block_tiles(conf_t, torch.as_tensor(params), box_t, CUTOFF, 10**4, 2, triangular=True)
    moved = conf_t + torch.as_tensor(np.random.default_rng(5).normal(0.0, jitter, conf.shape), dtype=torch.float32)
    atoms = nbk.assemble_atoms(moved, box_t, tiles.pad_order, tiles.atoms[:, 3:])
    box_diag = torch.diagonal(box_t)
    n = len(conf)
    x = atoms[:n, :3].double()
    d = x[:, None, :] - x[None, :, :]
    d = d - box_diag.double() * torch.round(d / box_diag.double())
    i, j = torch.nonzero(torch.sum(d * d, dim=2) < CUTOFF**2, as_tuple=True)
    center, half = nbk.subtile_boxes(atoms, box_diag)
    gi, gj = i // nbk.GROUP, j // nbk.GROUP
    assert len(i) > 0 and bool(nbk.subtile_near((center[gi], half[gi]), (center[gj], half[gj]), box_diag, CUTOFF).all())
    point = (atoms[j, :3], torch.zeros_like(atoms[j, :3]))  # the column cull: each atom against the other's group box
    assert bool(nbk.subtile_near((center[gi], half[gi]), point, box_diag, CUTOFF).all())
    if jitter:  # the jitter put atoms across faces, so wrapped boxes would stretch
        crossed = torch.floor(moved / box_diag) != torch.floor(conf_t / box_diag)
        assert bool(crossed.any())
    all_groups = torch.arange(len(center))
    near = nbk.subtile_near((center[:, None], half[:, None]), (center[None], half[None]), box_diag, CUTOFF)
    assert int(near.sum()) < len(all_groups) ** 2  # the cull drops something here
    c = nbk.cull_census(atoms, tiles.row_start, tiles.row_count, tiles.col_ids, box_t, CUTOFF, 2)
    assert 0 < c.columns <= c.swept <= c.subtiles < c.upper <= c.listed == int(tiles.row_count.sum()) * 128 * 256


def test_plain_uf_matches_dense_oracle(water):
    """f64: the exact form against the port's dense oracle, which uses
    torch's erfc where the sweep uses A&S 7.1.26 (abs error 1.5e-7): energy
    to 1e-6 relative, forces to 1e-5 of their norm."""
    conf, params, box = (torch.as_tensor(a, dtype=torch.float64) for a in _arrays(water, w_seed=1))
    x = conf.clone().requires_grad_(True)
    u_ref = tnb.nonbonded_all_pairs_dense(x, params, box, BETA, CUTOFF)
    (g_ref,) = torch.autograd.grad(u_ref, x)
    u_ref = u_ref.detach()
    u, du_dx = nbk.run_uf(conf, params, box, BETA, CUTOFF, max_tiles=10**4, cb=2)
    assert float(u) == pytest.approx(float(u_ref), rel=1e-6)
    assert float(torch.linalg.vector_norm(du_dx - g_ref) / torch.linalg.vector_norm(g_ref)) < 1e-5


def test_overflow_gives_nan(water):
    """Lists that do not fit max_tiles give NaN, never sums that silently
    miss tiles: energy, forces, du/dp and the MD provider."""
    conf, params, box = (torch.as_tensor(a) for a in _arrays(water))
    u, du_dx = nbk.run_uf(conf, params, box, BETA, CUTOFF, max_tiles=8, cb=2)
    assert bool(torch.isnan(u)) and bool(torch.isnan(du_dx).all())
    assert bool(torch.isnan(nbk.run_dp(conf, params, box, BETA, CUTOFF, max_tiles=8, cb=2)).all())
    init, apply, energy = nbk.make_nonbonded_tiles_md(BETA, CUTOFF, max_tiles=8, cb=2)
    force, state = apply(init(conf, params, box), conf, params, box, 0)
    assert bool(torch.isnan(force).all()) and bool(torch.isnan(energy(state, conf, params, box)))


def test_exact_exclusion_functions_match_jax(water):
    """f64, 1e-12: the exact-erfc water and pair-list exclusion energies and
    their parameter gradients equal the JAX functions."""
    cfg = host_config_from_jax(water, device="cpu")
    nb = cfg.host_system.nonbonded_all_pairs
    conf, box = water.conf, water.box
    params = np.asarray(water.host_system.nonbonded_all_pairs.params)
    exc = np.asarray(water.host_system.nonbonded_all_pairs.potential.exclusion_idxs)[:30]
    scales = np.random.default_rng(2).uniform(0.2, 1.0, (30, 2))
    nw = nb.num_waters

    def jax_u(p):
        c, b = jnp.asarray(conf), jnp.asarray(box)
        vdw, es = jnb.nonbonded_on_specific_pairs(
            c, p, b, jnp.asarray(exc), BETA, CUTOFF, rescale_mask=jnp.asarray(scales)
        )
        return jnb.water_exclusion_energy(c, p, b, nw, BETA, CUTOFF) + jnp.sum(vdw) + jnp.sum(es)

    import jax

    u_ref, g_ref = jax.value_and_grad(jax_u)(jnp.asarray(params))
    p = torch.tensor(params, requires_grad=True)
    x, b = torch.as_tensor(conf), torch.as_tensor(box)
    vdw, es = tnb.nonbonded_on_specific_pairs(x, p, b, torch.as_tensor(exc), BETA, CUTOFF, torch.as_tensor(scales))
    u = tnb.water_exclusion_energy(x, p, b, nw, BETA, CUTOFF) + vdw.sum() + es.sum()
    u.backward()
    assert float(u) == pytest.approx(float(u_ref), rel=1e-12)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_ref), rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def v1_pair(water):
    jcfg = build_water_system(2.4)  # configure_pallas changes the potential in place
    jpot = jcfg.host_system.nonbonded_all_pairs
    jpot.potential.configure_pallas(jcfg.box, jcfg.conf, interpret=True, kernel="v1")
    cfg = host_config_from_jax(water, device="cpu", dtype=torch.float32)
    x = torch.as_tensor(cfg.conf, dtype=torch.float32)
    box = torch.as_tensor(cfg.box, dtype=torch.float32)
    nb = cfg.host_system.nonbonded_all_pairs.configure(box, x, kernel="v1")
    return jcfg, jpot, nb, x, box


def test_v1_energy_force_matches_jax(v1_pair):
    """kernel="v1" Nonbonded (exact-erfc all pairs minus exact-erfc
    exclusions) against JAX configure_pallas(kernel="v1", interpret=True),
    f32: 1e-5 of the all-pairs scale (sum |u_i|, all-pairs force norm);
    measured 9.9e-8 for the energy, 3.2e-7 for the force."""
    jcfg, jpot, nb, x, box = v1_pair
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    u_ref, f_ref = jpot.potential.energy_force_fn()(f32(jcfg.conf), f32(jpot.params), f32(jcfg.box))
    u, f = nb.energy_force(x, box)
    out, _, _ = nbk._sweep(x, nb.params, box, BETA, CUTOFF, nb.dp_max_tiles, nbk.UF, 2)
    u_scale, f_scale = float(out[:, 0].abs().sum()), float(torch.linalg.vector_norm(out[:, 1:4]))
    assert abs(float(u) - float(u_ref)) / u_scale < 1e-5
    assert np.linalg.norm(f.numpy() - np.asarray(f_ref)) / f_scale < 1e-5
    assert float(nb.energy(x, box)) == pytest.approx(float(u), rel=1e-6)


def test_v1_md_provider(v1_pair):
    """The v1 provider rebuilds when t % 20 == 0, gives the energy/force
    path's force through its lists (1e-5 of the all-pairs force norm) and
    its energy through the same lists."""
    _, _, nb, x, box = v1_pair
    init, apply, energy, rigid = nb.md_force_provider()
    s0 = init(x, box)
    assert apply(s0, x, box, 7)[1] is s0 and apply(s0, x, box, 20)[1] is not s0
    f, _ = apply(s0, x, box, 1)
    u_ref, f_ref = nb.energy_force(x, box)
    f_scale = float(torch.linalg.vector_norm(NonbondedAllPairs.energy_force(nb, x, box)[1]))
    assert float(torch.linalg.vector_norm(f - f_ref)) / f_scale < 1e-5
    assert float(energy(s0, x, box)) == pytest.approx(float(u_ref), rel=1e-5)
    assert float(rigid(s0, x, box)) == pytest.approx(float(NonbondedAllPairs.energy(nb, x, box)), rel=1e-6)


def test_wrapper_rejects_bad_arguments(sweep_inputs):
    tiles, _, _, scal_t, _, cb, _ = sweep_inputs
    args = (tiles.atoms, tiles.row_start, tiles.row_count, tiles.col_ids, scal_t)
    with pytest.raises(ValueError, match="exact"):
        nbk._check_args(*args, nbk.DP, cb, nbk.es_switch_poly_coeffs(BETA, CUTOFF))
    with pytest.raises(ValueError, match="mode"):
        nbk._check_args(*args, 7, cb, None)
    with pytest.raises(ValueError, match="multiple"):
        nbk._check_args(*args, nbk.UF, 5, None)
    with pytest.raises(ValueError, match="energy_force|exact|poly"):
        nbk.make_nonbonded_tiles_energy_force(BETA, 1.0, 128, es="poly")
