"""timemachine_torch Nonbonded (all pairs minus exclusions) against
timemachine_tpu, and the rowscan MD provider's contract: rebuild schedule,
energy through cached lists within the skin, NaN on list overflow.

Net nonbonded energies and forces are small differences of large all-pairs
terms (bonded neighbours' LJ and Coulomb) and the exclusion corrections
that cancel them, so f32 tolerances are stated against the all-pairs scale:
sum |u_i| for energies and the all-pairs force norm for forces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.ops import rowscan_kernel as trs
from timemachine_torch.potentials import Nonbonded, NonbondedAllPairs
from timemachine_tpu.md.builders import build_water_system

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF = 2.0, 1.2


@pytest.fixture(scope="module")
def water():
    return build_water_system(3.0)


def _port_nb(jcfg, dtype):
    cfg = host_config_from_jax(jcfg, device="cpu", dtype=dtype)
    x = torch.as_tensor(cfg.conf, dtype=dtype)
    box = torch.as_tensor(cfg.box, dtype=dtype)
    return cfg.host_system.nonbonded_all_pairs.configure(box, x), x, box


def _scales(nb, x, box):
    """(sum |u_i| of the all-pairs sweep, all-pairs force norm), from a
    symmetric sweep (each atom holds half its pair energies)."""
    tiles = trs.build_rowscan_tiles(x, box, CUTOFF, trs.suggest_max_pairs(x, box, CUTOFF))
    atoms = trs.assemble_atoms(x, box, tiles.pad_order, trs.param_rows(nb.params.to(x.dtype), tiles.pad_order, x.shape[0]))
    out = trs.rowscan_sweep(
        atoms, tiles.row_start, tiles.row_count, tiles.col_ids, trs.sweep_scalars(box, CUTOFF),
        trs.es_energy_force_series(BETA, CUTOFF), trs.FORCE_ENERGY,
    )
    return float(out[:, 0].abs().sum()), float(torch.linalg.vector_norm(out[:, 1:4]))


def test_nonbonded_f32_matches_jax_rowscan_path(water):
    """f32 against the JAX production path (configure_pallas, rowscan in
    interpret mode, exclusions with the same polynomial): 1e-5 of the
    all-pairs scale (measured 3.0e-7 for the energy, 2.8e-7 for the force)."""
    jnb = build_water_system(3.0).host_system.nonbonded_all_pairs  # configure_pallas changes it in place
    jnb.potential.configure_pallas(water.box, water.conf, interpret=True)
    u_ref, f_ref = jnb.potential.energy_force_fn()(
        jnp.asarray(water.conf, jnp.float32), jnp.asarray(jnb.params, jnp.float32), jnp.asarray(water.box, jnp.float32)
    )
    nb, x, box = _port_nb(water, torch.float32)
    u, f = nb.energy_force(x, box)
    u_scale, f_scale = _scales(nb, x, box)
    assert abs(float(u) - float(u_ref)) / u_scale < 1e-5
    assert np.linalg.norm(f.numpy() - np.asarray(f_ref)) / f_scale < 1e-5


def test_nonbonded_f64_matches_jax_dense(water):
    """f64 against JAX's dense exact-erfc Nonbonded (exclusions as masks):
    they differ by the deg-10 fit of the switched erfc only, measured 9.1e-6
    of the energy scale and 4.7e-5 of the all-pairs force scale; tolerances
    1e-4 and 3e-4."""
    jnb = water.host_system.nonbonded_all_pairs
    u_ref, g_ref = jax.value_and_grad(lambda c: jnb.potential(c, jnp.asarray(jnb.params), jnp.asarray(water.box)))(
        jnp.asarray(water.conf)
    )
    nb, x, box = _port_nb(water, torch.float64)
    u, f = nb.energy_force(x, box)
    u_scale, f_scale = _scales(nb, x, box)
    assert abs(float(u) - float(u_ref)) / u_scale < 1e-4
    assert np.linalg.norm(f.numpy() + np.asarray(g_ref)) / f_scale < 3e-4
    assert float(nb.energy(x, box)) == pytest.approx(float(u), rel=1e-12)


def test_water_exclusion_path_equals_pair_list_path(water):
    """The strided leading-water correction and the explicit pair-list path
    are one function (f64, 1e-12): reversing the exclusion rows turns off
    leading-water detection."""
    cfg = host_config_from_jax(water, device="cpu")
    nb = cfg.host_system.nonbonded_all_pairs
    exc = np.asarray(water.host_system.nonbonded_all_pairs.potential.exclusion_idxs)
    scales = np.asarray(water.host_system.nonbonded_all_pairs.potential.scale_factors)
    flat = Nonbonded(len(cfg.conf), exc[::-1], scales[::-1], BETA, CUTOFF, nb.params.numpy(), device="cpu")
    assert nb.num_waters == len(cfg.conf) // 3 and flat.num_waters == 0
    x, box = torch.as_tensor(cfg.conf), torch.as_tensor(cfg.box)
    u_w, g_w = nb.exclusion_energy_force(x, box)
    u_l, g_l = flat.exclusion_energy_force(x, box)
    assert float(u_w) == pytest.approx(float(u_l), rel=1e-12)
    np.testing.assert_allclose(g_w.numpy(), g_l.numpy(), rtol=1e-10, atol=1e-9)


@pytest.fixture(scope="module")
def provider(water):
    nb, x, box = _port_nb(water, torch.float32)
    return nb, x, box


def test_provider_rebuild_schedule(provider):
    """apply rebuilds exactly when t % 20 == 0 and otherwise hands back the
    state it was given."""
    nb, x, box = provider
    init, apply, _, _ = nb.md_force_provider()
    s0 = init(x, box)
    for t in (1, 7, 19, 21, 39):
        assert apply(s0, x, box, t)[1] is s0
    for t in (0, 20, 40):
        s = apply(s0, x, box, t)[1]
        assert s is not s0
        assert torch.equal(s.lists.col_ids, s0.lists.col_ids)


def test_provider_reuses_lists_within_skin(provider):
    """Moves well inside skin/2 keep stale lists right: forces and energies
    through stale lists match a fresh build (f32, 1e-5 of the all-pairs
    force scale, measured 1.9e-7; energies 1e-6 relative, as the JAX
    provider's test)."""
    nb, x, box = provider
    init, apply, energy, rigid = nb.md_force_provider()
    stale = init(x, box)
    rng = np.random.default_rng(1)
    moved = x + torch.as_tensor(rng.normal(0, 0.012, x.shape), dtype=x.dtype)
    fresh = init(moved, box)
    f_stale, _ = apply(stale, moved, box, 1)
    f_fresh, _ = apply(fresh, moved, box, 1)
    _, f_scale = _scales(nb, moved, box)
    assert float(torch.linalg.vector_norm(f_stale - f_fresh)) / f_scale < 1e-5
    assert float(energy(stale, moved, box)) == pytest.approx(float(energy(fresh, moved, box)), rel=1e-6)
    # a barostat trial: 0.1% volume, about 2e-3 nm at the box edge
    scale = 1.001 ** (1.0 / 3.0)
    assert float(rigid(stale, x * scale, box * scale)) == pytest.approx(float(rigid(init(x * scale, box * scale), x * scale, box * scale)), rel=1e-6)


def test_provider_overflow_poisons_with_nan(water):
    """Lists that do not fit max_pairs give NaN forces and energies, never
    forces that silently miss interactions."""
    nb, x, box = _port_nb(water, torch.float32)
    init, apply, energy = trs.make_nonbonded_rowscan_md(BETA, CUTOFF, max_pairs=128)
    state = init(x, nb.params, box)
    assert int(state.lists.overflow) > 0
    f, state = apply(state, x, nb.params, box, 0)
    assert bool(torch.isnan(f).all())
    assert bool(torch.isnan(energy(state, x, nb.params, box)))
    u, f = trs.make_nonbonded_rowscan_energy_force(BETA, CUTOFF, max_pairs=128)(x, nb.params, box)
    assert bool(torch.isnan(u)) and bool(torch.isnan(f).all())


def test_all_pairs_needs_configure(water):
    nb = NonbondedAllPairs(len(water.conf), BETA, CUTOFF, np.asarray(water.host_system.nonbonded_all_pairs.params), device="cpu")
    with pytest.raises(RuntimeError, match="configure"):
        nb.energy_force(torch.as_tensor(water.conf), torch.as_tensor(water.box))
