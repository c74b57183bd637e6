"""timemachine_torch quad path against timemachine_tpu: the Hilbert keys,
the packed tile lists, the constant-shift gate, the plain sweep against the
JAX Pallas kernel in interpret mode (with and without w), the MD provider
across a rebuild, `configure(kernel="quad")` with its fall-back to rowscan
and its `quad_has_w`, and the kernel's per-step culls.

Inputs are made from a seed with numpy, as tests/test_quadscan.py makes
them (jittered lattice fluids), and handed to both packages in f32. Keys and
lists are integers and must be equal. The sweeps sum each atom's pairs in
different orders (the JAX kernel over 128-lane packed tiles with a
sequential reaction carry, the port over (32, 32) quarters with a scatter of
the reactions), so per-atom energies and gradients agree to 1e-5 relative
norm (measured ~1e-7). Norms are taken in f64: the dense lattice's closest
pairs have |dU/dx| near 1e22, whose squares overflow f32.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.ops import nonbonded_kernel as nbk
from timemachine_torch.ops import quadscan_kernel as tq
from timemachine_torch.ops import rowscan_kernel as trs
from timemachine_torch.potentials import NonbondedAllPairs
from timemachine_tpu import potentials as jpot
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.ops.pallas import quadscan_kernel as jq

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF, SKIN = 2.0, 1.2, 0.1
SERIES = trs.es_energy_force_series(BETA, CUTOFF)
F32 = torch.float32


def lattice_fluid(n, n_side, jitter, seed, spacing=0.31):
    """tests/test_quadscan.py's fluid: a jittered cubic lattice with random
    LJ and charge parameters."""
    rng = np.random.default_rng(seed)
    pts = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3) * spacing
    conf = pts[:n] + rng.normal(0, jitter, (n, 3))
    box = np.eye(3) * (n_side * spacing)
    charges = rng.uniform(-0.8, 0.8, n) * np.sqrt(138.935456)
    params = np.stack([charges, rng.uniform(0.05, 0.16, n), rng.uniform(0.05, 0.9, n) ** 0.5, np.zeros(n)], 1)
    return conf, params, box


@pytest.fixture(scope="module")
def valid_fluid():
    """The 24^3 lattice at water-like density, box 5.16 nm: the JAX test's
    fluid on which the constant-shift invariant holds at the bare cutoff."""
    return lattice_fluid(24**3, 24, 0.05, seed=0, spacing=0.215)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F32)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def test_hilbert_keys_equal_jax():
    frac = np.random.default_rng(0).uniform(0, 1, (5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(nbk.hilbert_keys(_t(frac)).numpy(), np.asarray(jq._hilbert_keys(_j(frac))))


def test_tiles_equal_jax(valid_fluid):
    """pad_order, row_start, row_count, entries and overflow equal
    build_quadscan_tiles' on the same f32 inputs, at the suggested capacity
    and at half of it (which overflows by the same count)."""
    conf, params, box = valid_fluid
    max_tiles = jq.suggest_max_tiles(conf, box, CUTOFF)
    assert tq.suggest_max_tiles(_t(conf), _t(box), CUTOFF) == max_tiles
    for cap in (max_tiles, max_tiles // 2):
        j = jq.build_quadscan_tiles(_j(conf), _j(params), _j(box), CUTOFF, max_tiles=cap)
        t = tq.build_quadscan_tiles(_t(conf), _t(box), CUTOFF, cap)
        for name, a, b in zip(("pad_order", "row_start", "row_count", "entries"), t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert int(t.overflow) == int(j[4])
    assert int(t.overflow) > 0


def test_constant_shift_gate_agrees_with_jax(valid_fluid):
    """Valid on the 5.16 nm lattice at the cutoff, invalid on the 3.4 nm
    lattice (tests/test_quadscan.py's two cases); the builder's margin is
    the host check's."""
    conf, _, box = valid_fluid
    small, _, small_box = lattice_fluid(1100, 11, 0.04, seed=0)
    for c, b, want in ((conf, box, True), (small, small_box, False)):
        assert jq.constant_shift_valid(c, b, CUTOFF) is want
        assert tq.constant_shift_valid(_t(c), _t(b), CUTOFF) is want
    margin = tq.constant_shift_margin(_t(conf), _t(box), CUTOFF)
    assert float(tq.build_quadscan_tiles(_t(conf), _t(box), CUTOFF, 64).margin) == margin > 0


@pytest.mark.parametrize("mode", [tq.FORCE, tq.FORCE_ENERGY])
def test_plain_sweep_matches_jax_kernel(valid_fluid, mode):
    """quadscan_sweep_plain against quadscan_sweep(interpret=True) on the
    same lists: dU/dx and, in F+U, the row-side u to 1e-5 relative norm;
    in F the energy column is zero."""
    conf, params, box = valid_fluid
    n = conf.shape[0]
    max_tiles = jq.suggest_max_tiles(conf, box, CUTOFF)
    tiles = tq.build_quadscan_tiles(_t(conf), _t(box), CUTOFF, max_tiles)
    atoms = trs.assemble_atoms(_t(conf), _t(box), tiles.pad_order, trs.param_rows(_t(params), tiles.pad_order, n))
    out = tq.quadscan_sweep(
        atoms, tiles.row_start, tiles.row_count, tiles.entries, trs.sweep_scalars(_t(box), CUTOFF), SERIES, mode
    ).numpy()
    atoms8 = jnp.asarray(atoms.numpy().T)
    ref = np.asarray(jq.quadscan_sweep(
        atoms8, atoms8.T, jnp.asarray(tiles.row_start.numpy()), jnp.asarray(tiles.row_count.numpy()),
        jnp.asarray(tiles.entries.numpy()), jq._scalars(_j(box), CUTOFF), atoms.shape[0] // 32, *SERIES,
        compute_u=mode == tq.FORCE_ENERGY, interpret=True,
    ))
    assert _rel(out[:, 1:4], ref[:, 1:4]) < 1e-5
    if mode == tq.FORCE_ENERGY:
        assert _rel(out[:, 0], ref[:, 0]) < 1e-5
    else:
        assert not out[:, 0].any()


def test_md_provider_across_a_rebuild_matches_jax(valid_fluid):
    """Three steps with a rebuild every two and 0.004 nm of drift a step, at
    cutoff 1.0 + skin 0.1 (where the shift invariant holds on this box): the
    port's forces equal make_nonbonded_quadscan_md's to 1e-5 relative norm
    at every step, and the energies through the cached tiles to 1e-6 of
    sum |u_i| (the net energy is a small difference of large pair sums)."""
    conf, params, box = valid_fluid
    cutoff = 1.0
    max_tiles = jq.suggest_max_tiles(conf, box, cutoff + SKIN, margin=1.4)
    j_init, j_apply, j_energy, *_ = jq.make_nonbonded_quadscan_md(
        BETA, cutoff, max_tiles, skin=SKIN, rebuild_interval=2, interpret=True
    )
    init, apply, energy, _ = tq.make_nonbonded_quadscan_md(BETA, cutoff, max_tiles, skin=SKIN, rebuild_interval=2)
    p32 = _j(params)
    j_state = j_init(_j(conf), p32, _j(box))
    state = init(_t(conf), _t(params), _t(box))
    rng = np.random.default_rng(0)
    x = conf.astype(np.float32)
    for t in range(3):
        _, f_j, j_state = j_apply(j_state, jnp.asarray(x), p32, _j(box), jnp.asarray(t))
        f, state = apply(state, _t(x), _t(params), _t(box), t)
        assert _rel(f.numpy(), f_j) < 1e-5, t
        x = (x + rng.normal(0, 0.004, size=x.shape)).astype(np.float32)
    assert float(state.lists.margin) > 0 and int(state.lists.overflow) == 0
    u = float(energy(state, _t(x), _t(params), _t(box)))
    u_j = float(j_energy(j_state, jnp.asarray(x), p32, _j(box)))
    t_ = state.lists
    atoms = trs.assemble_atoms(_t(x), _t(box), t_.pad_order, state.prows)
    u_atoms = tq.quadscan_sweep(
        atoms, t_.row_start, t_.row_count, t_.entries, trs.sweep_scalars(_t(box), cutoff),
        trs.es_energy_force_series(BETA, cutoff), tq.FORCE_ENERGY,
    )[:, 0]
    assert abs(u - u_j) / float(u_atoms.abs().sum()) < 1e-6


def test_atom_crossing_a_box_face_between_rebuilds(valid_fluid):
    """An atom that crosses a box face between rebuilds keeps the image it
    was built in: its force through the cached tiles equals its force after
    a fresh rebuild at the same coordinates to 1e-4 relative (f32, other
    lists and summation orders, over pair terms up to ten times the net;
    measured 8e-6), and so does every force to 1e-5 relative norm. Wrapped
    afresh, as the JAX provider wraps, the atom would sit a box length from
    where its entries' shifts expect it and lose every pair (ROADMAP P4).
    The 5.16 nm lattice at cutoff 0.6 + skin 0.1."""
    conf, params, box = valid_fluid
    cutoff = 0.6
    assert tq.constant_shift_valid(_t(conf), _t(box), cutoff + SKIN)
    init, apply, *_ = tq.make_nonbonded_quadscan_md(BETA, cutoff, 10**4, skin=SKIN)
    state = init(_t(conf), _t(params), _t(box))
    k = int(np.argmin(np.abs(conf[:, 0])))
    assert abs(conf[k, 0]) < 0.02
    moved = conf.copy()
    moved[k, 0] -= np.sign(conf[k, 0]) * 0.03  # across the face at x = 0, within skin / 2
    f_cached, _ = apply(state, _t(moved), _t(params), _t(box), 1)
    f_fresh, fresh = apply(state, _t(moved), _t(params), _t(box), 0)
    assert int(fresh.lists.overflow) == 0 and float(fresh.lists.margin) > 0
    assert _rel(f_cached[k].numpy(), f_fresh[k].numpy()) < 1e-4
    assert _rel(f_cached.numpy(), f_fresh.numpy()) < 1e-5
    t_ = state.lists
    rewrapped = trs.assemble_atoms(_t(moved), _t(box), t_.pad_order, state.prows)
    out = tq.quadscan_sweep(
        rewrapped, t_.row_start, t_.row_count, t_.entries, trs.sweep_scalars(_t(box), cutoff),
        trs.es_energy_force_series(BETA, cutoff), tq.FORCE,
    )
    assert not out[state.inv[k], 1:4].any()


def test_broken_invariant_poisons_the_provider():
    """On the 3.4 nm lattice one shift per entry is wrong for some pairs:
    the builder's margin is negative and the provider returns NaN."""
    conf, params, box = lattice_fluid(1100, 11, 0.04, seed=0)
    init, apply, energy, _ = tq.make_nonbonded_quadscan_md(BETA, CUTOFF, 10**4, skin=SKIN)
    state = init(_t(conf), _t(params), _t(box))
    assert float(state.lists.margin) < 0
    force, state = apply(state, _t(conf), _t(params), _t(box), 1)
    assert bool(torch.isnan(force).all()) and bool(torch.isnan(energy(state, _t(conf), _t(params), _t(box))))


def test_configure_quad_falls_back_on_small_box():
    """The 3.4 nm lattice fails the gate at cutoff + skin: both packages
    configure rowscan, and the port's MD provider is rowscan's."""
    conf, params, box = lattice_fluid(1100, 11, 0.04, seed=1)
    pot = jpot.NonbondedAllPairs(1100, beta=BETA, cutoff=CUTOFF)
    pot.configure_pallas(box, conf, interpret=True, kernel="quad")
    nb = NonbondedAllPairs(1100, BETA, CUTOFF, params, device="cpu", dtype=F32).configure(_t(box), _t(conf), kernel="quad")
    assert pot.pallas_kernel == nb.kernel == "rowscan"
    assert not hasattr(nb, "md_max_tiles") and nb.md_max_pairs > 0


def test_configure_quad_takes_quad_where_valid(valid_fluid):
    """At cutoff 1.0 the 5.16 nm lattice passes the gate at cutoff + skin:
    the configuration is "quad", energy_force stays on rowscan, and the MD
    provider's quadscan force equals it to 1e-5 of the force norm (both
    sweep the same polynomial function)."""
    conf, params, box = valid_fluid
    nb = NonbondedAllPairs(conf.shape[0], BETA, 1.0, params, device="cpu", dtype=F32)
    nb.configure(_t(box), _t(conf), kernel="quad")
    assert nb.kernel == "quad" and nb.md_max_tiles > 0
    rows, quads = trs.rowscan_sweep_plain.calls, tq.quadscan_sweep_plain.calls
    _, f = nb.energy_force(_t(conf), _t(box))
    assert trs.rowscan_sweep_plain.calls == rows + 1
    init, apply, _, _, _ = nb.md_force_provider()
    f_md, _ = apply(init(_t(conf), _t(box)), _t(conf), _t(box), 0)
    assert tq.quadscan_sweep_plain.calls == quads + 1
    assert _rel(f_md.numpy(), f.numpy()) < 1e-5


def _lifted(fluid, seed=1):
    """The fluid with a third of its atoms lifted into w in [0, 0.3)."""
    conf, params, box = fluid
    rng = np.random.default_rng(seed)
    params = params.copy()
    params[:, 3] = rng.uniform(0.0, 0.3, len(params)) * (rng.random(len(params)) < 1 / 3)
    return conf, params, box


@pytest.mark.parametrize("mode", [tq.FORCE, tq.FORCE_ENERGY])
def test_plain_sweep_without_w_matches_jax_kernel(valid_fluid, mode):
    """quadscan_sweep_plain(has_w=False) against quadscan_sweep(has_w=False,
    interpret=True) on atoms lifted into w, which both leave out of r^2:
    dU/dx and, in F+U, u to 1e-5 relative norm; the with-w sweep differs."""
    conf, params, box = _lifted(valid_fluid)
    n = conf.shape[0]
    max_tiles = jq.suggest_max_tiles(conf, box, CUTOFF)
    tiles = tq.build_quadscan_tiles(_t(conf), _t(box), CUTOFF, max_tiles)
    atoms = trs.assemble_atoms(_t(conf), _t(box), tiles.pad_order, trs.param_rows(_t(params), tiles.pad_order, n))
    args = (atoms, tiles.row_start, tiles.row_count, tiles.entries, trs.sweep_scalars(_t(box), CUTOFF), SERIES, mode)
    out = tq.quadscan_sweep(*args, has_w=False).numpy()
    atoms8 = jnp.asarray(atoms.numpy().T)
    ref = np.asarray(jq.quadscan_sweep(
        atoms8, atoms8.T, jnp.asarray(tiles.row_start.numpy()), jnp.asarray(tiles.row_count.numpy()),
        jnp.asarray(tiles.entries.numpy()), jq._scalars(_j(box), CUTOFF), atoms.shape[0] // 32, *SERIES,
        compute_u=mode == tq.FORCE_ENERGY, interpret=True, has_w=False,
    ))
    assert _rel(out[:, 1:4], ref[:, 1:4]) < 1e-5
    if mode == tq.FORCE_ENERGY:
        assert _rel(out[:, 0], ref[:, 0]) < 1e-5
    assert _rel(tq.quadscan_sweep(*args).numpy()[:, 1:4], ref[:, 1:4]) > 1e-3


def test_md_provider_without_w_across_a_rebuild_matches_jax(valid_fluid):
    """As test_md_provider_across_a_rebuild_matches_jax, with has_w=False in
    both packages (w is zero here): forces to 1e-5 relative norm at every
    step across a rebuild, energies to 1e-6 of sum |u_i|."""
    conf, params, box = valid_fluid
    cutoff = 1.0
    max_tiles = jq.suggest_max_tiles(conf, box, cutoff + SKIN, margin=1.4)
    j_init, j_apply, j_energy, *_ = jq.make_nonbonded_quadscan_md(
        BETA, cutoff, max_tiles, skin=SKIN, rebuild_interval=2, interpret=True, has_w=False
    )
    init, apply, energy, _ = tq.make_nonbonded_quadscan_md(BETA, cutoff, max_tiles, skin=SKIN, rebuild_interval=2, has_w=False)
    p32 = _j(params)
    j_state = j_init(_j(conf), p32, _j(box))
    state = init(_t(conf), _t(params), _t(box))
    rng = np.random.default_rng(1)
    x = conf.astype(np.float32)
    for t in range(3):
        _, f_j, j_state = j_apply(j_state, jnp.asarray(x), p32, _j(box), jnp.asarray(t))
        f, state = apply(state, _t(x), _t(params), _t(box), t)
        assert _rel(f.numpy(), f_j) < 1e-5, t
        x = (x + rng.normal(0, 0.004, size=x.shape)).astype(np.float32)
    assert int(state.invalid) == 0
    u = float(energy(state, _t(x), _t(params), _t(box)))
    u_j = float(j_energy(j_state, jnp.asarray(x), p32, _j(box)))
    t_ = state.lists
    atoms = trs.assemble_atoms(_t(x), _t(box), t_.pad_order, state.prows)
    u_atoms = tq.quadscan_sweep(
        atoms, t_.row_start, t_.row_count, t_.entries, trs.sweep_scalars(_t(box), cutoff),
        trs.es_energy_force_series(BETA, cutoff), tq.FORCE_ENERGY, has_w=False,
    )[:, 0]
    assert abs(u - u_j) / float(u_atoms.abs().sum()) < 1e-6


def test_configure_quad_without_w_matches_jax(valid_fluid):
    """configure(kernel="quad", quad_has_w=False) against
    configure_pallas(kernel="quad", quad_has_w=False) at cutoff 1.0: both
    take "quad", and the MD providers' forces agree to 1e-5 relative norm."""
    conf, params, box = valid_fluid
    n = conf.shape[0]
    pot = jpot.NonbondedAllPairs(n, beta=BETA, cutoff=1.0)
    pot.configure_pallas(box, conf, interpret=True, kernel="quad", quad_has_w=False)
    nb = NonbondedAllPairs(n, BETA, 1.0, params, device="cpu", dtype=F32)
    nb.configure(_t(box), _t(conf), kernel="quad", quad_has_w=False)
    assert pot.pallas_kernel == nb.kernel == "quad"
    j_init, j_apply, *_ = pot.md_force_provider()
    p32 = _j(params)
    _, f_j, _ = j_apply(j_init(_j(conf), p32, _j(box)), _j(conf), p32, _j(box), jnp.asarray(0))
    init, apply, _, _, _ = nb.md_force_provider()
    f, state = apply(init(_t(conf), _t(box)), _t(conf), _t(box), 0)
    assert int(state.invalid) == 0 and _rel(f.numpy(), f_j) < 1e-5


def test_nonzero_w_without_has_w_poisons_the_provider(valid_fluid):
    """has_w=False is a promise that every w is zero: where a rebuild finds
    one that is not, the force and the energy are NaN (ROADMAP P9; JAX's
    provider leaves w out silently)."""
    conf, params, box = _lifted(valid_fluid)
    init, apply, energy, _ = tq.make_nonbonded_quadscan_md(BETA, 1.0, 10**4, skin=SKIN, has_w=False)
    f, state = apply(init(_t(conf), _t(params), _t(box)), _t(conf), _t(params), _t(box), 0)
    assert int(state.invalid) > 0 and bool(torch.isnan(f).all())
    assert np.isnan(float(energy(state, _t(conf), _t(params), _t(box))))


@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_cull_never_drops_a_pair(jitter):
    """The kernel's cull (cull_mask: each shifted column atom against the
    box of the row chunk's atoms) keeps every column atom that has a row
    atom within the cutoff in the entry's frame (the pair function's f32
    differences), on the 3.4 nm water box's lists at cutoff + skin, and
    again after 0.02 nm of random jitter that puts atoms across box faces
    (placed at their build-time images, as the MD provider places them); it
    drops something, and cull_census counts columns <= swept < listed."""
    cfg = build_water_system(3.4)
    conf = np.asarray(cfg.conf, np.float32)
    params = np.asarray(cfg.host_system.nonbonded_all_pairs.params, np.float32)
    box_t = _t(cfg.box)
    conf_t = _t(conf)
    tiles = tq.build_quadscan_tiles(conf_t, box_t, CUTOFF + SKIN, 10**4)
    assert int(tiles.overflow) == 0
    moved = conf_t + _t(np.random.default_rng(5).normal(0.0, jitter, conf.shape))
    box_diag = torch.diagonal(box_t)
    image = torch.floor(conf_t / box_diag)
    if jitter:  # the jitter put atoms across faces
        assert bool((torch.floor(moved / box_diag) != image).any())
    n = conf.shape[0]
    xyz = (moved - box_diag * image)[tiles.pad_order]
    atoms = torch.cat([xyz, trs.param_rows(_t(params), tiles.pad_order, n), xyz.new_zeros((xyz.shape[0], 1))], dim=1)
    scalars = trs.sweep_scalars(box_t, CUTOFF)
    c = tq.cull_mask(atoms, tiles.row_start, tiles.row_count, tiles.entries, scalars)
    quarters = atoms[:, :3].view(-1, tq.Q, 3)
    for e0 in range(0, len(c.rows), 1024):
        sl = slice(e0, e0 + 1024)
        col = quarters[c.quarter[sl]] + (c.shift[sl].to(F32) * box_diag)[:, None, :]  # (E, 32, 3)
        d = quarters[c.rows[sl]][:, :, None, :] - col[:, None, :, :]  # (E, 32 rows, 32 cols, 3)
        near = ((d * d).sum(-1) < CUTOFF**2).any(1)  # (E, 32): columns with a row atom within the cutoff
        assert bool(c.column[sl][near].all())
    census = tq.cull_census(atoms, tiles.row_start, tiles.row_count, tiles.entries, scalars)
    assert 0 < census.columns <= census.swept < census.listed
    assert census.listed == int(tiles.row_count.sum()) * tq.PACK * tq.Q * tq.Q


def test_census_constants_mirror_the_kernel_source():
    """cull_census counts the kernel's work items with WARPS and SPLITS,
    constants of csrc/quadscan.cu that the module mirrors: they must agree."""
    source = (Path(tq.__file__).parents[1] / "csrc" / "quadscan.cu").read_text()
    for name in ("WARPS", "SPLITS"):
        assert re.search(rf"constexpr int {name} = (\d+);", source).group(1) == str(getattr(tq, name))
