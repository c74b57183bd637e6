"""The rowscan sweep's Newton-triangular, preshift and no-w forms, and the
main path's configuration in JAX's default form, against timemachine_tpu.

Each test gives both packages the same inputs, made from a seed with numpy
(jittered lattice fluids as tests/test_dotscan.py makes them), in f32; each
package sweeps its own lists (JAX pads each row's list to a multiple of 4,
ROADMAP P6), and the JAX side runs its Pallas kernel in interpret mode.

Tolerances. The two sweeps compute one function over the same pairs in
other summation orders, and preshift forms its images in other words (the
port relative to the row center, JAX in absolute coordinates): per-atom
dU/dx and u agree to 1e-5 in relative norm (measured 1e-7 to 1e-6).
Triangular against symmetric in f64 differ by summation order only: 1e-10
of the largest |dU/dx|, total energies to 1e-12 relative. Norms in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.ops import dotscan_kernel as td
from timemachine_torch.ops import rowscan_kernel as trs
from timemachine_torch.potentials import NonbondedAllPairs
from timemachine_tpu import potentials as jpot
from timemachine_tpu.ops.pallas import dotscan_kernel as jd
from timemachine_tpu.ops.pallas import rowscan_kernel as jrs

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, SKIN = 2.0, 0.1
F32 = torch.float32
TOL = 1e-5
# a 4.96 nm fluid at a cutoff of 0.8 nm on snake cells of 0.9 nm: the image
# bound holds with about 0.4 nm to spare, so the preshift forms apply
CUTOFF, CELL = 0.8, 0.9
MODES = {"F": (trs.FORCE, False), "F+U": (trs.FORCE_ENERGY, True), "U": (trs.ENERGY, "u_only")}


def lattice_fluid(n_side, jitter, seed, spacing=0.31, w_frac=0.0):
    """A jittered cubic lattice with random LJ and charge parameters; w_frac
    of the atoms lifted into w in [0, 0.6)."""
    rng = np.random.default_rng(seed)
    n = n_side**3
    pts = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3) * spacing
    conf = pts + rng.normal(0, jitter, (n, 3))
    box = np.eye(3) * (n_side * spacing)
    charges = rng.uniform(-0.8, 0.8, n) * np.sqrt(138.935456)
    w = rng.uniform(0.0, 0.6, n) * (rng.random(n) < w_frac)
    params = np.stack([charges, rng.uniform(0.05, 0.16, n), rng.uniform(0.05, 0.9, n) ** 0.5, w], 1)
    return conf, params, box


@pytest.fixture(scope="module")
def fluid():
    """16^3 atoms at 0.31 nm, box 4.96 nm, shifted by half a box so row
    chunks straddle every face; all w zero."""
    conf, params, box = lattice_fluid(16, 0.03, seed=0)
    return conf + 0.5 * np.diagonal(box), params, box


@pytest.fixture(scope="module")
def lifted():
    """The same lattice with a tenth of the atoms lifted into w."""
    return lattice_fluid(16, 0.03, seed=1, w_frac=0.1)


def _t(a, dtype=F32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _port_sweep(conf, params, box, mode, triangular, preshift, has_w, dtype=F32, cutoff=CUTOFF):
    """(output in sorted order, pad_order) of the port's sweep on its own lists at `cutoff`."""
    if preshift:
        tiles = td.build_dotscan_tiles(_t(conf), _t(box), cutoff, 10**5, CELL, triangular)
        assert int(tiles.invalid) == 0
    else:
        tiles = trs.build_rowscan_tiles(_t(conf), _t(box), cutoff, 10**5, CELL, triangular)
    n = conf.shape[0]
    atoms = trs.assemble_atoms(_t(conf, dtype), _t(box, dtype), tiles.pad_order, trs.param_rows(_t(params, dtype), tiles.pad_order, n))
    out = trs.rowscan_sweep(
        atoms, tiles.row_start, tiles.row_count, tiles.col_ids, trs.sweep_scalars(_t(box, dtype), cutoff),
        trs.es_energy_force_series(BETA, cutoff), mode, triangular, tiles.rcen_q if preshift else None, has_w,
    )
    return out, tiles.pad_order, atoms


def _jax_sweep(conf, params, box, atoms, compute_u, triangular, preshift, has_w):
    """JAX's rowscan_sweep (interpret mode) on its own lists over the port's atom rows."""
    build = jd.build_dotscan_tiles if preshift else jrs.build_rowscan_tiles
    lists = build(_j(conf), _j(params), _j(box), CUTOFF, max_pairs=10**5, cell_size=CELL, triangular=triangular)
    h, p = jrs.es_energy_force_series(BETA, CUTOFF)
    a8 = jnp.asarray(atoms.numpy().T)
    return np.asarray(jrs.rowscan_sweep(
        a8, a8.T, *lists[1:4], jrs._scalars(_j(box), CUTOFF), n_rows=atoms.shape[0] // 32, max_pairs=10**5,
        h_coeffs=h, p_coeffs=p, compute_u=compute_u, interpret=True, triangular=triangular, has_w=has_w,
        rcen_q=lists[4] if preshift else None,
    )), np.asarray(lists[0])


FORMS = {
    # name: (triangular, preshift, has_w, input)
    "tri-preshift-no_w": (True, True, False, "fluid"),
    "tri-no_w": (True, False, False, "fluid"),
    "tri-w": (True, False, True, "lifted"),
    "sym-preshift-no_w": (False, True, False, "fluid"),
}


@pytest.mark.parametrize("mode_name", list(MODES))
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_sweep_matches_jax_kernel(fluid, lifted, form, mode_name):
    """The plain sweep in each form and mode against JAX's rowscan_sweep in
    the same form (triangular, rcen_q, has_w; compute_u False, True or
    "u_only"): per-atom dU/dx and u to 1e-5 in relative norm; the columns a
    mode leaves out are zero in both."""
    triangular, preshift, has_w, case = FORMS[form]
    conf, params, box = {"fluid": fluid, "lifted": lifted}[case]
    mode, compute_u = MODES[mode_name]
    out, pad_order, atoms = _port_sweep(conf, params, box, mode, triangular, preshift, has_w)
    ref, j_order = _jax_sweep(conf, params, box, atoms, compute_u, triangular, preshift, has_w)
    np.testing.assert_array_equal(pad_order.numpy(), j_order)
    out = out.numpy()
    if mode == trs.ENERGY:
        assert not out[:, 1:4].any() and not ref[:, 1:4].any()
    else:
        assert _rel_norm(out[:, 1:4], ref[:, 1:4]) < TOL
    if mode == trs.FORCE:
        assert not out[:, 0].any()
    else:
        assert _rel_norm(out[:, 0], ref[:, 0]) < TOL


@pytest.mark.parametrize("preshift, has_w, case", [(False, True, "lifted"), (True, False, "fluid"), (True, True, "fluid")])
def test_triangular_equals_symmetric_f64(fluid, lifted, preshift, has_w, case):
    """In f64 the Newton-triangular sweep (each pair once, its force on both
    atoms) equals the symmetric one (each pair from both atoms, energy
    halved): per-atom dU/dx to 1e-10 of the largest, total energy to 1e-12
    relative, in every mode; energy-only energies equal F+U's bitwise."""
    conf, params, box = {"fluid": fluid, "lifted": lifted}[case]
    f64 = torch.float64
    sym, order_s, _ = _port_sweep(conf, params, box, trs.FORCE_ENERGY, False, preshift, has_w, f64)
    tri, order_t, _ = _port_sweep(conf, params, box, trs.FORCE_ENERGY, True, preshift, has_w, f64)
    assert torch.equal(order_s, order_t)
    assert _max_rel(tri[:, 1:4], sym[:, 1:4]) < 1e-10
    assert float(tri[:, 0].sum()) == pytest.approx(float(sym[:, 0].sum()), rel=1e-12)
    u_only, _, _ = _port_sweep(conf, params, box, trs.ENERGY, True, preshift, has_w, f64)
    f_only, _, _ = _port_sweep(conf, params, box, trs.FORCE, True, preshift, has_w, f64)
    assert torch.equal(u_only[:, 0], tri[:, 0]) and torch.equal(f_only[:, 1:4], tri[:, 1:4])


def _j_provider(max_pairs, preshift=True, has_w=False, rebuild_interval=20):
    return jrs.make_nonbonded_rowscan_md(
        BETA, CUTOFF, max_pairs, skin=SKIN, rebuild_interval=rebuild_interval, interpret=True, triangular=True,
        preshift=preshift, has_w=has_w, cell_size=CELL,
    )


def test_md_provider_across_a_rebuild_matches_jax(fluid):
    """The MD provider in the main path's form (triangular, preshift, no w)
    against JAX's make_nonbonded_rowscan_md(triangular=True, preshift=True,
    has_w=False): three steps with a rebuild every two and 0.004 nm of drift
    a step, forces to 1e-5 of the largest at every step, and the energy
    through the cached lists (energy-only in both) to 1e-5 relative."""
    conf, params, box = fluid
    max_pairs = trs.suggest_max_pairs(_t(conf), _t(box), CUTOFF + SKIN, margin=1.4, cell_size=CELL, triangular=True)
    j_init, j_apply, j_energy, *_ = _j_provider(2 * max_pairs, rebuild_interval=2)
    init, apply, energy, _ = trs.make_nonbonded_rowscan_md(
        BETA, CUTOFF, max_pairs, skin=SKIN, rebuild_interval=2, cell_size=CELL, preshift=True, has_w=False
    )
    p32 = _j(params)
    j_state = j_init(_j(conf), p32, _j(box))
    state = init(_t(conf), _t(params), _t(box))
    rng = np.random.default_rng(0)
    x = conf.astype(np.float32)
    for t in range(3):
        _, f_j, j_state = j_apply(j_state, jnp.asarray(x), p32, _j(box), jnp.asarray(t))
        f, state = apply(state, _t(x), _t(params), _t(box), t)
        assert _max_rel(f.numpy(), f_j) < TOL, t
        x = (x + rng.normal(0, 0.004, size=x.shape)).astype(np.float32)
    assert int(state.invalid) == 0 and float(state.lists.margin) > 0
    u = float(energy(state, _t(x), _t(params), _t(box)))
    assert u == pytest.approx(float(j_energy(j_state, jnp.asarray(x), p32, _j(box))), rel=TOL)


@pytest.mark.parametrize("has_w", [True, False])
def test_configure_rowscan_matches_jax(has_w):
    """configure(kernel="rowscan", rowscan_has_w=...) against
    configure_pallas on a fluid where the snake rows at 0.65 nm cells pass
    the image bound at 0.6 + skin: the MD provider takes preshift, and its
    force and energy, and the energy/force entry (triangular at the bare
    cutoff), match JAX's: forces to 1e-5 of the largest, energies to 1e-5
    of the scale sum |u_i| (the total is a small difference of large pair
    energies)."""
    conf, params, box = lattice_fluid(16, 0.03, seed=3)
    cutoff, n = 0.6, conf.shape[0]
    pot = jpot.NonbondedAllPairs(n, beta=BETA, cutoff=cutoff)
    pot.configure_pallas(box, conf, interpret=True, rowscan_has_w=has_w)
    nb = NonbondedAllPairs(n, BETA, cutoff, params, device="cpu", dtype=F32)
    nb.configure(_t(box), _t(conf), rowscan_has_w=has_w)
    assert nb.kernel == "rowscan" and nb.md_preshift
    assert td.dotscan_valid(_t(conf), _t(box), cutoff + SKIN, cell_size=nb.md_cell_size)
    j_init, j_apply, j_energy, *_ = pot.md_force_provider()
    p32 = _j(params)
    j_state = j_init(_j(conf), p32, _j(box))
    _, f_j, j_state = j_apply(j_state, _j(conf), p32, _j(box), jnp.asarray(0))
    init, apply, energy, _, _ = nb.md_force_provider()
    f, state = apply(init(_t(conf), _t(box)), _t(conf), _t(box), 0)
    assert _max_rel(f.numpy(), f_j) < TOL
    scale = float(_port_sweep(conf, params, box, trs.ENERGY, True, False, True, cutoff=cutoff)[0][:, 0].abs().sum())
    u_md = float(energy(state, _t(conf), _t(box)))
    assert abs(u_md - float(j_energy(j_state, _j(conf), p32, _j(box)))) / scale < TOL
    u_j, f_ej = pot.energy_force_fn()(_j(conf), p32, _j(box))
    u, f_e = nb.energy_force(_t(conf), _t(box))
    assert abs(float(u) - float(u_j)) / scale < TOL and _max_rel(f_e.numpy(), f_ej) < TOL


def test_nonzero_w_without_has_w_gives_nan(lifted):
    """has_w=False is a promise that every w is zero: where a rebuild finds
    one that is not, the force and the energy are NaN in both packages."""
    conf, params, box = lifted
    assert params[:, 3].any()
    p32 = _j(params)
    for preshift in (False, True):
        init, apply, energy, _ = trs.make_nonbonded_rowscan_md(
            BETA, CUTOFF, 10**5, skin=SKIN, cell_size=CELL, preshift=preshift, has_w=False
        )
        f, state = apply(init(_t(conf), _t(params), _t(box)), _t(conf), _t(params), _t(box), 0)
        assert int(state.invalid) > 0 and bool(torch.isnan(f).all())
        assert np.isnan(float(energy(state, _t(conf), _t(params), _t(box))))
    j_init, j_apply, *_ = _j_provider(10**5, preshift=False)
    _, f_j, _ = j_apply(j_init(_j(conf), p32, _j(box)), _j(conf), p32, _j(box), jnp.asarray(0))
    assert np.isnan(np.asarray(f_j)).all()


def test_atom_crossing_a_box_face_between_rebuilds():
    """Under preshift an atom that crosses a box face between rebuilds keeps
    its pairs: each sweep wraps afresh and maps atoms to the row center's
    image, so its force through the cached lists equals its force after a
    fresh rebuild at the same coordinates (1e-4 relative; other lists,
    centers and summation orders), every force does to 1e-5 relative norm,
    and the JAX provider's cached force agrees to 1e-5."""
    conf, params, box = lattice_fluid(16, 0.03, seed=2)
    init, apply, *_ = trs.make_nonbonded_rowscan_md(
        BETA, CUTOFF, 10**5, skin=SKIN, cell_size=CELL, preshift=True, has_w=False
    )
    state = init(_t(conf), _t(params), _t(box))
    k = int(np.argmin(np.abs(conf[:, 0])))
    assert abs(conf[k, 0]) < 0.02
    moved = conf.copy()
    moved[k, 0] -= np.sign(conf[k, 0]) * 0.03  # across the face at x = 0, within skin / 2
    f_cached, _ = apply(state, _t(moved), _t(params), _t(box), 1)
    f_fresh, fresh = apply(state, _t(moved), _t(params), _t(box), 0)
    assert int(fresh.invalid) == 0 and bool(f_cached[k].any())
    assert _rel_norm(f_cached[k].numpy(), f_fresh[k].numpy()) < 1e-4
    assert _rel_norm(f_cached.numpy(), f_fresh.numpy()) < 1e-5
    j_init, j_apply, *_ = _j_provider(10**5)
    p32 = _j(params)
    _, f_j, _ = j_apply(j_init(_j(conf), p32, _j(box)), _j(moved), p32, _j(box), jnp.asarray(1))
    assert _max_rel(f_cached.numpy(), f_j) < TOL


def test_small_box_configures_without_preshift():
    """A 3.1 nm box cannot hold the image bound at 1.2 + skin: configure
    takes the triangular lists with per-pair images, as configure_pallas
    does, and the MD provider's force equals the energy/force entry's
    (1e-5 of the largest; other lists at other radii)."""
    conf, params, box = lattice_fluid(10, 0.03, seed=5)
    assert not td.dotscan_valid(_t(conf), _t(box), 1.2 + SKIN)
    assert not jd.dotscan_valid(conf, box, 1.2 + SKIN)
    nb = NonbondedAllPairs(conf.shape[0], BETA, 1.2, params, device="cpu", dtype=F32)
    nb.configure(_t(box), _t(conf), rowscan_has_w=False)
    assert not nb.md_preshift
    init, apply, _, _, _ = nb.md_force_provider()
    f, state = apply(init(_t(conf), _t(box)), _t(conf), _t(box), 0)
    assert not hasattr(state.lists, "rcen_q") and int(state.invalid) == 0
    assert _max_rel(f.numpy(), nb.energy_force(_t(conf), _t(box))[1].numpy()) < TOL


def test_census_counts_triangular_slots(fluid):
    """The census counts what the triangular sweep visits: the chopped lists
    plus each row chunk's covering tile. JAX's census also rounds each row's
    trips up to 4, so it reads at least as much and at most 3 tiles a row
    more."""
    conf, _, box = fluid
    tri = trs.census_swept_slots(_t(conf), _t(box), CUTOFF, SKIN, CELL)
    j = jrs.census_swept_slots(conf, box, CUTOFF, SKIN, CELL)
    n_rows = trs.padded_size(conf.shape[0]) // trs.ROW
    assert tri <= j <= tri + 3 * n_rows * trs.ROW * trs.COL


def test_chop_is_exact_and_survives_face_crossings(fluid):
    """Lists built at 0.8 + skin, then 0.01 nm of jitter (atoms cross the
    box faces of the shifted lattice): the per-step chop keeps every pair
    (the f64 sweep over chopped lists equals the sweep over whole lists to
    1e-12 of the largest |dU/dx|) and keeps no more tiles than JAX's chop,
    which boxes the wrapped coordinates; here strictly fewer."""
    conf, params, box = fluid
    f64 = torch.float64
    tiles = trs.build_rowscan_tiles(_t(conf), _t(box), CUTOFF + SKIN, 10**5, CELL, True)
    moved = conf + np.random.default_rng(4).normal(0, 0.01, conf.shape)
    n = conf.shape[0]
    atoms = trs.assemble_atoms(_t(moved, f64), _t(box, f64), tiles.pad_order, trs.param_rows(_t(params, f64), tiles.pad_order, n))
    chopped = trs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, _t(box, f64), CUTOFF)
    series = trs.es_energy_force_series(BETA, CUTOFF)
    sweep = [
        trs.rowscan_sweep(atoms, tiles.row_start, count, tiles.col_ids, trs.sweep_scalars(_t(box, f64), CUTOFF), series, trs.FORCE_ENERGY, True)
        for count in (chopped, tiles.row_count)
    ]
    assert _max_rel(sweep[0][:, 1:4], sweep[1][:, 1:4]) < 1e-12
    assert float(sweep[0][:, 0].sum()) == pytest.approx(float(sweep[1][:, 0].sum()), rel=1e-12)
    xyz = atoms[:, :3].to(F32).numpy()
    n_cols = xyz.shape[0] // trs.COL
    atoms_cm = np.concatenate([xyz.T.reshape(3, n_cols, trs.COL).transpose(1, 0, 2), np.zeros((n_cols, 5, trs.COL))], 1)
    j_chopped = np.asarray(jrs.chop_row_counts(_j(atoms_cm), jnp.asarray(tiles.rank_mat.numpy()), jnp.asarray(tiles.row_count.numpy()), _j(box), CUTOFF))
    assert int(chopped.sum()) < int(j_chopped.sum())
    assert (chopped.numpy() <= j_chopped).all()
