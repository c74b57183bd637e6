"""timemachine_torch dot path against timemachine_tpu: the triangular and
Hilbert rowscan lists, the periodic row centers and image bound, the plain
dotscan sweep against the JAX Pallas kernel in interpret mode, the MD
provider, `configure(kernel="dot")` with its fall-back to rowscan, and the
triangular kernel's per-step cull.

Inputs are made from a seed with numpy, as tests/test_dotscan.py makes them
(jittered lattice fluids, at most 4,096 atoms), and handed to both packages
in f32. Sorts, lists and quantized centers are integers and must be equal;
JAX pads each row's list to a multiple of 4 with the all-padding chunk, so
lists are compared without those entries.

Tolerances. The port takes r^2 from direct differences in both modes, as
the JAX kernel does with dot_r2=False, so the sweeps differ only in
summation order: forces to 1e-5 of the largest |dU/dx|, energies to 1e-5
relative (measured ~1e-6). The JAX kernel's default F mode (dot_r2=True)
forms r^2 by the dot identity in f32, which DHFR NPT does not survive
(ROADMAP R6); one test shows that identity departing from direct
differences on close pairs. Norms are taken in f64.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.context import Context
from timemachine_torch.ops import dotscan_kernel as td
from timemachine_torch.ops import rowscan_kernel as trs
from timemachine_torch.potentials import Nonbonded, NonbondedAllPairs
from timemachine_tpu import potentials as jpot
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.ops.pallas import dotscan_kernel as jd

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, SKIN = 2.0, 0.1
F32 = torch.float32
TOL_F, TOL_U = 1e-5, 1e-5


def lattice_fluid(n_side, jitter, seed, spacing=0.31, w_frac=0.0):
    """tests/test_dotscan.py's fluid: a jittered cubic lattice with random
    LJ and charge parameters; w_frac of the atoms lifted into w in [0, 0.6)."""
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
    chunks straddle every face. Hilbert rows pass the image bound up to a
    cutoff of 1.2 nm, snake rows up to about 0.78 nm."""
    conf, params, box = lattice_fluid(16, 0.03, seed=0)
    return conf + 0.5 * np.diagonal(box), params, box


@pytest.fixture(scope="module")
def dense():
    """16^3 atoms at water-like density (0.215 nm), box 3.44 nm."""
    return lattice_fluid(16, 0.02, seed=9, spacing=0.215)


def _t(a, dtype=F32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _row_sets(row_start, row_count, col_ids):
    rs_, rc, ci = (np.asarray(v) for v in (row_start, row_count, col_ids))
    return [set(ci[s : s + c].tolist()) for s, c in zip(rs_, rc)]


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("sort", ["snake", "hilbert"])
def test_tiles_equal_jax(fluid, sort, triangular):
    """pad_order, each row's listed column chunks, rcen_q and `invalid`
    equal build_dotscan_tiles' (and so build_rowscan_tiles') on the same f32
    inputs, at cutoff + skin; the triangular lists hold only chunks past each
    row chunk's covering chunk."""
    conf, params, box = fluid
    cutoff = 1.2 + SKIN
    j = jd.build_dotscan_tiles(_j(conf), _j(params), _j(box), cutoff, max_pairs=10**5, triangular=triangular, sort=sort)
    t = td.build_dotscan_tiles(_t(conf), _t(box), cutoff, 10**5, triangular=triangular, sort=sort)
    np.testing.assert_array_equal(t.pad_order.numpy(), np.asarray(j[0]))
    rows = _row_sets(t.row_start, t.row_count, t.col_ids)
    assert rows == _row_sets(*j[1:4])
    if triangular:
        assert all(min(cols, default=99) > r * trs.ROW // trs.COL for r, cols in enumerate(rows))
    np.testing.assert_array_equal(t.rcen_q.numpy(), np.asarray(j[4]))
    assert int(t.overflow) == 0 and int(t.invalid) == int(j[5])
    assert td.suggest_max_pairs(_t(conf), _t(box), cutoff, triangular=triangular, sort=sort) >= sum(map(len, rows))


def test_invalid_on_a_shrunken_box_and_on_overflow(fluid):
    """Hilbert rows at 0.9 + skin pass the image bound on the 4.96 nm box
    and fail it with the coordinates and box scaled by 0.45, as in JAX; an
    undersized capacity is invalid in both packages."""
    conf, params, box = fluid
    cutoff = 0.9 + SKIN
    for scale, cap, want in ((1.0, 10**5, 0), (0.45, 10**5, 1), (1.0, 8, None)):
        c, b = conf * scale, box * scale
        j = jd.build_dotscan_tiles(_j(c), _j(params), _j(b), cutoff, max_pairs=cap, triangular=True, sort="hilbert")
        t = td.build_dotscan_tiles(_t(c), _t(b), cutoff, cap, triangular=True, sort="hilbert")
        assert bool(t.invalid) == bool(j[5]) == (want != 0)
        if want is not None:
            assert int(t.invalid) == int(j[5]) == want and (float(t.margin) > 0) == (want == 0)
        else:
            assert int(t.overflow) > 0


def test_periodic_center_halfextent_straddles_the_box():
    """Rows of positions that straddle the box (near 0 and near L), sit in
    the middle, or spread evenly: the same centers and half-extents as JAX,
    and the straddling row's interval wraps (center past the box or below
    its middle) with a half-extent a naive min/max would read as ~L/2."""
    box_len = np.float32(5.0)
    rng = np.random.default_rng(3)
    straddle = np.concatenate([rng.uniform(0.0, 0.3, 16), rng.uniform(4.6, 5.0, 16)])
    middle = rng.uniform(2.0, 2.8, 32)
    spread = np.linspace(0.0, 4.9, 32)
    xs = np.stack([straddle, middle, spread]).astype(np.float32)
    c, h = td.periodic_center_halfextent(torch.as_tensor(xs), torch.tensor(box_len))
    jc, jh = jd._periodic_center_halfextent(jnp.asarray(xs), jnp.float32(box_len))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert h[0] < 0.4 and abs(float(c[0]) % 5.0 - 4.95) < 0.4
    assert h[1] < 0.4 and 2.0 < c[1] < 2.8


@pytest.mark.parametrize(
    "case, cutoff, sort, want",
    [("small", 1.2, "snake", False), ("fluid", 0.9, "hilbert", True), ("fluid", 0.9, "snake", False),
     ("dense", 0.6, "snake", True)],
)
def test_dotscan_valid_agrees_with_jax(fluid, dense, case, cutoff, sort, want):
    """The configure-time gate (headroom 0.1) on a 3.1 nm box (fails), on
    the 4.96 nm fluid (Hilbert passes where snake fails) and snake at water
    density."""
    conf, _, box = {"small": lattice_fluid(10, 0.03, seed=5), "fluid": fluid, "dense": dense}[case]
    assert jd.dotscan_valid(conf, box, cutoff, sort=sort) is want
    assert td.dotscan_valid(_t(conf), _t(box), cutoff, sort=sort) is want


def _sweep_inputs(conf, params, box, cutoff, triangular, sort, dtype=F32):
    tiles = td.build_dotscan_tiles(_t(conf), _t(box), cutoff, 10**5, triangular=triangular, sort=sort)
    n = conf.shape[0]
    atoms = trs.assemble_atoms(_t(conf, dtype), _t(box, dtype), tiles.pad_order, trs.param_rows(_t(params, dtype), tiles.pad_order, n))
    return tiles, atoms


@pytest.mark.parametrize("mode", [td.FORCE, td.FORCE_ENERGY])
@pytest.mark.parametrize("triangular", [False, True])
def test_plain_sweep_matches_jax_kernel(mode, triangular):
    """dotscan_sweep_plain against dotscan_sweep(interpret=True), each on its
    package's lists (equal per row, test_tiles_equal_jax) with the same
    centers, a tenth of the atoms lifted into w: F and F+U, both list forms,
    against JAX's direct-difference form (dot_r2=False), finite in F (every
    self pair sits at the self gate); and both modes against the port's own
    sweep in f64."""
    conf, params, box = lattice_fluid(16, 0.03, seed=1, w_frac=0.1)
    cutoff = 1.2
    series = trs.es_energy_force_series(BETA, cutoff)
    tiles, atoms = _sweep_inputs(conf, params, box, cutoff, triangular, "hilbert")
    out = td.dotscan_sweep(
        atoms, tiles.row_start, tiles.row_count, tiles.col_ids, tiles.rcen_q, td.sweep_scalars(_t(box), cutoff),
        series, mode, triangular,
    ).numpy()
    # JAX's kernel reads each row's list in fours, so it takes JAX's lists, padded per row
    j = jd.build_dotscan_tiles(_j(conf), _j(params), _j(box), cutoff, max_pairs=10**5, triangular=triangular, sort="hilbert")
    a8 = jnp.asarray(atoms.numpy().T)
    ref = np.asarray(jd.dotscan_sweep(
        a8, a8.T, *j[1:5], jd._scalars(_j(box), cutoff), n_rows=atoms.shape[0] // 32, max_pairs=10**5,
        h_coeffs=series[0], p_coeffs=series[1], compute_u=mode == td.FORCE_ENERGY, interpret=True, triangular=triangular,
        dot_r2=False,
    ))
    assert np.isfinite(out).all()
    assert _max_rel(out[:, 1:4], ref[:, 1:4]) < TOL_F
    exact = td.dotscan_sweep(
        atoms.double(), tiles.row_start, tiles.row_count, tiles.col_ids, tiles.rcen_q,
        td.sweep_scalars(_t(box, torch.float64), cutoff), series, td.FORCE_ENERGY, triangular,
    ).numpy()
    assert _max_rel(out[:, 1:4], exact[:, 1:4]) < TOL_F
    if mode == td.FORCE_ENERGY:
        assert float(out[:, 0].sum()) == pytest.approx(float(ref[:, 0].sum()), rel=TOL_U)
    else:
        assert not out[:, 0].any()


def test_f32_dot_identity_departs_on_close_pairs():
    """Why the port takes F-mode r^2 from direct differences (ROADMAP R6): a
    fluid in which 128 atoms have a partner 0.1 nm away, as a protein's
    bonded neighbours sit in the all-pairs term. Against the same sweep in
    f64 (the f32 inputs, widened), the port's F mode and JAX's
    direct-difference form stay within 1e-5 of the largest |dU/dx|
    (measured 3e-6), while JAX's default dot-identity form departs by more
    than 5 times the port's error (measured 7e-5, from ~1e-7 nm^2 of
    cancellation on r^2)."""
    conf, params, box = lattice_fluid(12, 0.03, seed=7)
    d = np.random.default_rng(8).normal(size=(128, 3))
    conf = np.concatenate([conf, conf[:128] + 0.1 * d / np.linalg.norm(d, axis=1, keepdims=True)])
    params = np.concatenate([params, params[:128]])
    cutoff = 0.9
    series = trs.es_energy_force_series(BETA, cutoff)
    tiles, atoms = _sweep_inputs(conf, params, box, cutoff, True, "hilbert")
    assert int(tiles.invalid) == 0
    lists = (tiles.row_start, tiles.row_count, tiles.col_ids, tiles.rcen_q)
    out = td.dotscan_sweep(atoms, *lists, td.sweep_scalars(_t(box), cutoff), series, td.FORCE, True).numpy()
    exact = td.dotscan_sweep(
        atoms.double(), *lists, td.sweep_scalars(_t(box, torch.float64), cutoff), series, td.FORCE, True
    ).numpy()
    j = jd.build_dotscan_tiles(_j(conf), _j(params), _j(box), cutoff, max_pairs=10**5, triangular=True, sort="hilbert")
    a8 = jnp.asarray(atoms.numpy().T)
    err = {}
    for dot_r2 in (True, False):
        ref = np.asarray(jd.dotscan_sweep(
            a8, a8.T, *j[1:5], jd._scalars(_j(box), cutoff), n_rows=atoms.shape[0] // 32, max_pairs=10**5,
            h_coeffs=series[0], p_coeffs=series[1], compute_u=False, interpret=True, triangular=True, dot_r2=dot_r2,
        ))
        err[dot_r2] = _max_rel(ref[:, 1:4], exact[:, 1:4])
    port = _max_rel(out[:, 1:4], exact[:, 1:4])
    assert port < TOL_F and err[False] < TOL_F
    assert err[True] > 5 * port


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("triangular", [False, True])
def test_plain_dot_matches_plain_rowscan(fluid, triangular, dtype):
    """The same pair function two ways: the plain dot sweep (F+U and F)
    against the port's plain rowscan energy/force, on lists at a cutoff of
    0.9 nm where Hilbert rows pass the image bound. f32 at JAX's bounds
    (2e-5 energy, 5e-5 largest force); f64 to 1e-10."""
    conf, params, box = fluid
    cutoff = 0.9
    n = conf.shape[0]
    series = trs.es_energy_force_series(BETA, cutoff)
    ef = trs.make_nonbonded_rowscan_energy_force(BETA, cutoff, 10**5)
    u_ref, f_ref = ef(_t(conf, dtype), _t(params, dtype), _t(box, dtype))
    tiles, atoms = _sweep_inputs(conf, params, box, cutoff, triangular, "hilbert", dtype)
    assert int(tiles.invalid) == 0
    inv = torch.argsort(tiles.pad_order[:n])
    tol_u, tol_f = (2e-5, 5e-5) if dtype == torch.float32 else (1e-10, 1e-10)
    for mode in (td.FORCE_ENERGY, td.FORCE):
        out = td.dotscan_sweep(
            atoms, tiles.row_start, tiles.row_count, tiles.col_ids, tiles.rcen_q,
            td.sweep_scalars(_t(box, dtype), cutoff), series, mode, triangular,
        )
        assert _max_rel(-out[inv, 1:4].numpy(), f_ref.numpy()) < tol_f
        if mode == td.FORCE_ENERGY:
            assert float(out[:, 0].sum()) == pytest.approx(float(u_ref), rel=tol_u)


def _j_provider(cutoff, max_pairs, rebuild_interval=20):
    return jd.make_nonbonded_dotscan_md(
        BETA, cutoff, max_pairs, skin=SKIN, rebuild_interval=rebuild_interval, interpret=True, dot_r2=False,
        sort="hilbert",
    )


def test_md_provider_across_a_rebuild_matches_jax(fluid):
    """Three steps with a rebuild every two and 0.004 nm of drift a step, at
    cutoff 0.9 + skin: the port's forces equal make_nonbonded_dotscan_md's
    (F mode) at every step, and the energy through the cached lists (F+U)."""
    conf, params, box = fluid
    cutoff = 0.9
    max_pairs = td.suggest_max_pairs(_t(conf), _t(box), cutoff + SKIN, margin=1.4, triangular=True, sort="hilbert")
    j_init, j_apply, j_energy, *_ = _j_provider(cutoff, 2 * max_pairs, rebuild_interval=2)
    init, apply, energy = td.make_nonbonded_dotscan_md(BETA, cutoff, max_pairs, skin=SKIN, rebuild_interval=2, sort="hilbert")
    p32 = _j(params)
    j_state = j_init(_j(conf), p32, _j(box))
    state = init(_t(conf), _t(params), _t(box))
    rng = np.random.default_rng(0)
    x = conf.astype(np.float32)
    for t in range(3):
        _, f_j, j_state = j_apply(j_state, jnp.asarray(x), p32, _j(box), jnp.asarray(t))
        f, state = apply(state, _t(x), _t(params), _t(box), t)
        assert _max_rel(f.numpy(), f_j) < TOL_F, t
        x = (x + rng.normal(0, 0.004, size=x.shape)).astype(np.float32)
    assert int(state.invalid) == 0 and float(state.lists.margin) > 0
    u = float(energy(state, _t(x), _t(params), _t(box)))
    assert u == pytest.approx(float(j_energy(j_state, jnp.asarray(x), p32, _j(box))), rel=TOL_U)


def test_provider_poisons_like_jax(fluid):
    """NaN force and energy from an undersized capacity, and NaN force after
    a rebuild on the box scaled by 0.45 (the image bound broken), in both
    packages."""
    conf, params, box = fluid
    cutoff = 0.9
    p32 = _j(params)
    for cap, scale in ((8, 1.0), (10**5, 0.45)):
        j_init, j_apply, j_energy, *_ = _j_provider(cutoff, cap)
        init, apply, energy = td.make_nonbonded_dotscan_md(BETA, cutoff, cap, skin=SKIN, sort="hilbert")
        state, j_state = init(_t(conf), _t(params), _t(box)), j_init(_j(conf), p32, _j(box))
        c, b = conf * scale, box * scale
        t = 1 if scale == 1.0 else 0  # the shrunken box is seen at a rebuild
        f, state = apply(state, _t(c), _t(params), _t(b), t)
        _, f_j, j_state = j_apply(j_state, _j(c), p32, _j(b), jnp.asarray(t))
        assert bool(torch.isnan(f).all()) and np.isnan(np.asarray(f_j)).all()
        if scale == 1.0:
            assert np.isnan(float(energy(state, _t(c), _t(params), _t(b))))
            assert np.isnan(float(j_energy(j_state, _j(c), p32, _j(b))))


def test_atom_crossing_a_box_face_between_rebuilds():
    """An atom that crosses a box face between rebuilds keeps its pairs:
    each sweep wraps afresh and maps atoms to the row center's image, so
    its force through the cached lists equals its force after a fresh
    rebuild at the same coordinates (1e-4 relative; other lists, centers
    and summation orders), every force does to 1e-5 relative norm, and the
    JAX provider's cached force agrees. Unshifted 4.96 nm lattice at cutoff
    0.6 + skin."""
    conf, params, box = lattice_fluid(16, 0.03, seed=2)
    cutoff = 0.6
    init, apply, _ = td.make_nonbonded_dotscan_md(BETA, cutoff, 10**5, skin=SKIN, sort="hilbert")
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
    j_init, j_apply, *_ = _j_provider(cutoff, 10**5)
    p32 = _j(params)
    _, f_j, _ = j_apply(j_init(_j(conf), p32, _j(box)), _j(moved), p32, _j(box), jnp.asarray(1))
    assert _max_rel(f_cached.numpy(), f_j) < TOL_F


@pytest.mark.parametrize(
    "case, cutoff, want, want_sort",
    [("small", 1.2, "rowscan", None), ("dense", 0.5, "dot", "snake"), ("fluid", 0.9, "dot", "hilbert")],
)
def test_configure_dot_matches_jax(fluid, dense, case, cutoff, want, want_sort):
    """configure(kernel="dot") takes what configure_pallas takes: rowscan
    wholesale on a 3.1 nm box, dot with snake rows at water density, dot
    with Hilbert rows where snake rows fail the bound. Taken, the energy and
    force stay on the rowscan sweep and the MD provider runs the dotscan
    sweep."""
    conf, params, box = {"small": lattice_fluid(10, 0.03, seed=5), "fluid": fluid, "dense": dense}[case]
    n = conf.shape[0]
    pot = jpot.NonbondedAllPairs(n, beta=BETA, cutoff=cutoff)
    pot.configure_pallas(box, conf, interpret=True, kernel="dot")
    nb = NonbondedAllPairs(n, BETA, cutoff, params, device="cpu", dtype=F32).configure(_t(box), _t(conf), kernel="dot")
    assert pot.pallas_kernel == nb.kernel == want and nb.dot_sort == want_sort
    if want == "dot":
        rows, dots = trs.rowscan_sweep_plain.calls, td.dotscan_sweep_plain.calls
        nb.energy_force(_t(conf), _t(box))
        init, apply, _, _ = nb.md_force_provider()
        apply(init(_t(conf), _t(box)), _t(conf), _t(box), 0)
        assert (trs.rowscan_sweep_plain.calls, td.dotscan_sweep_plain.calls) == (rows + 1, dots + 1)


def test_langevin_steps_dot_vs_rowscan():
    """Ten Langevin steps at T = 0 (f64, dt 1 fs) of a Nonbonded term with
    500 excluded neighbour pairs, configured "dot" and "rowscan" from the
    same start: the same trajectory to 1e-9 nm (one pair function, other
    lists and summation orders), and both moved."""
    conf, params, box = lattice_fluid(14, 0.03, seed=4, spacing=0.31)
    n = conf.shape[0]
    exclusions = np.stack([np.arange(0, 1000, 2), np.arange(1, 1001, 2)], 1)
    scales = np.ones((len(exclusions), 2))
    masses = np.random.default_rng(5).uniform(1.0, 16.0, n)
    v0 = np.random.default_rng(6).normal(0, 0.5, (n, 3))
    runs = {}
    for kernel in ("dot", "rowscan"):
        nb = Nonbonded(n, exclusions, scales, BETA, 0.8, params, device="cpu", dtype=torch.float64)
        nb.configure(_t(box, torch.float64), _t(conf, torch.float64), kernel=kernel)
        assert nb.kernel == kernel
        ctxt = Context(conf, v0, box, LangevinIntegrator(0.0, 1e-3, 1.0, masses, seed=1), [nb], device="cpu")
        ctxt.multiple_steps(10)
        runs[kernel] = ctxt.get_x_t()
    np.testing.assert_allclose(runs["dot"], runs["rowscan"], rtol=0, atol=1e-9)
    assert np.abs(runs["dot"] - conf).max() > 1e-3


@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_cull_never_drops_a_pair(jitter):
    """The triangular kernel's cull (cull_mask: each column atom at the row
    center's image against the box of the row chunk's atoms at theirs)
    keeps every column atom that has a row atom within the cutoff at those
    images (the pair function's f32 differences), on the 3.4 nm water box's
    Hilbert lists at cutoff + skin, and again after 0.02 nm of random jitter
    that puts atoms across box faces (wrapped afresh, as every sweep wraps);
    it drops something, and cull_census counts columns <= swept < listed."""
    cfg = build_water_system(3.4)
    conf = np.asarray(cfg.conf, np.float32)
    params = np.asarray(cfg.host_system.nonbonded_all_pairs.params, np.float32)
    box_t = _t(cfg.box)
    tiles = td.build_dotscan_tiles(_t(conf), box_t, 1.2 + SKIN, 10**5, triangular=True, sort="hilbert")
    assert int(tiles.overflow) == 0
    moved = _t(conf) + _t(np.random.default_rng(5).normal(0.0, jitter, conf.shape))
    box_diag = torch.diagonal(box_t)
    if jitter:  # the jitter put atoms across faces
        assert bool((torch.floor(moved / box_diag) != torch.floor(_t(conf) / box_diag)).any())
    n = conf.shape[0]
    atoms = trs.assemble_atoms(moved, box_t, tiles.pad_order, trs.param_rows(_t(params), tiles.pad_order, n))
    scalars = td.sweep_scalars(box_t, 1.2)
    c = td.cull_mask(atoms, tiles.row_start, tiles.row_count, tiles.col_ids, tiles.rcen_q, scalars)
    n_rows, n_cols = atoms.shape[0] // td.ROW, atoms.shape[0] // td.COL
    comp = atoms.T.contiguous()
    cen = tiles.rcen_q.view(n_rows, 4)[:, :3].to(F32) * td.CEN_SCALE
    rd = torch.stack(trs._row_frame(comp.view(8, n_rows, td.ROW), cen, box_diag, 1.0 / box_diag)[:3], -1)
    cols = comp.view(8, n_cols, td.COL)[:, c.chunk, None, :]
    cd = torch.stack(trs._col_frame(cols, cen[c.rows], box_diag, 1.0 / box_diag)[:3], -1)[:, 0]
    for t0 in range(0, len(c.rows), 512):
        sl = slice(t0, t0 + 512)
        d = rd[c.rows[sl]][:, :, None, :] - cd[sl][:, None, :, :]  # (T, 32 rows, 128 cols, 3)
        near = ((d * d).sum(-1) < 1.2**2).any(1)  # (T, 128): columns with a row atom within the cutoff
        assert bool(c.column[sl][near].all())
    census = td.cull_census(atoms, tiles.row_start, tiles.row_count, tiles.col_ids, tiles.rcen_q, scalars)
    assert 0 < census.columns <= census.swept < census.listed
    assert census.listed == (int(tiles.row_count.sum()) + n_rows) * td.ROW * td.COL


def test_census_constants_mirror_the_kernel_source():
    """cull_census counts the kernel's work items with WARPS and SPLITS,
    constants of csrc/dotscan.cu that the module mirrors: they must agree."""
    source = (Path(td.__file__).parents[1] / "csrc" / "dotscan.cu").read_text()
    for name in ("WARPS", "SPLITS"):
        assert re.search(rf"constexpr int {name} = (\d+);", source).group(1) == str(getattr(td, name))
