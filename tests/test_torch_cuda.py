"""The CUDA kernels (rowscan, block-tile, gather, quadscan and dotscan
sweeps, the FP32 and bf16 probes) against their plain PyTorch versions, on
a card.

Every test here needs a CUDA device and skips without one (decided in the
`cuda` fixture, never at import). This file imports no JAX, so it also runs
where JAX is not installed:

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: both sides are f32 and sum each atom's pairs in different
orders, and the kernel's rsqrt is approximate (2 ulp), so gradients and
per-atom energies agree to a relative norm of 1e-4 (measured ~1e-6). The
probes round every operation as their plain versions do: bit for bit.
"""

import numpy as np
import pytest
import torch

from timemachine_torch.ops import dotscan_kernel as dk
from timemachine_torch.ops import gather_kernel as gk
from timemachine_torch.ops import nonbonded_kernel as nbk
from timemachine_torch.ops import quadscan_kernel as qk
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.probes import bf16_rate as br
from timemachine_torch.probes import fp32_peak as fp

pytestmark = pytest.mark.cuda

TOL = 1e-4
BETA, CUTOFF = 2.0, 1.2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fluid(device, n_side=16, spacing=0.31, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3) * spacing
    n = len(pts) - 7  # a ragged last chunk
    conf = pts[:n] + rng.normal(0, 0.03, (n, 3))
    params = np.stack(
        [rng.uniform(-0.6, 0.6, n) * np.sqrt(138.935456), rng.uniform(0.05, 0.16, n),
         rng.uniform(0.05, 0.9, n) ** 0.5, rng.uniform(0.0, 0.2, n)], 1,
    )
    box = np.eye(3) * n_side * spacing
    f32 = dict(device=device, dtype=torch.float32)
    return torch.as_tensor(conf, **f32), torch.as_tensor(params, **f32), torch.as_tensor(box, **f32)


def _sweep_args(conf, params, box, skin=0.1):
    """Rowscan sweep arguments on Newton-triangular lists: the energy/force
    entry's form (minimum image, w) is built in every mode."""
    tiles = rs.build_rowscan_tiles(conf, box, CUTOFF + skin, 10**7, triangular=True)
    atoms = rs.assemble_atoms(conf, box, tiles.pad_order, rs.param_rows(params, tiles.pad_order, conf.shape[0]))
    row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, CUTOFF)
    series = rs.es_energy_force_series(BETA, CUTOFF)
    return (atoms, tiles.row_start, row_count, tiles.col_ids, rs.sweep_scalars(box, CUTOFF), series)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("mode", [rs.FORCE, rs.FORCE_ENERGY, rs.ENERGY])
def test_kernel_matches_plain(cuda, mode):
    args = _sweep_args(*_fluid(cuda))
    before = rs.rowscan_sweep.launches
    out_k = rs.rowscan_sweep(*args, mode, True)
    out_p = rs.rowscan_sweep_plain(*args, mode, True)
    torch.cuda.synchronize()
    assert rs.rowscan_sweep.launches == before + 1
    if mode != rs.ENERGY:
        assert _rel(out_k[:, 1:4], out_p[:, 1:4]) < TOL
    if mode != rs.FORCE:
        assert _rel(out_k[:, 0], out_p[:, 0]) < TOL


def test_kernel_matches_plain_dhfr(cuda):
    from timemachine_torch.testsystems.dhfr import setup_dhfr

    hc = setup_dhfr(device=cuda, dtype=torch.float32)
    conf = torch.as_tensor(hc.conf, device=cuda, dtype=torch.float32)
    box = torch.as_tensor(hc.box, device=cuda, dtype=torch.float32)
    args = _sweep_args(conf, hc.host_system.nonbonded_all_pairs.params, box)
    assert args[0].shape == (23_808, 8)
    for mode in (rs.FORCE_ENERGY, rs.ENERGY):
        out_k = rs.rowscan_sweep(*args, mode, True)
        out_p = rs.rowscan_sweep_plain(*args, mode, True)
        assert _rel(out_k[:, 0], out_p[:, 0]) < TOL
        if mode == rs.FORCE_ENERGY:
            assert _rel(out_k[:, 1:4], out_p[:, 1:4]) < TOL


def test_kernel_is_bitwise_reproducible(cuda):
    args = _sweep_args(*_fluid(cuda, seed=1))
    assert torch.equal(rs.rowscan_sweep(*args, rs.FORCE_ENERGY, True), rs.rowscan_sweep(*args, rs.FORCE_ENERGY, True))


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    args = _sweep_args(*_fluid(cuda))
    with pytest.raises(ValueError):
        rs.rowscan_sweep(args[0].double(), *args[1:], rs.FORCE)
    with pytest.raises(ValueError):
        rs.rowscan_sweep(args[0], args[1].long(), *args[2:], rs.FORCE)
    with pytest.raises(ValueError):
        rs.rowscan_sweep(*args, 7)
    with pytest.raises(ValueError):  # row centers of the wrong length
        rs.rowscan_sweep(*args, rs.FORCE, True, torch.zeros(3, dtype=torch.int32, device=cuda))


def _form_args(device, triangular, preshift):
    """Sweep arguments on Hilbert rows at the bare cutoff, where this fluid
    holds the image bound, and the row centers where preshift is asked."""
    return _hilbert_form_args(*_fluid(device, seed=1), triangular, preshift)


def _hilbert_form_args(conf, params, box, triangular, preshift):
    tiles = dk.build_dotscan_tiles(conf, box, CUTOFF, 10**7, triangular=triangular, sort="hilbert")
    assert int(tiles.invalid) == 0
    atoms = rs.assemble_atoms(conf, box, tiles.pad_order, rs.param_rows(params, tiles.pad_order, conf.shape[0]))
    args = (atoms, tiles.row_start, tiles.row_count, tiles.col_ids, rs.sweep_scalars(box, CUTOFF), rs.es_energy_force_series(BETA, CUTOFF))
    return args, tiles.rcen_q if preshift else None


# the forms (mode, triangular, preshift, has_w) the kernel is built for, the
# ones a configuration launches: triangular F and U in every form (the MD
# providers), triangular F+U with minimum image and w (the energy/force
# entry), symmetric F with minimum image and w (the yardstick)
ROWSCAN_BUILT = {
    *((mode, True, pre, w) for mode in (rs.FORCE, rs.ENERGY) for pre in (False, True) for w in (False, True)),
    (rs.FORCE_ENERGY, True, False, True),
    (rs.FORCE, False, False, True),
}


@pytest.mark.parametrize("has_w", [True, False])
@pytest.mark.parametrize("preshift", [False, True])
@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("mode", [rs.FORCE, rs.FORCE_ENERGY, rs.ENERGY])
def test_kernel_forms_match_plain(cuda, mode, triangular, preshift, has_w):
    """Every built form of the kernel (mode x list form x images x w)
    against the plain version per output column, the columns a mode leaves
    out zero, two launches bitwise equal (the triangular form sums in int64
    fixed point); a form that is not built is refused by the launcher (CUDA
    error 1, invalid value) and launches nothing."""
    args, rcen_q = _form_args(cuda, triangular, preshift)
    kw = dict(triangular=triangular, rcen_q=rcen_q, has_w=has_w)
    before = rs.rowscan_sweep.launches
    if (mode, triangular, preshift, has_w) not in ROWSCAN_BUILT:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            rs.rowscan_sweep(*args, mode, **kw)
        assert rs.rowscan_sweep.launches == before
        return
    out_k, out_k2 = rs.rowscan_sweep(*args, mode, **kw), rs.rowscan_sweep(*args, mode, **kw)
    out_p = rs.rowscan_sweep_plain(*args, mode, **kw)
    torch.cuda.synchronize()
    assert rs.rowscan_sweep.launches == before + 2
    assert torch.equal(out_k, out_k2)
    for col in range(4):
        if not out_p[:, col].any():
            assert not out_k[:, col].any()
        else:
            assert _rel(out_k[:, col], out_p[:, col]) < TOL, col


def test_provider_runs_on_the_kernel(cuda):
    conf, params, box = _fluid(cuda, seed=2)
    init, apply, energy = rs.make_nonbonded_rowscan_md(BETA, CUTOFF, max_pairs=10**6)
    before_k, before_p = rs.rowscan_sweep.launches, rs.rowscan_sweep_plain.calls
    state = init(conf, params, box)
    force, state = apply(state, conf, params, box, 0)
    u = energy(state, conf, params, box)
    assert bool(torch.isfinite(force).all()) and bool(torch.isfinite(u))
    assert rs.rowscan_sweep.launches == before_k + 2
    assert rs.rowscan_sweep_plain.calls == before_p


# -- the block-tile kernel (csrc/nb_tiles.cu) -----------------------------------

NB_MODES = {
    "DP": (nbk.DP, False),
    "UF-exact": (nbk.UF, False),
    "UF-poly": (nbk.UF, True),
    "F": (nbk.FORCE, False),
}
# the forms the kernel is built for: every mode triangular, the first
# design (symmetric) in DP and F
NB_FORMS = [("triangular", m) for m in NB_MODES] + [("symmetric", "DP"), ("symmetric", "F")]


def _tile_args(conf, params, box, cb=2, triangular=False):
    tiles = nbk.build_block_tiles(conf, params, box, CUTOFF, 10**6, cb, triangular)
    return (tiles.atoms, tiles.row_start, tiles.row_count, tiles.col_ids, nbk.tile_scalars(box, BETA, CUTOFF))


def _col_rel(out_k, out_p):
    """Largest per-column relative norm; a column that is zero in the plain
    version must be zero in the kernel's output too."""
    worst = 0.0
    for a in range(4):
        norm = float(torch.linalg.vector_norm(out_p[:, a]))
        if norm == 0:
            assert not bool(out_k[:, a].any())
        else:
            worst = max(worst, float(torch.linalg.vector_norm(out_k[:, a] - out_p[:, a])) / norm)
    return worst


@pytest.mark.parametrize("cb", [1, 2])
@pytest.mark.parametrize("form,mode_name", NB_FORMS)
def test_nb_tiles_kernel_matches_plain(cuda, form, mode_name, cb):
    """Every built form against the plain version per column (the fluid's
    w offsets lift dU/dw), at cb 1 and 2."""
    mode, poly = NB_MODES[mode_name]
    tri = form == "triangular"
    es = nbk.es_switch_poly_coeffs(BETA, CUTOFF) if poly else None
    args = _tile_args(*_fluid(cuda, seed=3), cb=cb, triangular=tri)
    before = nbk.nb_tiles.launches
    out_k = nbk.nb_tiles(*args, mode, cb, es, triangular=tri)
    out_p = nbk.nb_tiles_plain(*args, mode, cb, es, triangular=tri)
    torch.cuda.synchronize()
    assert nbk.nb_tiles.launches == before + 1
    assert _col_rel(out_k, out_p) < TOL


def test_nb_tiles_kernel_is_bitwise_reproducible(cuda):
    """Two launches bitwise equal: the triangular form sums in int64 fixed
    point, the symmetric one in a fixed order."""
    conf, params, box = _fluid(cuda, seed=4)
    for tri, modes in ((True, (nbk.DP, nbk.UF, nbk.FORCE)), (False, (nbk.DP, nbk.FORCE))):
        args = _tile_args(conf, params, box, triangular=tri)
        for mode in modes:
            assert torch.equal(nbk.nb_tiles(*args, mode, 2, triangular=tri), nbk.nb_tiles(*args, mode, 2, triangular=tri))


def test_nb_tiles_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    """Bad arguments raise before a launch; a form the kernel is not built
    for is refused by the launcher (CUDA error 1, invalid value) and
    launches nothing."""
    args = _tile_args(*_fluid(cuda))
    with pytest.raises(ValueError):
        nbk.nb_tiles(args[0].double(), *args[1:], nbk.UF, 2)
    with pytest.raises(ValueError):
        nbk.nb_tiles(*args, nbk.DP, 2, nbk.es_switch_poly_coeffs(BETA, CUTOFF))
    with pytest.raises(ValueError):
        nbk.nb_tiles(*args, nbk.UF, 3)
    poly = nbk.es_switch_poly_coeffs(BETA, CUTOFF)
    before = nbk.nb_tiles.launches
    for mode, es, tri in ((nbk.UF, None, False), (nbk.UF, poly, False), (nbk.FORCE, poly, False), (nbk.FORCE, poly, True)):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            nbk.nb_tiles(*args, mode, 2, es, triangular=tri)
    assert nbk.nb_tiles.launches == before


def test_nb_tiles_fixed_point_overflow_gives_nan(cuda):
    """Two atoms 0.01 nm apart with sigma 0.3 nm: dU/d(sig/2) of about
    1e20, far beyond the fixed-point range, comes back NaN from the
    triangular kernel (every column, every atom), never a wrapped sum; the
    same lists without that pair stay finite."""
    conf, params, box = _fluid(cuda, seed=11)
    args = _tile_args(conf, params, box, triangular=True)
    assert bool(torch.isfinite(nbk.nb_tiles(*args, nbk.DP, 2, triangular=True)).all())
    conf, params = conf.clone(), params.clone()
    conf[1] = conf[0] + torch.tensor([0.01, 0.0, 0.0], device=cuda)
    params[0, 3] = params[1, 3] = 0.0
    params[:2, 1] = 0.15
    params[:2, 2] = 1.0
    out = nbk.nb_tiles(*_tile_args(conf, params, box, triangular=True), nbk.DP, 2, triangular=True)
    assert bool(torch.isnan(out).all())


def test_param_grad_runs_on_the_kernel(cuda):
    conf, params, box = _fluid(cuda, seed=5)
    energy = rs.make_nonbonded_rowscan(BETA, CUTOFF, max_pairs=10**6, dp_max_tiles=10**6)
    p = params.clone().requires_grad_(True)
    before_k, before_p = nbk.nb_tiles.launches, nbk.nb_tiles_plain.calls
    energy(conf, p, box).backward()
    assert bool(torch.isfinite(p.grad).all())
    assert nbk.nb_tiles.launches == before_k + 1 and nbk.nb_tiles_plain.calls == before_p
    dp_plain = nbk.nb_tiles_plain(*_tile_args(conf, params, box, triangular=True), nbk.DP, 2, triangular=True)
    tiles = nbk.build_block_tiles(conf, params, box, CUTOFF, 10**6, 2, triangular=True)
    assert _col_rel(p.grad, dp_plain[torch.argsort(tiles.pad_order[: conf.shape[0]])]) < TOL


# -- the gather and quadscan kernels (csrc/gather.cu, csrc/quadscan.cu) -----------

SERIES = rs.es_energy_force_series(BETA, CUTOFF)
SWEEP_MODES = {"F": rs.FORCE, "F+U": rs.FORCE_ENERGY}


def _gather_args(conf, params, box, cutoff=CUTOFF + 0.1):
    lists = gk.build_gather_neighbors(conf, box, cutoff, gk.suggest_max_nbrs(conf, box, cutoff))
    atoms = rs.assemble_atoms(conf, box, lists.pad_order, rs.param_rows(params, lists.pad_order, conf.shape[0]))
    return (atoms, lists.counts, lists.nbr, lists.tri_start, rs.sweep_scalars(box, CUTOFF), SERIES)


def _gather_plain(atoms, counts, nbr, tri_start, scalars, series, mode):
    """gather_sweep_plain on gather_sweep's arguments: the full lists (the
    suffixes start are the kernel's alone)."""
    return gk.gather_sweep_plain(atoms, counts, nbr, scalars, series, mode)


def _quad_args(conf, params, box, cutoff=CUTOFF + 0.1):
    tiles = qk.build_quadscan_tiles(conf, box, cutoff, qk.suggest_max_tiles(conf, box, cutoff))
    atoms = rs.assemble_atoms(conf, box, tiles.pad_order, rs.param_rows(params, tiles.pad_order, conf.shape[0]))
    return (atoms, tiles.row_start, tiles.row_count, tiles.entries, rs.sweep_scalars(box, CUTOFF), SERIES)


# each list path: (the kernel's wrapper, its plain version as the wrapper
# is called, the plain version's call counter, the sweep arguments)
SWEEPS = {
    "gather": (gk.gather_sweep, _gather_plain, gk.gather_sweep_plain, _gather_args),
    "quad": (qk.quadscan_sweep, qk.quadscan_sweep_plain, qk.quadscan_sweep_plain, _quad_args),
}


def _dhfr(device):
    from timemachine_torch.testsystems.dhfr import setup_dhfr

    hc = setup_dhfr(device=device, dtype=torch.float32)
    conf = torch.as_tensor(hc.conf, device=device, dtype=torch.float32)
    box = torch.as_tensor(hc.box, device=device, dtype=torch.float32)
    return conf, hc.host_system.nonbonded_all_pairs.params, box


@pytest.mark.parametrize("size", ["small", "dhfr"])
@pytest.mark.parametrize("mode_name", list(SWEEP_MODES))
@pytest.mark.parametrize("path", list(SWEEPS))
def test_list_kernels_match_plain(cuda, path, mode_name, size):
    """Every mode, at a small fluid and at DHFR shapes: per-column relative
    norm within TOL, two launches bitwise equal (no float atomics)."""
    sweep, plain, _, make_args = SWEEPS[path]
    args = make_args(*(_fluid(cuda, seed=6) if size == "small" else _dhfr(cuda)))
    mode = SWEEP_MODES[mode_name]
    before = sweep.launches
    out_k = sweep(*args, mode)
    out_p = plain(*args, mode)
    torch.cuda.synchronize()
    assert sweep.launches == before + 1
    assert _col_rel(out_k, out_p) < TOL
    assert torch.equal(out_k, sweep(*args, mode))


@pytest.mark.parametrize("size", ["small", "dhfr"])
@pytest.mark.parametrize("mode_name", list(SWEEP_MODES))
def test_quad_kernel_without_w_matches_plain(cuda, mode_name, size):
    """The quad redesign's has_w=False form in both modes, at a small fluid
    (w lifted, which both sides leave out of r^2; a ragged last chunk) and
    at DHFR shapes: per-column relative norm within TOL, two launches
    bitwise equal, padding atoms zero."""
    conf, params, box = _fluid(cuda, seed=6) if size == "small" else _dhfr(cuda)
    args = _quad_args(conf, params, box)
    mode = SWEEP_MODES[mode_name]
    before = qk.quadscan_sweep.launches
    out_k = qk.quadscan_sweep(*args, mode, has_w=False)
    out_p = qk.quadscan_sweep_plain(*args, mode, has_w=False)
    torch.cuda.synchronize()
    assert qk.quadscan_sweep.launches == before + 1
    assert _col_rel(out_k, out_p) < TOL
    assert torch.equal(out_k, qk.quadscan_sweep(*args, mode, has_w=False))
    assert not out_k[conf.shape[0] :].any()


@pytest.mark.parametrize("size", ["small", "dhfr"])
def test_quad_first_design_matches_plain(cuda, size):
    """The quad kernel's first design, kept in F mode with w as the redesign's
    yardstick: within TOL of the plain version, bitwise on repeat, padding
    atoms zero; the launcher refuses the forms it is not built for."""
    conf, params, box = _fluid(cuda, seed=6) if size == "small" else _dhfr(cuda)
    args = _quad_args(conf, params, box)
    out_k = qk.quadscan_sweep(*args, rs.FORCE, first_design=True)
    out_p = qk.quadscan_sweep_plain(*args, rs.FORCE)
    torch.cuda.synchronize()
    assert _col_rel(out_k, out_p) < TOL
    assert torch.equal(out_k, qk.quadscan_sweep(*args, rs.FORCE, first_design=True))
    assert not out_k[conf.shape[0] :].any()
    with pytest.raises(ValueError):
        qk.quadscan_sweep(*args, rs.FORCE_ENERGY, first_design=True)
    with pytest.raises(ValueError):
        qk.quadscan_sweep(*args, rs.FORCE, has_w=False, first_design=True)


@pytest.mark.parametrize("size", ["small", "dhfr"])
def test_gather_first_design_matches_plain(cuda, size):
    """The gather kernel's first design, kept in F mode over the full lists
    as the redesign's yardstick: within TOL of the plain version, bitwise on
    repeat, padding atoms zero; the wrapper refuses F+U."""
    conf, params, box = _fluid(cuda, seed=6) if size == "small" else _dhfr(cuda)
    args = _gather_args(conf, params, box)
    out_k = gk.gather_sweep(*args, rs.FORCE, first_design=True)
    out_p = _gather_plain(*args, rs.FORCE)
    torch.cuda.synchronize()
    assert _col_rel(out_k, out_p) < TOL
    assert torch.equal(out_k, gk.gather_sweep(*args, rs.FORCE, first_design=True))
    assert not out_k[conf.shape[0] :].any()
    with pytest.raises(ValueError):
        gk.gather_sweep(*args, rs.FORCE_ENERGY, first_design=True)


def _real_last_quarter(atoms):
    """The quad sweep's arguments with the all-padding last quarter filled
    by real atoms: chunk 0's, 0.2 nm along x."""
    atoms = atoms.clone()
    atoms[-qk.Q :] = atoms[: qk.Q]
    atoms[-qk.Q :, 0] += 0.2
    return atoms


def test_quad_kernel_computes_padding_entries(cuda):
    """Entries that point at the last quarter (the builder's padding) are
    computed like any other: with real atoms in that quarter the kernel
    still matches the plain version, which computes every listed entry, so
    a caller's lists that put real atoms there lose no pairs."""
    atoms, *rest = _quad_args(*_fluid(cuda, seed=8))
    atoms = _real_last_quarter(atoms)
    for mode in SWEEP_MODES.values():
        out_k = qk.quadscan_sweep(atoms, *rest, mode)
        out_p = qk.quadscan_sweep_plain(atoms, *rest, mode)
        assert bool(out_p[-qk.Q :, 1:4].any())  # the padding entries reach real pairs
        assert _col_rel(out_k, out_p) < TOL


@pytest.mark.parametrize("path", list(SWEEPS))
def test_list_wrappers_reject_what_the_kernel_cannot_take(cuda, path):
    sweep, _, _, make_args = SWEEPS[path]
    args = make_args(*_fluid(cuda))
    with pytest.raises(ValueError):
        sweep(args[0].double(), *args[1:], rs.FORCE)
    with pytest.raises(ValueError):
        sweep(args[0], args[1].long(), *args[2:], rs.FORCE)
    with pytest.raises(ValueError):
        sweep(args[0][:-32], *args[1:], rs.FORCE)
    with pytest.raises(ValueError):
        sweep(*args, rs.ENERGY)


@pytest.mark.parametrize("path", list(SWEEPS))
def test_list_providers_run_on_their_kernels(cuda, path):
    """A 5.16 nm lattice fluid at cutoff 0.9 (the quad shift invariant
    holds at cutoff + skin there): two steps across a rebuild and an energy,
    all on the kernel. Its closest pairs (0.042 nm) put |dU/dx| at up to
    1.65e10, past the kernels' fixed-point range (2^30): both providers
    return NaN there, never a wrapped finite sum, and a finite result on a
    6.0 nm fluid at 0.25 nm spacing (|dU/dx| up to 1.5e7)."""
    sweep, _, plain, _ = SWEEPS[path]
    cutoff = 0.9
    before_k, before_p = sweep.launches, plain.calls

    def run(conf, params, box):
        if path == "gather":
            max_nbrs = gk.suggest_max_nbrs(conf, box, cutoff + 0.1, margin=1.4)
            init, apply, energy = gk.make_nonbonded_gather_md(BETA, cutoff, max_nbrs, rebuild_interval=1)
        else:
            assert qk.constant_shift_valid(conf, box, cutoff + 0.1)
            max_tiles = qk.suggest_max_tiles(conf, box, cutoff + 0.1, margin=1.4)
            init, apply, energy = qk.make_nonbonded_quadscan_md(BETA, cutoff, max_tiles, rebuild_interval=1)
        state = init(conf, params, box)
        for t in range(2):
            force, state = apply(state, conf, params, box, t)
        return force, energy(state, conf, params, box)

    force, u = run(*_fluid(cuda, n_side=24, spacing=0.215, seed=7))
    assert bool(torch.isnan(force).all()) and bool(torch.isnan(u))
    force, u = run(*_fluid(cuda, n_side=24, spacing=0.25, seed=7))
    assert bool(torch.isfinite(force).all()) and bool(torch.isfinite(u))
    assert sweep.launches == before_k + 6
    assert plain.calls == before_p


# -- the dotscan kernel (csrc/dotscan.cu) ------------------------------------------


def _dot_args(conf, params, box, triangular, sort, cutoff=CUTOFF + 0.1, max_pairs=10**6):
    tiles = dk.build_dotscan_tiles(conf, box, cutoff, max_pairs, triangular=triangular, sort=sort)
    atoms = rs.assemble_atoms(conf, box, tiles.pad_order, rs.param_rows(params, tiles.pad_order, conf.shape[0]))
    return (atoms, tiles.row_start, tiles.row_count, tiles.col_ids, tiles.rcen_q, rs.sweep_scalars(box, CUTOFF), SERIES)


@pytest.mark.parametrize("size", ["small", "dhfr"])
@pytest.mark.parametrize("mode_name", list(SWEEP_MODES))
@pytest.mark.parametrize("triangular", [False, True])
def test_dotscan_kernel_matches_plain(cuda, triangular, mode_name, size):
    """Both list forms and both modes, at a small fluid (w lifted, a ragged
    last chunk, so padding rows and the all-padding chunk) on Hilbert rows
    and at DHFR shapes on snake rows: per-column relative norm within TOL,
    two launches bitwise equal, padding atoms zero."""
    conf, params, box = _fluid(cuda, seed=9) if size == "small" else _dhfr(cuda)
    args = _dot_args(conf, params, box, triangular, "hilbert" if size == "small" else "snake")
    mode = SWEEP_MODES[mode_name]
    before = dk.dotscan_sweep.launches
    out_k = dk.dotscan_sweep(*args, mode, triangular)
    out_p = dk.dotscan_sweep_plain(*args, mode, triangular)
    torch.cuda.synchronize()
    assert dk.dotscan_sweep.launches == before + 1
    assert _col_rel(out_k, out_p) < TOL
    assert torch.equal(out_k, dk.dotscan_sweep(*args, mode, triangular))
    assert not out_k[conf.shape[0] :].any()


def test_dotscan_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    args = _dot_args(*_fluid(cuda), True, "hilbert")
    with pytest.raises(ValueError):
        dk.dotscan_sweep(args[0].double(), *args[1:], rs.FORCE, True)
    with pytest.raises(ValueError):
        dk.dotscan_sweep(*args[:4], args[4].long(), *args[5:], rs.FORCE, True)
    with pytest.raises(ValueError):
        dk.dotscan_sweep(args[0][:-32], *args[1:], rs.FORCE, True)
    with pytest.raises(ValueError):
        dk.dotscan_sweep(*args, rs.ENERGY, True)


def test_dotscan_provider_runs_on_the_kernel(cuda):
    """Two steps across a rebuild and an energy, all on the kernel, at
    cutoff 0.9 + skin (Hilbert rows pass the image bound on this 4.96 nm
    box there, not at 1.2); an undersized capacity poisons the force with
    NaN, still on the kernel."""
    conf, params, box = _fluid(cuda, seed=10)
    cutoff = 0.9
    before_k, before_p = dk.dotscan_sweep.launches, dk.dotscan_sweep_plain.calls
    init, apply, energy = dk.make_nonbonded_dotscan_md(BETA, cutoff, 10**6, rebuild_interval=1, sort="hilbert")
    state = init(conf, params, box)
    for t in range(2):
        force, state = apply(state, conf, params, box, t)
    u = energy(state, conf, params, box)
    assert int(state.invalid) == 0 and bool(torch.isfinite(force).all()) and bool(torch.isfinite(u))
    init, apply, _ = dk.make_nonbonded_dotscan_md(BETA, cutoff, 8, sort="hilbert")
    force, _ = apply(init(conf, params, box), conf, params, box, 1)
    assert bool(torch.isnan(force).all())
    assert dk.dotscan_sweep.launches == before_k + 4
    assert dk.dotscan_sweep_plain.calls == before_p


# -- the redesigns on aged lists, and past the fixed-point range --------------------


def _aged_args(path, device):
    """A small fluid's gather, quad or triangular dot sweep arguments on
    lists built before 0.02 nm of random jitter that puts atoms across box
    faces, the atoms placed as each MD provider places them between
    rebuilds: quad at their build-time images, gather and dot wrapped
    afresh."""
    conf, params, box = _fluid(device, seed=12)
    jitter = np.random.default_rng(13).normal(0.0, 0.02, tuple(conf.shape))
    moved = conf + torch.as_tensor(jitter, device=device, dtype=conf.dtype)
    box_diag = torch.diagonal(box)
    image = torch.floor(conf / box_diag)
    assert bool((torch.floor(moved / box_diag) != image).any())  # the jitter put atoms across faces
    n, cutoff = conf.shape[0], CUTOFF + 0.1
    if path == "gather":
        lists = gk.build_gather_neighbors(conf, box, cutoff, gk.suggest_max_nbrs(conf, box, cutoff))
        atoms = rs.assemble_atoms(moved, box, lists.pad_order, rs.param_rows(params, lists.pad_order, n))
        return (atoms, lists.counts, lists.nbr, lists.tri_start, rs.sweep_scalars(box, CUTOFF), SERIES)
    if path == "quad":
        tiles = qk.build_quadscan_tiles(conf, box, cutoff, qk.suggest_max_tiles(conf, box, cutoff))
        xyz = (moved - box_diag * image)[tiles.pad_order]
        atoms = torch.cat([xyz, rs.param_rows(params, tiles.pad_order, n), xyz.new_zeros((xyz.shape[0], 1))], dim=1)
        return (atoms, tiles.row_start, tiles.row_count, tiles.entries, rs.sweep_scalars(box, CUTOFF), SERIES)
    tiles = dk.build_dotscan_tiles(conf, box, cutoff, 10**6, triangular=True, sort="hilbert")
    atoms = rs.assemble_atoms(moved, box, tiles.pad_order, rs.param_rows(params, tiles.pad_order, n))
    return (atoms, tiles.row_start, tiles.row_count, tiles.col_ids, tiles.rcen_q, rs.sweep_scalars(box, CUTOFF), SERIES)


# each redesigned form: (its path, the kernel, its plain version), called as f(args, mode)
REDESIGNED = {
    "gather": ("gather", lambda a, m: gk.gather_sweep(*a, m), lambda a, m: _gather_plain(*a, m)),
    "quad": ("quad", lambda a, m: qk.quadscan_sweep(*a, m), lambda a, m: qk.quadscan_sweep_plain(*a, m)),
    "quad no-w": (
        "quad", lambda a, m: qk.quadscan_sweep(*a, m, has_w=False),
        lambda a, m: qk.quadscan_sweep_plain(*a, m, has_w=False),
    ),
    "dot": ("dot", lambda a, m: dk.dotscan_sweep(*a, m, True), lambda a, m: dk.dotscan_sweep_plain(*a, m, True)),
}


@pytest.mark.parametrize("mode_name", list(SWEEP_MODES))
@pytest.mark.parametrize("form", list(REDESIGNED))
def test_redesigns_on_aged_lists_match_plain(cuda, form, mode_name):
    """The gather, quad and dot kernels cull at every sweep, on the atoms as
    they are, so atoms that moved or crossed a box face since the lists were
    built must lose no pair: each form, in each mode, stays within TOL of
    its plain version (which sweeps every listed slot) and two launches are
    bitwise equal."""
    path, sweep, plain = REDESIGNED[form]
    args = _aged_args(path, cuda)
    mode = SWEEP_MODES[mode_name]
    out_k = sweep(args, mode)
    out_p = plain(args, mode)
    torch.cuda.synchronize()
    assert _col_rel(out_k, out_p) < TOL
    assert torch.equal(out_k, sweep(args, mode))


def _rowscan_overflow_form(form):
    """(sweep arguments from conf, params, box; the sweep on them) of a
    triangular rowscan form: the energy/force entry's (minimum image, w) or
    the main path's (row-center images, no w; its F and the barostat's U)."""
    if form == "rowscan":
        return (lambda c, p, box: (_sweep_args(c, p, box), None)), {}
    return (lambda c, p, box: _hilbert_form_args(c, p, box, True, True)), {"has_w": False}


# every form that sums in fixed point, in each mode its paths launch
OVERFLOW_CASES = [(form, m) for form in REDESIGNED for m in SWEEP_MODES] + [
    ("rowscan", "F"), ("rowscan", "F+U"), ("rowscan main form", "F"), ("rowscan main form", "U"),
]


@pytest.mark.parametrize("form,mode_name", OVERFLOW_CASES)
def test_redesigns_fixed_point_overflow_gives_nan(cuda, form, mode_name):
    """Two atoms 0.01 nm apart with sigma 0.3 nm: a pair force of about
    1e21 and an energy of about 1e19, far beyond the fixed-point range,
    come back NaN from the gather, quad, triangular dot and triangular
    rowscan kernels (every column, every atom) in F and in F+U or U (a
    barostat trial), never a wrapped finite sum; the same fluid without
    that pair stays finite."""
    mode = {**SWEEP_MODES, "U": rs.ENERGY}[mode_name]
    conf, params, box = _fluid(cuda, seed=11)
    if form.startswith("rowscan"):
        make, kw = _rowscan_overflow_form(form)

        def run(c, p):
            args, rcen_q = make(c, p, box)
            return rs.rowscan_sweep(*args, mode, triangular=True, rcen_q=rcen_q, **kw)
    else:
        path, sweep, _ = REDESIGNED[form]
        make_args = {"gather": _gather_args, "quad": _quad_args}.get(path)

        def run(c, p):
            return sweep(make_args(c, p, box) if make_args else _dot_args(c, p, box, True, "hilbert"), mode)

    assert bool(torch.isfinite(run(conf, params)).all())
    conf, params = conf.clone(), params.clone()
    conf[1] = conf[0] + torch.tensor([0.01, 0.0, 0.0], device=cuda)
    params[0, 3] = params[1, 3] = 0.0
    params[:2, 1] = 0.15
    params[:2, 2] = 1.0
    assert bool(torch.isnan(run(conf, params)).all())


# -- the probes (csrc/probe_fma.cu, csrc/probe_bf16.cu) ---------------------------


def test_fp32_peak_probe_matches_plain(cuda):
    x = fp.inputs(cuda, shape=(64, 1024))
    before = fp.fp32_peak.launches
    out_k = fp.fp32_peak(x)
    out_p = fp.fp32_peak_plain(x)
    assert fp.fp32_peak.launches == before + 1
    assert bool(torch.isfinite(out_k).all()) and torch.equal(out_k, out_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_rate_probe_matches_plain(cuda, dtype):
    a, b = br.inputs(cuda)
    before = br.bf16_rate.launches
    out_k = br.bf16_rate(a, b, dtype)
    out_p = br.bf16_rate_plain(a, b, dtype)
    assert br.bf16_rate.launches == before + 1
    assert torch.equal(out_k, out_p) and float(out_k.sum()) > 0
