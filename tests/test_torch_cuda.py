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
    tiles = rs.build_rowscan_tiles(conf, box, CUTOFF + skin, 10**7)
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
    out_k = rs.rowscan_sweep(*args, mode)
    out_p = rs.rowscan_sweep_plain(*args, mode)
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
        out_k = rs.rowscan_sweep(*args, mode)
        out_p = rs.rowscan_sweep_plain(*args, mode)
        assert _rel(out_k[:, 0], out_p[:, 0]) < TOL
        if mode == rs.FORCE_ENERGY:
            assert _rel(out_k[:, 1:4], out_p[:, 1:4]) < TOL


def test_kernel_is_bitwise_reproducible(cuda):
    args = _sweep_args(*_fluid(cuda, seed=1))
    assert torch.equal(rs.rowscan_sweep(*args, rs.FORCE_ENERGY), rs.rowscan_sweep(*args, rs.FORCE_ENERGY))


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    args = _sweep_args(*_fluid(cuda))
    with pytest.raises(ValueError):
        rs.rowscan_sweep(args[0].double(), *args[1:], rs.FORCE)
    with pytest.raises(ValueError):
        rs.rowscan_sweep(args[0], args[1].long(), *args[2:], rs.FORCE)
    with pytest.raises(ValueError):
        rs.rowscan_sweep(*args, 7)


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


def _tile_args(conf, params, box, cb=2):
    tiles = nbk.build_block_tiles(conf, params, box, CUTOFF, 10**6, cb)
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
@pytest.mark.parametrize("mode_name", list(NB_MODES))
def test_nb_tiles_kernel_matches_plain(cuda, mode_name, cb):
    mode, poly = NB_MODES[mode_name]
    es = nbk.es_switch_poly_coeffs(BETA, CUTOFF) if poly else None
    args = _tile_args(*_fluid(cuda, seed=3), cb=cb)
    before = nbk.nb_tiles.launches
    out_k = nbk.nb_tiles(*args, mode, cb, es)
    out_p = nbk.nb_tiles_plain(*args, mode, cb, es)
    torch.cuda.synchronize()
    assert nbk.nb_tiles.launches == before + 1
    assert _col_rel(out_k, out_p) < TOL


def test_nb_tiles_kernel_is_bitwise_reproducible(cuda):
    args = _tile_args(*_fluid(cuda, seed=4))
    for mode in (nbk.DP, nbk.UF):
        assert torch.equal(nbk.nb_tiles(*args, mode, 2), nbk.nb_tiles(*args, mode, 2))


def test_nb_tiles_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    args = _tile_args(*_fluid(cuda))
    with pytest.raises(ValueError):
        nbk.nb_tiles(args[0].double(), *args[1:], nbk.UF, 2)
    with pytest.raises(ValueError):
        nbk.nb_tiles(*args, nbk.DP, 2, nbk.es_switch_poly_coeffs(BETA, CUTOFF))
    with pytest.raises(ValueError):
        nbk.nb_tiles(*args, nbk.UF, 3)


def test_param_grad_runs_on_the_kernel(cuda):
    conf, params, box = _fluid(cuda, seed=5)
    energy = rs.make_nonbonded_rowscan(BETA, CUTOFF, max_pairs=10**6, dp_max_tiles=10**6)
    p = params.clone().requires_grad_(True)
    before_k, before_p = nbk.nb_tiles.launches, nbk.nb_tiles_plain.calls
    energy(conf, p, box).backward()
    assert bool(torch.isfinite(p.grad).all())
    assert nbk.nb_tiles.launches == before_k + 1 and nbk.nb_tiles_plain.calls == before_p
    dp_plain = nbk.nb_tiles_plain(*_tile_args(conf, params, box), nbk.DP, 2)
    tiles = nbk.build_block_tiles(conf, params, box, CUTOFF, 10**6, 2)
    assert _col_rel(p.grad, dp_plain[torch.argsort(tiles.pad_order[: conf.shape[0]])]) < TOL


# -- the gather and quadscan kernels (csrc/gather.cu, csrc/quadscan.cu) -----------

SERIES = rs.es_energy_force_series(BETA, CUTOFF)
SWEEP_MODES = {"F": rs.FORCE, "F+U": rs.FORCE_ENERGY}


def _gather_args(conf, params, box, cutoff=CUTOFF + 0.1):
    lists = gk.build_gather_neighbors(conf, box, cutoff, gk.suggest_max_nbrs(conf, box, cutoff))
    atoms = rs.assemble_atoms(conf, box, lists.pad_order, rs.param_rows(params, lists.pad_order, conf.shape[0]))
    return (atoms, lists.counts, lists.nbr, rs.sweep_scalars(box, CUTOFF), SERIES)


def _quad_args(conf, params, box, cutoff=CUTOFF + 0.1):
    tiles = qk.build_quadscan_tiles(conf, box, cutoff, qk.suggest_max_tiles(conf, box, cutoff))
    atoms = rs.assemble_atoms(conf, box, tiles.pad_order, rs.param_rows(params, tiles.pad_order, conf.shape[0]))
    return (atoms, tiles.row_start, tiles.row_count, tiles.entries, rs.sweep_scalars(box, CUTOFF), SERIES)


SWEEPS = {
    "gather": (gk.gather_sweep, gk.gather_sweep_plain, _gather_args),
    "quad": (qk.quadscan_sweep, qk.quadscan_sweep_plain, _quad_args),
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
    sweep, plain, make_args = SWEEPS[path]
    args = make_args(*(_fluid(cuda, seed=6) if size == "small" else _dhfr(cuda)))
    mode = SWEEP_MODES[mode_name]
    before = sweep.launches
    out_k = sweep(*args, mode)
    out_p = plain(*args, mode)
    torch.cuda.synchronize()
    assert sweep.launches == before + 1
    assert _col_rel(out_k, out_p) < TOL
    assert torch.equal(out_k, sweep(*args, mode))


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
    sweep, _, make_args = SWEEPS[path]
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
    all on the kernel."""
    sweep, plain, _ = SWEEPS[path]
    conf, params, box = _fluid(cuda, n_side=24, spacing=0.215, seed=7)
    cutoff = 0.9
    if path == "gather":
        provider = gk.make_nonbonded_gather_md(BETA, cutoff, gk.suggest_max_nbrs(conf, box, cutoff + 0.1, margin=1.4), rebuild_interval=1)
    else:
        assert qk.constant_shift_valid(conf, box, cutoff + 0.1)
        provider = qk.make_nonbonded_quadscan_md(BETA, cutoff, qk.suggest_max_tiles(conf, box, cutoff + 0.1, margin=1.4), rebuild_interval=1)
    init, apply, energy = provider
    before_k, before_p = sweep.launches, plain.calls
    state = init(conf, params, box)
    for t in range(2):
        force, state = apply(state, conf, params, box, t)
    u = energy(state, conf, params, box)
    assert bool(torch.isfinite(force).all()) and bool(torch.isfinite(u))
    assert sweep.launches == before_k + 3
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
