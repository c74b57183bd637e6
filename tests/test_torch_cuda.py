"""The CUDA kernels (rowscan, with its replica-batched masked form, its
row slab and its sweep on the sorted-state step's pad-ordered coordinates,
block-tile, gather, quadscan and dotscan sweeps, the FP32 and bf16 probes,
the latter in both designs) against their plain PyTorch versions, and the
tile census against its CPU run, on a card.

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
from timemachine_torch.probes import tile_census as tc

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
    from timemachine_torch.testsystems.dhfr import setup_dhfr_native

    hc = setup_dhfr_native(waters_first=True, device=cuda, dtype=torch.float32)
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


# -- the row slab (rowscan_sweep with row_base, n_rows_local; rowscan_sweep_sharded) ----------


def _slabs(n_rows, d):
    """The spatial runner's split of n_rows row chunks over d ranks: (row_base, n_rows_local) each."""
    local = -(-n_rows // d)
    return [(r * local, min(local, n_rows - r * local)) for r in range(d) if r * local < n_rows]


def _slab_outputs(args, mode, triangular, slabs):
    """Each slab's stored output, and the whole-range result of the slabs:
    the int64 accumulators summed and stored (triangular), or the outputs
    summed (symmetric: every row is one slab's)."""
    stored, accs = [], []
    for base, local in slabs:
        reduce = (lambda acc: accs.append(acc.clone())) if triangular else None
        stored.append(rs.rowscan_sweep(*args, mode, triangular, None, True, base, local, reduce))
    if triangular:
        return stored, rs.rowscan_store_checked(torch.stack(accs).sum(0))
    return stored, torch.stack(stored).sum(0)


@pytest.mark.parametrize("mode,triangular", [(rs.FORCE, True), (rs.ENERGY, True), (rs.FORCE, False)],
                         ids=["F-triangular", "U-triangular", "F-symmetric"])
def test_slabs_reduce_to_the_whole_launch(cuda, mode, triangular):
    """D = 2, 4, 8 slabs (the spatial runner's split of 132 row chunks)
    against the whole launch, bitwise: the triangular form's int64
    accumulators summed before the store, the symmetric form's rows each
    written by one slab. Each slab's own output within 1e-4 per column of
    the plain slab; the wrapper counts every slab launch."""
    conf, params, box = _fluid(cuda)
    if triangular:
        args = _sweep_args(conf, params, box)
    else:
        tiles = rs.build_rowscan_tiles(conf, box, CUTOFF + 0.1, 10**7)
        atoms = rs.assemble_atoms(conf, box, tiles.pad_order, rs.param_rows(params, tiles.pad_order, conf.shape[0]))
        args = (atoms, tiles.row_start, tiles.row_count, tiles.col_ids, rs.sweep_scalars(box, CUTOFF),
                rs.es_energy_force_series(BETA, CUTOFF))
    whole = rs.rowscan_sweep(*args, mode, triangular)
    n_rows = args[0].shape[0] // rs.ROW
    for d in (2, 4, 8):
        slabs = _slabs(n_rows, d)
        before = rs.rowscan_sweep.launches_slabs
        stored, reduced = _slab_outputs(args, mode, triangular, slabs)
        torch.cuda.synchronize()
        assert rs.rowscan_sweep.launches_slabs == before + len(slabs)
        assert torch.equal(reduced, whole), d
        for (base, local), out in zip(slabs, stored):
            plain = rs.rowscan_sweep_plain(*args, mode, triangular, None, True, base, local)
            for col in range(4):
                if not plain[:, col].any():
                    assert not out[:, col].any()
                else:
                    assert _rel(out[:, col], plain[:, col]) < TOL, (d, base, col)


def test_slab_overflow_is_nan_after_the_reduction(cuda):
    """Two atoms of one row chunk in the last of 4 slabs put 0.01 nm apart
    (equal w): that slab's partial sums raise the flag, and after the
    accumulators are summed every row comes back NaN, in F and U; the
    first slab's own output stays finite."""
    conf, params, box = _fluid(cuda)
    tiles = rs.build_rowscan_tiles(conf, box, CUTOFF + 0.1, 10**7, triangular=True)
    n_rows = tiles.row_start.shape[0]
    slabs = _slabs(n_rows, 4)
    row = slabs[-1][0] + 1
    a, b = (int(tiles.pad_order[row * rs.ROW + k]) for k in (3, 7))
    conf, params = conf.clone(), params.clone()
    conf[b] = conf[a] + torch.tensor([0.01, 0.0, 0.0], device=cuda)
    params[[a, b], 1], params[[a, b], 2], params[[a, b], 3] = 0.15, 1.0, 0.0
    atoms = rs.assemble_atoms(conf, box, tiles.pad_order, rs.param_rows(params, tiles.pad_order, conf.shape[0]))
    args = (atoms, tiles.row_start, tiles.row_count, tiles.col_ids, rs.sweep_scalars(box, CUTOFF),
            rs.es_energy_force_series(BETA, CUTOFF))
    for mode in (rs.FORCE, rs.ENERGY):
        stored, reduced = _slab_outputs(args, mode, True, slabs)
        assert bool(torch.isnan(reduced).all()), mode
        assert bool(torch.isnan(stored[-1]).all()) and bool(torch.isfinite(stored[0]).all()), mode
        assert bool(torch.isnan(rs.rowscan_sweep(*args, mode, True)).all()), mode


def test_slab_wrapper_rejects_a_bad_slab(cuda):
    """A row_base or n_rows_local outside the row chunks raises ValueError
    before any launch."""
    args = _sweep_args(*_fluid(cuda))
    n_rows = args[0].shape[0] // rs.ROW
    before = rs.rowscan_sweep.launches
    for base, local in ((-1, 4), (n_rows - 3, 4), (0, 0), (5, None)):
        with pytest.raises(ValueError):
            rs.rowscan_sweep(*args, rs.FORCE, True, None, True, base, local)
    assert rs.rowscan_sweep.launches == before


def test_provider_runs_on_the_kernel(cuda):
    conf, params, box = _fluid(cuda, seed=2)
    init, apply, energy, _ = rs.make_nonbonded_rowscan_md(BETA, CUTOFF, max_pairs=10**6)
    before_k, before_p = rs.rowscan_sweep.launches, rs.rowscan_sweep_plain.calls
    state = init(conf, params, box)
    force, state = apply(state, conf, params, box, 0)
    u = energy(state, conf, params, box)
    assert bool(torch.isfinite(force).all()) and bool(torch.isfinite(u))
    assert rs.rowscan_sweep.launches == before_k + 2
    assert rs.rowscan_sweep_plain.calls == before_p


@pytest.mark.parametrize("form", ["masked", "preshift"])
def test_sorted_sweep_runs_on_the_kernel(cuda, form):
    """The sorted-state step's sweep (make_rowscan_sorted_protocol) on
    pad-ordered coordinates, in the masked form (minimum image, w, 9 atoms
    out) and the main form (preshift, no w): one kernel launch and no plain
    call; its force, un-sorted, bitwise the provider's apply; within TOL per
    column of the plain sweep on the provider's rows."""
    from timemachine_torch.ops import dotscan_kernel as dk

    preshift = form == "preshift"
    # the main form's image bound at cutoff + skin on the snake sort holds from a 6.8 nm box of this fluid
    conf, params, box = _fluid(cuda, n_side=22 if preshift else 16, seed=3)
    mask = None
    if preshift:
        params[:, 3] = 0.0
        assert dk.dotscan_valid(conf, box, CUTOFF + 0.1)
    else:
        mask = torch.ones(conf.shape[0], dtype=torch.bool, device=cuda)
        mask[:9] = False
    init, apply, _, _ = rs.make_nonbonded_rowscan_md(
        BETA, CUTOFF, max_pairs=10**6, preshift=preshift, has_w=not preshift, atom_mask=mask
    )
    proto = rs.make_rowscan_sorted_protocol(BETA, CUTOFF, 20, preshift=preshift, has_w=not preshift)
    state = init(conf, params, box)
    force, _ = apply(state, conf, params, box, 1)
    po, inv = proto.pad_order(state), proto.inv(state)
    before_k, before_p = rs.rowscan_sweep.launches, rs.rowscan_sweep_plain.calls
    out = proto.sweep(state, conf[po], box)
    assert rs.rowscan_sweep.launches == before_k + 1 and rs.rowscan_sweep_plain.calls == before_p
    assert out.shape == (po.shape[0], 4) and torch.equal(-out[inv, 1:4], force)
    t = state.lists
    atoms = rs.assemble_atoms(conf, box, po, state.prows)
    row_count = rs.chop_row_counts(atoms[:, :3], t.rank_mat, t.row_count, box, CUTOFF)
    out_p = rs.rowscan_sweep_plain(
        atoms, t.row_start, row_count, t.col_ids, rs.sweep_scalars(box, CUTOFF), rs.es_energy_force_series(BETA, CUTOFF),
        rs.FORCE, True, t.rcen_q if preshift else None, not preshift,
    )
    torch.cuda.synchronize()
    for col in range(1, 4):
        assert _rel(out[:, col], out_p[:, col]) <= TOL


# -- the replica-batched masked form (rowscan_sweep_batched) ------------------------


def _batched_case(device, n_replicas=3, n_sets=3, overlap_in=None, overlap_nm=0.01, same_w=False):
    """K replicas of a masked fluid (the first 9 atoms outside the subset),
    each with its own coordinates and lists, S parameter sets a replica:
    the batched sweep's arguments over B = K S systems (system b reads the
    lists of replica b // S), and each system's single-sweep arguments.
    overlap_in: a system whose atoms 9 and 10 sit overlap_nm apart in xyz
    (their w offsets lift them apart in r^2 unless same_w, which gives both
    w = 0)."""
    lists, systems = [], []
    mask = None
    for k in range(n_replicas):
        conf, params, box = _fluid(device, seed=20 + k)
        mask = torch.ones(conf.shape[0], dtype=torch.bool, device=device)
        mask[:9] = False
        tiles = rs.build_rowscan_tiles(conf, box, CUTOFF + 0.1, 10**7, triangular=True, atom_mask=mask)
        lists.append(tiles)
        for s in range(n_sets):
            b = len(systems)
            c, prm = conf, params * (1.0 + 0.03 * s)
            if b == overlap_in:
                c, prm = conf.clone(), prm.clone()
                c[10] = c[9] + torch.tensor([overlap_nm, 0.0, 0.0], device=device)
                prm[9:11, 1], prm[9:11, 2] = 0.15, 1.0
                if same_w:
                    prm[9:11, 3] = 0.0
            atoms = rs.assemble_atoms(c, box, tiles.pad_order, rs.param_rows(prm, tiles.pad_order, c.shape[0], mask))
            row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, CUTOFF)
            systems.append((atoms, tiles.row_start, row_count, tiles.col_ids, rs.sweep_scalars(box, CUTOFF)))
    # the chop of a replica's lists is the same for its parameter sets (one set of coordinates)
    row_count = torch.stack([systems[k * n_sets][2] for k in range(n_replicas)])
    series = rs.es_energy_force_series(BETA, CUTOFF)
    batched = (
        torch.stack([a for a, *_ in systems]), torch.stack([t.row_start for t in lists]), row_count,
        torch.stack([t.col_ids for t in lists]),
        torch.arange(n_replicas, device=device, dtype=torch.int32).repeat_interleave(n_sets),
        torch.stack([sc for *_, sc in systems]), series,
    )
    return batched, [(*sys_, series) for sys_ in systems]


@pytest.mark.parametrize("mode", [rs.FORCE, rs.ENERGY])
def test_batched_kernel_is_each_systems_launch(cuda, mode):
    """The replica-batched masked form over 3 replicas x 3 parameter sets
    (list_of_system shared by each replica's sets) in one launch: every
    system's output bitwise its single-system rowscan_sweep launch, and
    within 1e-4 per column of rowscan_sweep_batched_plain; two launches
    bitwise equal."""
    batched, singles = _batched_case(cuda)
    before = rs.rowscan_sweep_batched.launches
    out = rs.rowscan_sweep_batched(*batched, mode)
    out2 = rs.rowscan_sweep_batched(*batched, mode)
    plain = rs.rowscan_sweep_batched_plain(*batched, mode)
    torch.cuda.synchronize()
    assert rs.rowscan_sweep_batched.launches == before + 2 and torch.equal(out, out2)
    assert out.shape == (9, *singles[0][0].shape[:1], 4)
    for b, args in enumerate(singles):
        assert torch.equal(out[b], rs.rowscan_sweep(*args, mode, triangular=True)), b
        for col in range(4):
            if not plain[b, :, col].any():
                assert not out[b, :, col].any()
            else:
                assert _rel(out[b, :, col], plain[b, :, col]) < TOL, (b, col)


@pytest.mark.parametrize("same_w", [False, True], ids=["lifted", "overlapping"])
def test_batched_kernel_overflow_is_per_system(cuda, same_w):
    """A system with a pair 0.01 nm apart in xyz. Lifted apart by their w
    offsets, the pair's force (1.95e10 kJ/mol/nm by the plain version) is
    past the fixed-point range 2^30 and its largest per-atom energy (6.29e8)
    inside it: NaN in every row in FORCE mode, and in ENERGY mode finite,
    bitwise the single launch and within 1e-4 per column of plain. With
    equal w the energy (2.1e18) leaves the range too: NaN in every row in
    both modes. Either way the other systems, one of them on the same
    replica's lists, stay finite and bitwise their single launches."""
    batched, singles = _batched_case(cuda, overlap_in=4, same_w=same_w)
    for mode in (rs.FORCE, rs.ENERGY):
        out = rs.rowscan_sweep_batched(*batched, mode)
        if mode == rs.ENERGY and not same_w:
            plain = rs.rowscan_sweep_batched_plain(*batched, mode)[4]
            assert bool(torch.isfinite(out[4]).all()) and float(plain[:, 0].abs().max()) < 2.0**30
            assert torch.equal(out[4], rs.rowscan_sweep(*singles[4], mode, triangular=True))
            assert _rel(out[4, :, 0], plain[:, 0]) < TOL
        else:
            assert bool(torch.isnan(out[4]).all())
        for b in (0, 3, 5, 8):
            assert bool(torch.isfinite(out[b]).all())
            assert torch.equal(out[b], rs.rowscan_sweep(*singles[b], mode, triangular=True))


def test_batched_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    batched, _ = _batched_case(cuda, n_replicas=2, n_sets=1)
    before = rs.rowscan_sweep_batched.launches
    with pytest.raises(ValueError):  # F+U is not a batched mode
        rs.rowscan_sweep_batched(*batched, rs.FORCE_ENERGY)
    with pytest.raises(ValueError):
        rs.rowscan_sweep_batched(batched[0].double(), *batched[1:], rs.FORCE)
    with pytest.raises(ValueError):  # one scalar row for two systems
        rs.rowscan_sweep_batched(*batched[:5], batched[5][:1].contiguous(), batched[6], rs.FORCE)
    with pytest.raises(ValueError):
        rs.rowscan_sweep_batched(*batched[:4], batched[4].long(), *batched[5:], rs.FORCE)
    assert rs.rowscan_sweep_batched.launches == before


def test_batched_provider_runs_on_the_kernel(cuda):
    """make_nonbonded_rowscan_md_batched on the card: a non-rebuild step and
    the energies are one batched launch each, no plain sweep; each
    replica's force is the single provider's, bitwise; the energy under its
    own parameters is its energy (to 1e-6: sums of other shapes)."""
    confs, params = [], []
    for k in range(3):
        c, p, box = _fluid(cuda, seed=30 + k)
        confs.append(c)
        params.append(p)
    xs, ps, boxes = torch.stack(confs), torch.stack(params), box.expand(3, 3, 3).contiguous()
    init, apply, energy, energy_with_params = rs.make_nonbonded_rowscan_md_batched(BETA, CUTOFF, 10**6)
    single = rs.make_nonbonded_rowscan_md(BETA, CUTOFF, 10**6)
    state = init(xs, ps, boxes)
    before_k, before_p = rs.rowscan_sweep_batched.launches, rs.rowscan_sweep_plain.calls
    f, state = apply(state, xs, ps, boxes, 1)
    u = energy(state, xs, boxes)
    u_sets = energy_with_params(state, xs, torch.stack([ps, 1.1 * ps], 1), boxes)
    torch.cuda.synchronize()
    assert rs.rowscan_sweep_batched.launches == before_k + 3 and rs.rowscan_sweep_plain.calls == before_p
    assert u_sets.shape == (3, 2) and bool(torch.isfinite(u_sets).all())
    for k in range(3):
        st = single[0](xs[k], ps[k], box)
        assert torch.equal(f[k], single[1](st, xs[k], ps[k], box, 1)[0])
        # two reductions of the same per-atom energies, of other shapes: rounding apart
        assert float(u[k]) == pytest.approx(float(u_sets[k, 0]), rel=1e-6)


# -- the block-tile kernel (csrc/nb_tiles.cu) -----------------------------------

NB_MODES = {
    "DP": (nbk.DP, None),
    "UF-exact": (nbk.UF, None),
    "UF-poly": (nbk.UF, "poly"),
    "F": (nbk.FORCE, None),
    "DP-as": (nbk.DP, nbk.AS7126),
}
# the forms the kernel is built for: every mode triangular, the first
# design (symmetric) in DP and F, DP also with A&S 7.1.26
NB_FORMS = [("triangular", m) for m in NB_MODES] + [("symmetric", m) for m in ("DP", "F", "DP-as")]


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
    mode, es = NB_MODES[mode_name]
    tri = form == "triangular"
    es = nbk.es_switch_poly_coeffs(BETA, CUTOFF) if es == "poly" else es
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
    refused = (
        (nbk.UF, None, False), (nbk.UF, poly, False), (nbk.FORCE, poly, False), (nbk.FORCE, poly, True),
        (nbk.UF, nbk.AS7126, True), (nbk.UF, nbk.AS7126, False), (nbk.FORCE, nbk.AS7126, True),
        (nbk.FORCE, nbk.AS7126, False),
    )
    for mode, es, tri in refused:
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
    dp_plain = nbk.nb_tiles_plain(*_tile_args(conf, params, box, triangular=True), nbk.DP, 2, nbk.AS7126, triangular=True)
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
    from timemachine_torch.testsystems.dhfr import setup_dhfr_native

    hc = setup_dhfr_native(waters_first=True, device=device, dtype=torch.float32)
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
            init, apply, energy, _ = gk.make_nonbonded_gather_md(BETA, cutoff, max_nbrs, rebuild_interval=1)
        else:
            assert qk.constant_shift_valid(conf, box, cutoff + 0.1)
            max_tiles = qk.suggest_max_tiles(conf, box, cutoff + 0.1, margin=1.4)
            init, apply, energy, _ = qk.make_nonbonded_quadscan_md(BETA, cutoff, max_tiles, rebuild_interval=1)
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
    init, apply, energy, _ = dk.make_nonbonded_dotscan_md(BETA, cutoff, 10**6, rebuild_interval=1, sort="hilbert")
    state = init(conf, params, box)
    for t in range(2):
        force, state = apply(state, conf, params, box, t)
    u = energy(state, conf, params, box)
    assert int(state.invalid) == 0 and bool(torch.isfinite(force).all()) and bool(torch.isfinite(u))
    init, apply, *_ = dk.make_nonbonded_dotscan_md(BETA, cutoff, 8, sort="hilbert")
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


@pytest.mark.parametrize("iters", [br.ITERS, 4 * br.ITERS])
@pytest.mark.parametrize("first_design", [False, True], ids=["redesign", "first_design"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_rate_designs_match_plain(cuda, dtype, first_design, iters):
    """Both designs, bit for bit, at ITERS and 4 ITERS (the redesign's shift
    table holds 256 iterations a chunk), and two launches equal."""
    a, b = br.inputs(cuda)
    out_k = br.bf16_rate(a, b, dtype, iters, first_design=first_design)
    assert torch.equal(out_k, br.bf16_rate_plain(a, b, dtype, iters))
    assert torch.equal(out_k, br.bf16_rate(a, b, dtype, iters, first_design=first_design))


@pytest.mark.parametrize(
    "dtype, shape, iters",
    [
        (torch.float32, (3, 130), br.ITERS), (torch.bfloat16, (3, 130), br.ITERS), (torch.float32, (3, 131), br.ITERS),
        (torch.float32, (2200, 1030), 301), (torch.bfloat16, (2200, 1030), 301),
    ],
    ids=["f32-even-ragged", "bf16-even-ragged", "f32-odd", "f32-past-one-wave", "bf16-past-one-wave"],
)
def test_bf16_rate_redesign_ragged_and_long(cuda, dtype, shape, iters):
    """The redesign on n not a multiple of ELEMS x THREADS (an odd n in f32,
    which takes any n), and on more elements than one wave holds at an
    iteration count past one shift-table chunk and not a multiple of the
    unroll."""
    a, b = br.inputs(cuda, shape)
    assert a.numel() % (2 * br.ELEMS * br.THREADS)
    out_k = br.bf16_rate(a, b, dtype, iters)
    assert torch.equal(out_k, br.bf16_rate_plain(a, b, dtype, iters))


@pytest.mark.parametrize("first_design", [False, True], ids=["redesign", "first_design"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_rate_zero_iterations_give_zeros(cuda, dtype, first_design):
    a, b = br.inputs(cuda, (8, 256))
    out = br.bf16_rate(a, b, dtype, 0, first_design=first_design)
    assert torch.equal(out, torch.zeros_like(a))


def test_kernel_ms_times_by_events_where_the_profiler_sees_no_launch(cuda):
    """A name no launch carries stands for a session whose kernel records
    CUPTI dropped: kernel_ms tries the profiler PROFILER_TRIES times, then
    times each call between CUDA events queued behind a spin."""
    from timemachine_torch.probes import kernel_ms

    a, b = br.inputs(cuda)
    ms, how = kernel_ms(lambda: br.bf16_rate(a, b), 20, "no launch has this name")
    assert how == "events" and 0 < ms < 1


def test_bf16_rate_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    a, b = br.inputs(cuda, (3, 131))
    with pytest.raises(ValueError, match="even"):
        br.bf16_rate(a, b, torch.bfloat16)
    a, b = br.inputs(cuda, (64, 128))
    with pytest.raises(ValueError, match="contiguous"):
        br.bf16_rate(a.t(), b.t())
    with pytest.raises(ValueError, match="aligned"):
        br.bf16_rate(a.view(-1)[2:], b.view(-1)[2:])
    with pytest.raises(ValueError, match="iters"):
        br.bf16_rate(a, b, iters=-1)


def test_tile_census_on_the_card_equals_its_cpu_run(cuda):
    from timemachine_torch.testsystems.dhfr import setup_dhfr_native

    hc = setup_dhfr_native(waters_first=True, device="cpu")
    assert tc.tile_census(hc.conf, hc.box, cuda) == tc.tile_census(hc.conf, hc.box, "cpu")


def test_local_segment_on_the_card_matches_the_cpu(cuda):
    """Window 6 of the cached RBFE leg in float32 with its integrator at 0 K
    (no noise): 10 steps of multiple_steps_local (radius 1.0 nm around the
    ligand, seed 3, the reference frozen) on the card, each one launch of
    the masked rowscan sweep and no plain sweep, against the same on the CPU
    (the plain sweep): frozen atoms bitwise unmoved on both, x within 1e-4
    nm and v within 1e-2 nm/ps of the CPU's."""
    from dataclasses import replace

    from timemachine_torch.fe.free_energy import get_context
    from timemachine_torch.potentials import NonbondedAllPairs
    from timemachine_torch.testsystems.rbfe_solvent import load_rbfe_solvent

    out = {}
    for dev in (cuda, torch.device("cpu")):
        state = load_rbfe_solvent(device=dev, dtype=torch.float32, windows=[6])[0]
        state = replace(state, integrator=replace(state.integrator, temperature=0.0))
        host = next(p for p in state.potentials if isinstance(p, NonbondedAllPairs))
        host.configure(torch.as_tensor(state.box0, device=dev, dtype=torch.float32),
                       torch.as_tensor(state.x0, device=dev, dtype=torch.float32), kernel="rowscan")
        ctxt = get_context(state)
        x0 = ctxt.get_x_t()
        free = ctxt.local_selection(state.ligand_idxs, 10_000.0, 1.0, 3, 300.0)[1]
        launches, plain = rs.rowscan_sweep.launches, rs.rowscan_sweep_plain.calls
        ctxt.multiple_steps_local(10, state.ligand_idxs, k=10_000.0, radius=1.0, seed=3, temperature=300.0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert rs.rowscan_sweep.launches - launches == 10 and rs.rowscan_sweep_plain.calls == plain
        x, v = ctxt.get_x_t(), ctxt.get_v_t()
        out[dev.type] = (x0, x, v, free)
    (x0_c, x_c, v_c, free_c), (x0_h, x_h, v_h, free_h) = out["cuda"], out["cpu"]
    assert np.array_equal(x0_c, x0_h) and np.array_equal(free_c, free_h)
    for x0, x in ((x0_c, x_c), (x0_h, x_h)):
        moved = np.any(x != x0, axis=1)
        assert moved.any() and not moved[~free_h].any()
    assert np.abs(x_c - x_h).max() <= 1e-4 and np.abs(v_c - v_h).max() <= 1e-2


def test_ahfe_windowed_leg_runs_on_the_card(cuda, monkeypatch):
    """fe/absolute_hydration.py run_solvent on the card, as chip_smoke's
    phase 19 at a few steps: ethanol at the RBFE cache's conformer, 2
    windows (λ 1 and 0), the host's FIRE cut to 30 steps a window, 20
    equilibration steps and 2 frames of 10 a window. FIRE on nb_tiles'
    exact form and the windows' MD on the masked rowscan sweep, no plain
    sweep; a finite BAR pair; the interaction group exactly 0 at λ = 1."""
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.fe import absolute_hydration as ah
    from timemachine_torch.fe.free_energy import MDParams
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.md import minimizer
    from timemachine_torch.potentials import NonbondedInteractionGroup
    from timemachine_torch.testsystems import rbfe_solvent

    mol = mol_from_smiles("CCO", add_hs=True, name="ethanol")
    mol.set_conf(np.asarray(rbfe_solvent.metadata(rbfe_solvent.load_arrays())["conf_a"]))
    fire = minimizer.fire_minimize_host
    monkeypatch.setattr(minimizer, "fire_minimize_host", lambda *a, **k: fire(*a, **{**k, "n_steps_per_window": 30}))
    before = (nbk.nb_tiles.launches, rs.rowscan_sweep.launches, nbk.nb_tiles_plain.calls, rs.rowscan_sweep_plain.calls)
    res, cfg = ah.run_solvent(mol, Forcefield.load_default(), None, MDParams(n_frames=2, n_eq_steps=20, steps_per_frame=10,
                                                                             seed=2023), n_windows=2)
    torch.cuda.synchronize()
    nb, row, nb_plain, row_plain = (a - b for a, b in zip(
        (nbk.nb_tiles.launches, rs.rowscan_sweep.launches, nbk.nb_tiles_plain.calls, rs.rowscan_sweep_plain.calls), before))
    fin = res.final_result
    assert [s.lamb for s in fin.initial_states] == [1.0, 0.0]
    assert nb >= 60 and row >= 2 * 40 and nb_plain == 0 and row_plain == 0
    assert len(fin.bar_results) == 1 and np.isfinite(fin.dGs).all() and np.isfinite(fin.dG_errs).all()
    ixn = next(i for i, p in enumerate(fin.initial_states[0].potentials) if isinstance(p, NonbondedInteractionGroup))
    assert np.all(fin.bar_results[0].u_kln_by_component[ixn][:, 0] == 0.0)
