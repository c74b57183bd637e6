"""timemachine_torch gather path against timemachine_tpu: the full-list
builder, the plain sweep against the JAX Pallas kernel in interpret mode,
the MD provider across a rebuild, `configure(kernel="gather")`, and the
CUDA kernel's Newton-triangular suffix and per-step column cull.

Inputs are made from a seed with numpy, as tests/test_gather_kernel.py
makes them (jittered-lattice fluids at water density), and handed to both
packages in f32. The lists are integers and must be equal. The sweeps sum
each atom's pairs in different orders (the JAX kernel over 128-lane tiles,
the port over whole lists), so per-atom energies and gradients agree to a
relative norm of 1e-5 (measured ~3e-7).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.ops import gather_kernel as tg
from timemachine_torch.ops import rowscan_kernel as trs
from timemachine_torch.potentials import NonbondedAllPairs
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.ops.pallas import gather_kernel as jg

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF, SKIN = 2.0, 1.2, 0.1
SERIES = trs.es_energy_force_series(BETA, CUTOFF)
F32 = torch.float32


def make_waterish_system(n_atoms: int, box_width: float, seed: int):
    """tests/test_gather_kernel.py's fluid: a jittered lattice at water
    density with random LJ and charge parameters."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n_atoms ** (1 / 3)))
    spacing = box_width / m
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
    grid = grid[rng.permutation(len(grid))[:n_atoms]]
    conf = (grid + 0.5) * spacing + rng.uniform(-0.3, 0.3, size=(n_atoms, 3)) * spacing
    params = np.stack(
        [rng.uniform(-0.8, 0.8, n_atoms) * np.sqrt(138.935456), rng.uniform(0.05, 0.16, n_atoms),
         rng.uniform(0.05, 0.9, n_atoms) ** 0.5, np.zeros(n_atoms)], axis=1,
    )
    return conf, params, np.eye(3) * box_width


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F32)


CASES = [(96, 3.2, 0), (400, 3.2, 1), (777, 3.2, 2)]


@pytest.mark.parametrize("n_atoms,width,seed", CASES)
@pytest.mark.parametrize("cutoff", [CUTOFF, CUTOFF + SKIN])
def test_lists_equal_jax(n_atoms, width, seed, cutoff):
    """pad_order, counts, nbr and overflow equal build_gather_neighbors' on
    the same f32 inputs; a capacity of half the longest list overflows by
    the same count."""
    conf, _, box = make_waterish_system(n_atoms, width, seed)
    max_nbrs = jg.suggest_max_nbrs(conf, box, cutoff)
    assert tg.suggest_max_nbrs(_t(conf), _t(box), cutoff) == max_nbrs
    half = int(tg.build_gather_neighbors(_t(conf), _t(box), cutoff, max_nbrs).counts.max()) // 2
    for cap in (max_nbrs, half):
        j = jg.build_gather_neighbors(jnp.asarray(conf, jnp.float32), jnp.asarray(box, jnp.float32), cutoff, max_nbrs=cap)
        t = tg.build_gather_neighbors(_t(conf), _t(box), cutoff, cap)
        np.testing.assert_array_equal(t.pad_order.numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j[1]))
        np.testing.assert_array_equal(t.nbr.numpy(), np.asarray(j[2]))
        assert int(t.overflow) == int(j[3])
    assert int(t.overflow) > 0


def _both_sweeps(conf, params, box, mode):
    """(port plain sweep, JAX interpret sweep) on lists built from the same
    f32 inputs; both (Npad, 4) [u_i, dU/dx_i]."""
    max_nbrs = jg.suggest_max_nbrs(conf, box, CUTOFF)
    c32, p32, b32 = (jnp.asarray(a, jnp.float32) for a in (conf, params, box))
    pad_order, counts, nbr, _ = jg.build_gather_neighbors(c32, b32, CUTOFF, max_nbrs=max_nbrs)
    atoms8 = jg._assemble(c32, p32, b32, pad_order, conf.shape[0])
    u_j, g_j = jg.gather_sweep(
        atoms8, atoms8.T, counts, nbr, jg._scalars(b32, CUTOFF), max_nbrs=max_nbrs, h_coeffs=SERIES[0],
        p_coeffs=SERIES[1], compute_u=mode == tg.FORCE_ENERGY, interpret=True,
    )
    lists = tg.build_gather_neighbors(_t(conf), _t(box), CUTOFF, max_nbrs)
    atoms = trs.assemble_atoms(_t(conf), _t(box), lists.pad_order, trs.param_rows(_t(params), lists.pad_order, conf.shape[0]))
    out = tg.gather_sweep(atoms, lists.counts, lists.nbr, lists.tri_start, trs.sweep_scalars(_t(box), CUTOFF), SERIES, mode)
    return out.numpy(), np.concatenate([np.asarray(u_j)[:, None], np.asarray(g_j)], axis=1)


@pytest.mark.parametrize("n_atoms,width,seed", CASES)
@pytest.mark.parametrize("mode", [tg.FORCE, tg.FORCE_ENERGY])
def test_plain_sweep_matches_jax_kernel(n_atoms, width, seed, mode):
    """gather_sweep_plain against gather_sweep(interpret=True): dU/dx and,
    in F+U, u to 1e-5 relative norm; in F the energy column is zero."""
    out, ref = _both_sweeps(*make_waterish_system(n_atoms, width, seed), mode)
    assert _rel(out[:, 1:4], ref[:, 1:4]) < 1e-5
    if mode == tg.FORCE_ENERGY:
        assert _rel(out[:, 0], ref[:, 0]) < 1e-5
    else:
        assert not out[:, 0].any()


def test_plain_sweep_lifted_w():
    """4D-decoupled atoms (w up to the cutoff) see the lifted distance, as
    in the JAX kernel: u and dU/dx to 1e-5 relative norm."""
    conf, params, box = make_waterish_system(200, 3.0, seed=7)
    params[:30, 3] = np.linspace(0.0, CUTOFF, 30)
    out, ref = _both_sweeps(conf, params, box, tg.FORCE_ENERGY)
    assert _rel(out, ref) < 1e-5


def test_md_provider_across_a_rebuild_matches_jax():
    """Seven steps with a rebuild every five and 0.004 nm of drift a step:
    the port's forces equal make_nonbonded_gather_md's to 1e-5 relative
    norm at every step; the provider's energy through its cached lists
    (cutoff + skin) equals the JAX energy over lists built at the bare
    cutoff (ROADMAP P3) to 1e-6 of sum |u_i| (the net energy is a small
    difference of large pair sums, which f32 rounds at that scale)."""
    conf, params, box = make_waterish_system(300, 3.0, seed=4)
    max_nbrs = jg.suggest_max_nbrs(conf, box, CUTOFF + SKIN, margin=1.5)
    j_init, j_apply = jg.make_nonbonded_gather_md(BETA, CUTOFF, max_nbrs, skin=SKIN, rebuild_interval=5, interpret=True)
    j_ef = jg.make_nonbonded_gather_energy_force(BETA, CUTOFF, jg.suggest_max_nbrs(conf, box, CUTOFF), interpret=True)
    init, apply, energy, _ = tg.make_nonbonded_gather_md(BETA, CUTOFF, max_nbrs, skin=SKIN, rebuild_interval=5)
    c32, p32, b32 = (jnp.asarray(a, jnp.float32) for a in (conf, params, box))
    j_state = j_init(c32, p32, b32)
    state = init(_t(conf), _t(params), _t(box))
    rng = np.random.default_rng(0)
    x = conf.astype(np.float32)
    for t in range(7):
        _, f_j, j_state = j_apply(j_state, jnp.asarray(x), p32, b32, jnp.asarray(t))
        f, state = apply(state, _t(x), _t(params), _t(box), t)
        assert _rel(f.numpy(), f_j) < 1e-5, t
        x = (x + rng.normal(0, 0.004, size=x.shape)).astype(np.float32)
    u = float(energy(state, _t(x), _t(params), _t(box)))
    lists = tg.build_gather_neighbors(_t(x), _t(box), CUTOFF, max_nbrs)
    atoms = trs.assemble_atoms(_t(x), _t(box), lists.pad_order, trs.param_rows(_t(params), lists.pad_order, x.shape[0]))
    scalars = trs.sweep_scalars(_t(box), CUTOFF)
    scale = float(tg.gather_sweep(atoms, lists.counts, lists.nbr, lists.tri_start, scalars, SERIES, tg.FORCE_ENERGY)[:, 0].abs().sum())
    assert abs(u - float(j_ef(jnp.asarray(x), p32, b32)[0])) / scale < 1e-6


@pytest.fixture(scope="module")
def water_gather():
    """The 2.4 nm water box configured as kernel="gather" in both packages
    (JAX in interpret mode), f32."""
    jcfg = build_water_system(2.4)
    jcfg.host_system.nonbonded_all_pairs.potential.configure_pallas(jcfg.box, jcfg.conf, interpret=True, kernel="gather")
    cfg = host_config_from_jax(jcfg, device="cpu", dtype=F32)
    x, box = torch.as_tensor(cfg.conf, dtype=F32), torch.as_tensor(cfg.box, dtype=F32)
    nb = cfg.host_system.nonbonded_all_pairs.configure(box, x, kernel="gather")
    return jcfg, nb, x, box


def test_configure_gather_matches_jax(water_gather):
    """Nonbonded (all pairs minus exclusions) configured as "gather": energy
    and force against the JAX configuration's, to 1e-5 of the all-pairs
    scale (the net terms are small differences of large all-pairs sums);
    energy(), energy_force() and the MD provider run the gather sweep and
    agree with each other."""
    jcfg, nb, x, box = water_gather
    assert nb.kernel == "gather"
    jnb = jcfg.host_system.nonbonded_all_pairs
    u_j, f_j = jnb.potential.energy_force_fn()(
        jnp.asarray(jcfg.conf, jnp.float32), jnp.asarray(jnb.params, jnp.float32), jnp.asarray(jcfg.box, jnp.float32)
    )
    calls = tg.gather_sweep_plain.calls
    u, f = nb.energy_force(x, box)
    _, f_ap = NonbondedAllPairs.energy_force(nb, x, box)
    assert tg.gather_sweep_plain.calls == calls + 2
    u_scale = float(torch.sum(torch.abs(tg.gather_sweep(*_port_sweep_args(nb, x, box))[:, 0])))
    assert abs(float(u) - float(u_j)) / u_scale < 1e-5
    assert _rel(f.numpy(), f_j) * np.linalg.norm(f_j) / float(torch.linalg.vector_norm(f_ap)) < 1e-5
    assert float(nb.energy(x, box)) == float(u)
    init, apply, energy, _, _ = nb.md_force_provider()
    state = init(x, box)
    f_md, state = apply(state, x, box, 0)
    assert float(torch.linalg.vector_norm(f_md - f)) / float(torch.linalg.vector_norm(f_ap)) < 1e-6
    assert abs(float(energy(state, x, box)) - float(u)) / u_scale < 1e-6


def _port_sweep_args(nb, x, box):
    lists = tg.build_gather_neighbors(x, box, nb.cutoff, nb.max_nbrs)
    atoms = trs.assemble_atoms(x, box, lists.pad_order, trs.param_rows(nb.params, lists.pad_order, x.shape[0]))
    return atoms, lists.counts, lists.nbr, lists.tri_start, trs.sweep_scalars(box, nb.cutoff), SERIES, tg.FORCE_ENERGY


# -- the kernel's Newton-triangular suffix and per-step column cull ---------------


@pytest.mark.parametrize("n_atoms,width,seed", CASES)
def test_tri_start_counts_listed_slots_below_the_row_chunk(n_atoms, width, seed):
    """tri_start[r] is the number of row chunk r's listed slots below 32 r,
    so the suffix nbr[r, tri_start[r]:counts[r]] starts at its first slot
    >= 32 r; an overflowing capacity caps it like counts."""
    conf, _, box = make_waterish_system(n_atoms, width, seed)
    max_nbrs = tg.suggest_max_nbrs(_t(conf), _t(box), CUTOFF + SKIN)
    for cap in (max_nbrs, 64):
        lists = tg.build_gather_neighbors(_t(conf), _t(box), CUTOFF + SKIN, cap)
        for r in range(lists.counts.shape[0]):
            listed = lists.nbr[r, : int(lists.counts[r])]
            assert int(lists.tri_start[r]) == int((listed < tg.ROW * r).sum()), r
    assert int(lists.overflow) > 0


def _water_lists(jitter: float, aged: bool):
    """The 3.4 nm water box (f32), its atoms after `jitter` nm of random
    jitter that puts atoms across box faces, wrapped afresh as the MD
    provider places them, and gather lists at cutoff + skin built on the
    moved atoms or, if aged, before the jitter. Returns (atoms, lists, box,
    number of real atoms)."""
    cfg = build_water_system(3.4)
    conf = np.asarray(cfg.conf, np.float32)
    params = _t(np.asarray(cfg.host_system.nonbonded_all_pairs.params, np.float32))
    box = _t(cfg.box)
    moved = _t(conf) + _t(np.random.default_rng(5).normal(0.0, jitter, conf.shape))
    if jitter:  # the jitter put atoms across faces
        box_diag = torch.diagonal(box)
        assert bool((torch.floor(moved / box_diag) != torch.floor(_t(conf) / box_diag)).any())
    lists = tg.build_gather_neighbors(_t(conf) if aged else moved, box, CUTOFF + SKIN, 10**4)
    assert int(lists.overflow) == 0
    n = conf.shape[0]
    atoms = trs.assemble_atoms(moved, box, lists.pad_order, trs.param_rows(params, lists.pad_order, n))
    return atoms, lists, box, n


def _pair_keys_within_cutoff(atoms, box, n):
    """Sorted keys i * n + j of the sorted slots i < j < n whose
    minimum-image 4D r^2 passes the sweep's gate, by brute force."""
    box_diag = torch.diagonal(box).double()
    x = atoms[:n, :4].double()
    keys = []
    for i0 in range(0, n, 512):
        d = x[i0 : i0 + 512, None, :3] - x[None, :, :3]
        d = d - box_diag * torch.round(d / box_diag)
        r2 = (d * d).sum(-1) + (x[i0 : i0 + 512, None, 3] - x[None, :, 3]) ** 2
        later = torch.arange(i0, min(i0 + 512, n))[:, None] < torch.arange(n)
        i, j = torch.nonzero((r2 < CUTOFF**2) & (r2 > 1e-7) & later, as_tuple=True)
        keys.append((i + i0) * n + j)
    return torch.sort(torch.cat(keys)).values


@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_suffix_with_its_gate_holds_every_pair_once(jitter):
    """Each row chunk's suffix, gated to row slot < column slot on the
    row's own chunk, holds every pair within the cutoff exactly once, on
    lists built fresh on the water box and on the box after jitter across
    faces (padding slots left out: they add exact zeros)."""
    atoms, lists, box, n = _water_lists(jitter, aged=False)
    keys = []
    for r in range(lists.counts.shape[0]):
        j = lists.nbr[r, int(lists.tri_start[r]) : int(lists.counts[r])].long()[None, :]
        i = torch.arange(r * tg.ROW, (r + 1) * tg.ROW)[:, None]
        keep = (i < j) & (j < n) & (i < n)
        keys.append((i * n + j)[keep])
    swept = torch.sort(torch.cat(keys)).values
    assert bool((swept[1:] != swept[:-1]).all())  # each pair once
    want = _pair_keys_within_cutoff(atoms, box, n)
    assert want.numel() > 0
    assert bool(torch.isin(want, swept).all())  # every pair within the cutoff


@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_cull_never_drops_a_pair(jitter):
    """The kernel's cull (cull_mask: each suffix column atom's per-axis
    minimum image from the center of the row chunk's box, at its atoms'
    images nearest the first) keeps every column atom that has a row atom
    of its chunk within the cutoff (the pair function's f32 minimum-image
    differences), on lists at cutoff + skin built before 0.02 nm of jitter
    across faces; it drops something, and cull_census counts listed >=
    suffix >= columns and swept >= columns."""
    atoms, lists, box, _ = _water_lists(jitter, aged=True)
    scalars = trs.sweep_scalars(box, CUTOFF)
    c = tg.cull_mask(atoms, lists.counts, lists.nbr, lists.tri_start, scalars)
    box_diag = torch.diagonal(box)
    rows = atoms[:, :3].view(-1, tg.ROW, 3)
    for e0 in range(0, len(c.rows), 4096):
        sl = slice(e0, e0 + 4096)
        d = rows[c.rows[sl]] - atoms[c.slot[sl], None, :3]  # (E, 32 rows, 3)
        d = d - box_diag * torch.round(d / box_diag)
        near = ((d * d).sum(-1) < CUTOFF**2).any(1)  # columns with a row atom within the cutoff
        assert bool(c.column[sl][near].all())
    assert not bool(c.column.all())
    census = tg.cull_census(atoms, lists.counts, lists.nbr, lists.tri_start, scalars)
    assert census.listed >= census.suffix >= census.columns > 0
    assert census.swept >= census.columns
    assert census.listed == int(lists.counts.sum()) * tg.ROW
    assert census.suffix == int((lists.counts - lists.tri_start).sum()) * tg.ROW


def test_census_constants_mirror_the_kernel_source():
    """cull_census counts the kernel's work items with WARPS and SPLITS,
    constants of csrc/gather.cu that the module mirrors: they must agree."""
    source = (Path(tg.__file__).parents[1] / "csrc" / "gather.cu").read_text()
    for name in ("WARPS", "SPLITS"):
        assert re.search(rf"constexpr int {name} = (\d+);", source).group(1) == str(getattr(tg, name))
