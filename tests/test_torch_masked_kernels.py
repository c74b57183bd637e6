"""The gather, dot and block-tile (v1) paths under an atom subset (the RBFE
host term's `atom_idxs`), against timemachine_tpu's masked forms run in
interpret mode, and the lists they build under it.

Inputs are tests/test_torch_rbfe_masked.py's jittered lattice fluids, a
random tenth of the atoms outside the subset, in f32 on both sides.

Tolerances: the unmasked tests' of each kernel. The sweeps compute one
function over the same pairs in other summation orders: per-atom dU/dx and
u agree to 1e-5 in relative norm (tests/test_torch_gather.py,
tests/test_torch_dotscan.py, tests/test_torch_nb_tiles.py). Atoms outside
the subset get exactly zero force in both. The port leaves them out of
gather's lists, where JAX's keeps them with zero parameters, and reads
dot's image bound on the subset alone, where JAX's lets them widen it.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_dotscan import lattice_fluid  # noqa: E402
from tests.test_torch_rbfe_masked import masked_fluid  # noqa: E402
from timemachine_torch.ops import dotscan_kernel as td  # noqa: E402
from timemachine_torch.ops import gather_kernel as tg  # noqa: E402
from timemachine_torch.ops import nonbonded_kernel as tnb  # noqa: E402
from timemachine_torch.potentials import NonbondedAllPairs  # noqa: E402
from timemachine_tpu.ops.pallas import dotscan_kernel as jd  # noqa: E402
from timemachine_tpu.ops.pallas import gather_kernel as jg  # noqa: E402
from timemachine_tpu.ops.pallas import nonbonded_kernel as jnb  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, SKIN, CUTOFF = 2.0, 0.1, 0.8
DOT_CUTOFF = 0.5
F32 = torch.float32
TOL = 1e-5


def _t(a, dtype=F32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("coincident", [False, True])
def test_gather_energy_force_matches_jax(coincident):
    """gather's energy/force entry under the subset against JAX's
    make_nonbonded_gather_energy_force(atom_mask=): u and dU/dx to 1e-5,
    zero force outside the subset; with two masked atoms on one point and
    two 5e-4 nm apart, still finite."""
    conf, params, box, mask = masked_fluid(7, coincident)
    mask_t = torch.as_tensor(mask)
    nbrs = tg.suggest_max_nbrs(_t(conf), _t(box), CUTOFF, margin=1.4, atom_mask=mask_t)
    u, f = tg.make_nonbonded_gather_energy_force(BETA, CUTOFF, nbrs, atom_mask=mask_t)(_t(conf), _t(params), _t(box))
    j_nbrs = jg.suggest_max_nbrs(conf, box, CUTOFF, margin=1.4, atom_mask=mask.astype(np.float32))
    j_ef = jg.make_nonbonded_gather_energy_force(BETA, CUTOFF, j_nbrs, interpret=True, atom_mask=mask.astype(np.float32))
    u_j, f_j = j_ef(_j(conf), _j(params), _j(box))
    assert bool(torch.isfinite(f).all()) and np.isfinite(float(u))
    assert float(u) == pytest.approx(float(u_j), rel=TOL)
    assert _rel_norm(f.numpy(), np.asarray(f_j)) < TOL
    assert not f[~mask_t].any()


def test_gather_lists_leave_the_masked_atoms_out():
    """Under the subset no row lists a masked atom or a padding slot, the
    row boxes hold the subset's atoms only, and every pair of subset atoms
    within the cutoff is listed from both of its atoms' row chunks."""
    conf, params, box, mask = masked_fluid(8)
    n = conf.shape[0]
    mask_t = torch.as_tensor(mask)
    lists = tg.build_gather_neighbors(_t(conf), _t(box), CUTOFF, 4096, atom_mask=mask_t)
    assert int(lists.overflow) == 0
    slots = lists.pad_order.numpy()
    valid_slot = np.zeros(len(slots), bool)
    valid_slot[:n] = mask[slots[:n]]
    listed = np.zeros((len(lists.counts), len(slots)), bool)
    for r, c in enumerate(lists.counts.tolist()):
        listed[r, lists.nbr[r, :c].numpy()] = True
    assert not listed[:, ~valid_slot].any()
    inv = np.argsort(slots[:n])
    d = conf[:, None] - conf[None]
    d -= np.diagonal(box) * np.round(d / np.diagonal(box))
    close = (np.sum(d * d, -1) < CUTOFF**2) & mask[:, None] & mask[None]
    i, j = np.nonzero(close)
    assert listed[inv[i] // tg.ROW, inv[j]].all()


def test_gather_md_provider_matches_jax():
    """gather's MD provider under the subset against JAX's
    make_nonbonded_gather_md(atom_mask=): three steps with a rebuild every
    two and 0.004 nm of drift a step, forces to 1e-5 at every step and zero
    outside the subset; the energy through the cached lists against JAX's
    energy/force entry at the last coordinates (its provider has none)."""
    conf, params, box, mask = masked_fluid(9)
    mask_t, m32 = torch.as_tensor(mask), mask.astype(np.float32)
    nbrs = tg.suggest_max_nbrs(_t(conf), _t(box), CUTOFF + SKIN, margin=1.4, atom_mask=mask_t)
    init, apply, energy, energy_with_params = tg.make_nonbonded_gather_md(
        BETA, CUTOFF, nbrs, skin=SKIN, rebuild_interval=2, atom_mask=mask_t
    )
    j_nbrs = jg.suggest_max_nbrs(conf, box, CUTOFF + SKIN, margin=1.4, atom_mask=m32)
    j_init, j_apply, *_ = jg.make_nonbonded_gather_md(
        BETA, CUTOFF, j_nbrs, skin=SKIN, rebuild_interval=2, interpret=True, atom_mask=m32
    )
    p32 = _j(params)
    state, j_state = init(_t(conf), _t(params), _t(box)), j_init(_j(conf), p32, _j(box))
    rng = np.random.default_rng(0)
    x = conf.astype(np.float32)
    for t in range(3):
        _, f_j, j_state = j_apply(j_state, jnp.asarray(x), p32, _j(box), jnp.asarray(t))
        f, state = apply(state, _t(x), _t(params), _t(box), t)
        assert _rel_norm(f.numpy(), np.asarray(f_j)) < TOL, t
        assert not f[~mask_t].any()
        x = (x + rng.normal(0, 0.004, size=x.shape)).astype(np.float32)
    j_nbrs0 = jg.suggest_max_nbrs(x, box, CUTOFF, margin=1.4, atom_mask=m32)
    u_j = jg.make_nonbonded_gather_energy_force(BETA, CUTOFF, j_nbrs0, interpret=True, atom_mask=m32)(
        jnp.asarray(x), p32, _j(box)
    )[0]
    u = float(energy(state, _t(x), _t(params), _t(box)))
    assert u == pytest.approx(float(u_j), rel=TOL)
    assert float(energy_with_params(state, _t(x), _t(params), _t(box))) == u


def dense_masked_fluid(seed, w_frac=0.1):
    """tests/test_torch_dotscan.py's water-density fluid (16^3 atoms at
    0.215 nm, box 3.44 nm), where snake rows pass dot's image bound at a
    0.5 nm cutoff; w lifts w_frac of the atoms and a random tenth is outside
    the subset."""
    conf, params, box = lattice_fluid(16, 0.02, seed=seed, spacing=0.215, w_frac=w_frac)
    return conf, params, box, np.random.default_rng(seed + 100).random(conf.shape[0]) >= 0.1


def test_dot_md_provider_matches_jax():
    """dot's MD provider under the subset (Newton-triangular, snake, at a
    0.5 nm cutoff) against JAX's make_nonbonded_dotscan_md(atom_mask=):
    three steps with a rebuild every two and 0.004 nm of drift, forces to
    1e-5 and zero outside the subset, the energy through the cached lists
    to 1e-5."""
    conf, params, box, mask = dense_masked_fluid(10)
    cutoff = DOT_CUTOFF
    mask_t, m32 = torch.as_tensor(mask), mask.astype(np.float32)
    pairs = td.suggest_max_pairs(_t(conf), _t(box), cutoff + SKIN, margin=1.4, triangular=True, atom_mask=mask_t)
    init, apply, energy, _ = td.make_nonbonded_dotscan_md(
        BETA, cutoff, pairs, skin=SKIN, rebuild_interval=2, atom_mask=mask_t
    )
    j_init, j_apply, j_energy, *_ = jd.make_nonbonded_dotscan_md(
        BETA, cutoff, 2 * pairs, skin=SKIN, rebuild_interval=2, interpret=True, atom_mask=m32, dot_r2=False
    )
    p32 = _j(params)
    state, j_state = init(_t(conf), _t(params), _t(box)), j_init(_j(conf), p32, _j(box))
    assert int(state.invalid) == 0
    rng = np.random.default_rng(1)
    x = conf.astype(np.float32)
    for t in range(3):
        _, f_j, j_state = j_apply(j_state, jnp.asarray(x), p32, _j(box), jnp.asarray(t))
        f, state = apply(state, _t(x), _t(params), _t(box), t)
        assert _rel_norm(f.numpy(), np.asarray(f_j)) < TOL, t
        assert not f[~mask_t].any()
        x = (x + rng.normal(0, 0.004, size=x.shape)).astype(np.float32)
    u = float(energy(state, _t(x), _t(params), _t(box)))
    assert u == pytest.approx(float(j_energy(j_state, jnp.asarray(x), p32, _j(box))), rel=TOL)


def test_dot_image_bound_reads_the_subset():
    """Under the subset the image bound's margin is read on each row
    chunk's subset atoms alone: it equals a brute-force periodic extent
    over them (numpy, every circular gap), is at least the margin over
    every atom (JAX's reading; the sort leaves the chunks as they are), and
    configure(kernel="dot") takes dot, whose force equals the rowscan
    configuration's to 1e-5."""
    conf, params, box, mask = dense_masked_fluid(11)
    cutoff = DOT_CUTOFF
    mask_t = torch.as_tensor(mask)
    tiles = td.build_dotscan_tiles(_t(conf), _t(box), cutoff + SKIN, 10**5, triangular=True, atom_mask=mask_t)
    every = td.build_dotscan_tiles(_t(conf), _t(box), cutoff + SKIN, 10**5, triangular=True)
    assert torch.equal(tiles.pad_order, every.pad_order)
    n, side = conf.shape[0], np.diagonal(box).astype(np.float32)
    wrapped = (conf - side * np.floor(conf / side)).astype(np.float32)
    order = tiles.pad_order.numpy()
    reach = np.zeros(3)
    for r in range(len(order) // td.ROW):
        slots = order[r * td.ROW : (r + 1) * td.ROW]
        keep = [a for k, a in enumerate(slots) if r * td.ROW + k < n and mask[a]]
        for ax in range(3):
            if keep:
                x = np.sort(wrapped[keep, ax])
                gaps = np.append(np.diff(x), x[0] + side[ax] - x[-1])
                reach[ax] = max(reach[ax], 0.5 * (side[ax] - gaps.max()))
    want = np.min(0.5 * side - (reach + cutoff + SKIN))
    assert float(tiles.margin) == pytest.approx(want, abs=1e-5)
    assert float(tiles.margin) >= float(every.margin) > 0
    forces = {}
    for kernel in ("dot", "rowscan"):
        nb = NonbondedAllPairs(len(conf), BETA, cutoff, params, atom_idxs=np.nonzero(mask)[0], device="cpu", dtype=F32)
        nb.configure(_t(box), _t(conf), kernel=kernel)
        assert nb.kernel == kernel
        init, apply, *_ = nb.md_force_provider()
        forces[kernel] = apply(init(_t(conf), _t(box)), _t(conf), _t(box), 0)[0].numpy()
    assert _rel_norm(forces["dot"], forces["rowscan"]) < TOL


def test_v1_tiles_match_jax_under_the_subset():
    """The block-tile UF pass under the subset in the JAX kernel's own
    electrostatics (A&S 7.1.26) against JAX's _run_uf(atom_mask=) in
    interpret mode: u and dU/dx to 1e-5, zero outside the subset; the
    port's exact form (erfc) is within 1e-5 of both; the v1 MD provider's
    force equals the energy/force entry's to 1e-5, and its energy through
    the cached lists equals the entry's."""
    conf, params, box, mask = masked_fluid(12)
    mask_t, m32 = torch.as_tensor(mask), mask.astype(np.float32)
    tiles = tnb.suggest_max_tiles(_t(conf), _t(box), CUTOFF, margin=1.4, cb=2, triangular=True, atom_mask=mask_t)
    u_as, g_as = tnb.run_uf(_t(conf), _t(params), _t(box), BETA, CUTOFF, tiles, es_coeffs=tnb.AS7126, cb=2, atom_mask=mask_t)
    u, g = tnb.run_uf(_t(conf), _t(params), _t(box), BETA, CUTOFF, tiles, cb=2, atom_mask=mask_t)
    j_tiles = jnb.suggest_max_tiles(conf, box, CUTOFF, margin=1.4, cb=2, atom_mask=m32)
    u_j, g_j, _ = jnb._run_uf(_j(conf), _j(params), _j(box), BETA, CUTOFF, j_tiles, True, cb=2, atom_mask=m32)
    assert float(u_as) == pytest.approx(float(u_j), rel=TOL)
    assert _rel_norm(g_as.numpy(), np.asarray(g_j)) < TOL
    assert float(u) == pytest.approx(float(u_j), rel=TOL) and _rel_norm(g.numpy(), np.asarray(g_j)) < TOL
    assert not g[~mask_t].any() and not g_as[~mask_t].any()
    nb = NonbondedAllPairs(len(conf), BETA, CUTOFF, params, atom_idxs=np.nonzero(mask)[0], device="cpu", dtype=F32)
    nb.configure(_t(box), _t(conf), kernel="v1")
    init, apply, energy, _, energy_with_params = nb.md_force_provider()
    state = init(_t(conf), _t(box))
    f, _ = apply(state, _t(conf), _t(box), 0)
    u_ef, f_ef = nb.energy_force(_t(conf), _t(box))
    assert _rel_norm(f.numpy(), f_ef.numpy()) < TOL and not f[~mask_t].any()
    assert float(energy(state, _t(conf), _t(box))) == pytest.approx(float(u_ef), rel=TOL)
    assert float(energy_with_params(state, _t(conf), nb.params, _t(box))) == float(energy(state, _t(conf), _t(box)))


@pytest.mark.parametrize("kernel", ["gather", "dot"])
def test_masked_configurations_match_rowscan(kernel):
    """gather's and dot's masked configurations, their energy/force entry
    and their MD force, against the masked rowscan configuration's (the
    same polynomial function over other lists and sums): 1e-5 of the force
    norm."""
    conf, params, box, mask = masked_fluid(13) if kernel == "gather" else dense_masked_fluid(13)
    cutoff = CUTOFF if kernel == "gather" else DOT_CUTOFF
    idxs = np.nonzero(mask)[0]
    out = {}
    for k in (kernel, "rowscan"):
        nb = NonbondedAllPairs(len(conf), BETA, cutoff, params, atom_idxs=idxs, device="cpu", dtype=F32)
        nb.configure(_t(box), _t(conf), kernel=k)
        assert nb.kernel == k
        init, apply, *_ = nb.md_force_provider()
        out[k] = (nb.energy_force(_t(conf), _t(box))[1].numpy(), apply(init(_t(conf), _t(box)), _t(conf), _t(box), 0)[0].numpy())
    for a, b in zip(out[kernel], out["rowscan"]):
        assert _rel_norm(a, b) < TOL


def test_masked_v1_is_the_dense_form():
    """f64: the masked v1 configuration (nb_tiles' exact form over its
    lists) and the dense form over the subset are one function: energy and
    force to 1e-12."""
    conf, params, box, mask = masked_fluid(14)
    f64 = torch.float64
    out = {}
    for k in ("v1", "dense"):
        nb = NonbondedAllPairs(len(conf), BETA, CUTOFF, params, atom_idxs=np.nonzero(mask)[0], device="cpu", dtype=f64)
        nb.configure(_t(box, f64), _t(conf, f64), kernel=k)
        out[k] = nb.energy_force(_t(conf, f64), _t(box, f64))
    assert float(out["v1"][0]) == pytest.approx(float(out["dense"][0]), rel=1e-12)
    assert _rel_norm(out["v1"][1].numpy(), out["dense"][1].numpy()) < 1e-12
