"""The rowscan path under an atom subset (the RBFE host term's
`atom_idxs`), against timemachine_tpu's masked rowscan path.

Inputs are jittered lattice fluids made from a seed with numpy, with a
random tenth of the atoms outside the subset; the JAX side runs its Pallas
kernel in interpret mode with the same `atom_mask`, on its own lists.

Tolerances. The two sweeps compute one function over the same pairs in
other summation orders: per-atom dU/dx, u and dU/dp agree to 1e-5 in
relative norm (as tests/test_torch_rowscan_modes.py holds the unmasked
forms). Atoms outside the subset get exactly zero force and dU/dp in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.ops import nonbonded_kernel as tnb
from timemachine_torch.ops import rowscan_kernel as trs
from timemachine_torch.potentials import Nonbonded, NonbondedAllPairs
from timemachine_tpu import potentials as jpot
from timemachine_tpu.ops.pallas import nonbonded_kernel as jnb
from timemachine_tpu.ops.pallas import rowscan_kernel as jrs

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, SKIN, CUTOFF = 2.0, 0.1, 0.8
F32 = torch.float32
TOL = 1e-5


def masked_fluid(seed, coincident=False):
    """10^3 atoms on a jittered 0.31 nm lattice (box 3.1 nm), shifted half a
    box so chunks straddle the faces; w lifts a tenth of the atoms; a random
    tenth of the atoms is outside the subset. coincident=True also puts two
    masked atoms on one point and two more 5e-4 nm apart (r^2 = 2.5e-7,
    inside the sweep's gate)."""
    rng = np.random.default_rng(seed)
    n_side, spacing = 10, 0.31
    n = n_side**3
    pts = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3) * spacing
    box = np.eye(3) * (n_side * spacing)
    conf = pts + rng.normal(0, 0.03, (n, 3)) + 0.5 * np.diagonal(box)
    w = rng.uniform(0.0, 0.6, n) * (rng.random(n) < 0.1)
    params = np.stack([rng.uniform(-0.8, 0.8, n) * np.sqrt(138.935456), rng.uniform(0.05, 0.16, n),
                       rng.uniform(0.05, 0.9, n) ** 0.5, w], 1)
    mask = rng.random(n) >= 0.1
    if coincident:
        out = np.nonzero(~mask)[0]
        conf[out[1]] = conf[out[0]]
        conf[out[3]] = conf[out[2]] + np.array([5e-4, 0.0, 0.0])
    return conf, params, box, mask


def _t(a, dtype=F32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("coincident", [False, True])
def test_masked_energy_force_matches_jax(coincident):
    """The energy/force entry (F+U, triangular, minimum image, w) under the
    subset against JAX's make_nonbonded_rowscan_energy_force(atom_mask=):
    u and dU/dx to 1e-5; masked atoms get zero force; with two coincident
    masked atoms and two at r^2 = 2.5e-7 everything stays finite."""
    conf, params, box, mask = masked_fluid(0, coincident)
    mask_t = torch.as_tensor(mask)
    pairs = trs.suggest_max_pairs(_t(conf), _t(box), CUTOFF, margin=1.4, triangular=True, atom_mask=mask_t)
    u, f = trs.make_nonbonded_rowscan_energy_force(BETA, CUTOFF, pairs, atom_mask=mask_t)(_t(conf), _t(params), _t(box))
    j_ef = jrs.make_nonbonded_rowscan_energy_force(BETA, CUTOFF, 2 * pairs, interpret=True, atom_mask=mask.astype(np.float32))
    u_j, f_j = j_ef(_j(conf), _j(params), _j(box))
    assert np.isfinite(float(u)) and bool(torch.isfinite(f).all())
    assert float(u) == pytest.approx(float(u_j), rel=TOL)
    assert _rel_norm(f.numpy(), np.asarray(f_j)) < TOL
    assert not f[~mask_t].any() and not np.asarray(f_j)[~mask].any()


def test_masked_lists_leave_masked_atoms_out():
    """A chunk box holds only atoms of the subset: masking every atom of the
    first row chunk empties its list (no box from the +-1e9 fill), and the
    listed count never exceeds the unmasked one."""
    conf, params, box, _ = masked_fluid(1)
    full = trs.build_rowscan_tiles(_t(conf), _t(box), CUTOFF, 10**5, triangular=True)
    mask = torch.ones(conf.shape[0], dtype=torch.bool)
    mask[full.pad_order[: trs.ROW]] = False
    tiles = trs.build_rowscan_tiles(_t(conf), _t(box), CUTOFF, 10**5, triangular=True, atom_mask=mask)
    assert int(full.row_count[0]) > 0 and int(tiles.row_count[0]) == 0
    assert (tiles.rank_mat[0] < 0).all() and int(tiles.row_count.sum()) <= int(full.row_count.sum())


def test_masked_md_provider_matches_jax():
    """The MD provider under the subset (triangular, no preshift, w) against
    JAX's make_nonbonded_rowscan_md(atom_mask=): three steps with a rebuild
    every two and 0.004 nm of drift a step, forces to 1e-5 at every step,
    the energy through the cached lists (mode U) to 1e-5; masked atoms get
    zero force."""
    conf, params, box, mask = masked_fluid(2)
    mask_t = torch.as_tensor(mask)
    max_pairs = trs.suggest_max_pairs(_t(conf), _t(box), CUTOFF + SKIN, margin=1.4, triangular=True, atom_mask=mask_t)
    init, apply, energy, _ = trs.make_nonbonded_rowscan_md(
        BETA, CUTOFF, max_pairs, skin=SKIN, rebuild_interval=2, atom_mask=mask_t
    )
    j_init, j_apply, j_energy, *_ = jrs.make_nonbonded_rowscan_md(
        BETA, CUTOFF, 2 * max_pairs, skin=SKIN, rebuild_interval=2, interpret=True, triangular=True,
        atom_mask=mask.astype(np.float32),
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
    u = float(energy(state, _t(x), _t(params), _t(box)))
    assert u == pytest.approx(float(j_energy(j_state, jnp.asarray(x), p32, _j(box))), rel=TOL)


def test_masked_dp_matches_jax():
    """dU/dp of the block-tile DP pass under the subset against JAX's
    _run_dp(atom_mask=) in interpret mode: 1e-5 relative norm per column,
    zero rows for masked atoms in both."""
    conf, params, box, mask = masked_fluid(3)
    mask_t = torch.as_tensor(mask)
    tiles = tnb.suggest_max_tiles(_t(conf), _t(box), CUTOFF, margin=1.4, cb=2, triangular=True, atom_mask=mask_t)
    dp = tnb.run_dp(_t(conf), _t(params), _t(box), BETA, CUTOFF, tiles, cb=2, atom_mask=mask_t).numpy()
    j_tiles = jnb.suggest_max_tiles(conf, box, CUTOFF, margin=1.4, cb=2, atom_mask=mask.astype(np.float32))
    dp_j = np.asarray(jnb._run_dp(conf, params, box, BETA, CUTOFF, j_tiles, True, cb=2, atom_mask=mask.astype(np.float32)))
    assert not dp[~mask].any() and not dp_j[~mask].any()
    for c in range(4):
        assert _rel_norm(dp[:, c], dp_j[:, c]) < TOL, c


def test_masked_chop_keeps_every_pair():
    """Lists under the subset built at cutoff + skin, then 0.02 nm of jitter
    across the box faces: the f64 sweep over the per-step chopped lists
    equals the sweep over the whole lists to 1e-12 of the largest |dU/dx|
    (the chop boxes every atom of a chunk, the subset's and the others)."""
    conf, params, box, mask = masked_fluid(4)
    f64, mask_t = torch.float64, torch.as_tensor(mask)
    tiles = trs.build_rowscan_tiles(_t(conf), _t(box), CUTOFF + SKIN, 10**5, triangular=True, atom_mask=mask_t)
    moved = conf + np.random.default_rng(5).normal(0, 0.02, conf.shape)
    prows = trs.param_rows(_t(params, f64), tiles.pad_order, conf.shape[0], mask_t)
    atoms = trs.assemble_atoms(_t(moved, f64), _t(box, f64), tiles.pad_order, prows)
    chopped = trs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, _t(box, f64), CUTOFF)
    assert int(chopped.sum()) < int(tiles.row_count.sum())
    series = trs.es_energy_force_series(BETA, CUTOFF)
    sweep = [
        trs.rowscan_sweep(atoms, tiles.row_start, c, tiles.col_ids, trs.sweep_scalars(_t(box, f64), CUTOFF), series, trs.FORCE_ENERGY, True)
        for c in (chopped, tiles.row_count)
    ]
    assert np.abs((sweep[0] - sweep[1])[:, 1:4].numpy()).max() < 1e-12 * np.abs(sweep[1][:, 1:4].numpy()).max()


@pytest.mark.parametrize("kernel", ["rowscan", "quad", "gather", "dot", "v1"])
def test_configure_under_a_subset(kernel):
    """configure under atom_idxs keeps JAX's rules: quad falls back to
    rowscan, whose MD provider takes no preshift (JAX's configure_pallas
    does both on the same geometry); gather, dot and v1 take the subset, as
    JAX's do (dot where its image bound holds on the subset's atoms, which
    JAX reads on every atom: the port takes dot wherever JAX does).
    Where it configures, the MD force equals the energy/force entry's to
    1e-5 and is zero outside the subset; Nonbonded keeps only the exclusions
    inside the subset."""
    conf, params, box, mask = masked_fluid(6)
    cutoff, n = 1.2, conf.shape[0]
    idxs = np.nonzero(mask)[0]
    nb = NonbondedAllPairs(n, BETA, cutoff, params, atom_idxs=idxs, device="cpu", dtype=F32)
    nb.configure(_t(box), _t(conf), kernel=kernel)
    pot = jpot.NonbondedAllPairs(n, beta=BETA, cutoff=cutoff, atom_idxs=idxs)
    pot.configure_pallas(box, conf, interpret=True, kernel=kernel)
    if kernel in ("rowscan", "quad"):
        assert nb.kernel == pot.pallas_kernel == "rowscan" and not nb.md_preshift
    elif kernel == "dot":
        assert nb.kernel == "dot" or pot.pallas_kernel == "rowscan"
    else:
        assert nb.kernel == pot.pallas_kernel == kernel
    init, apply, _, _, _ = nb.md_force_provider()
    f, _ = apply(init(_t(conf), _t(box)), _t(conf), _t(box), 0)
    assert _rel_norm(f.numpy(), nb.energy_force(_t(conf), _t(box))[1].numpy()) < TOL
    assert not f[~torch.as_tensor(mask)].any()
    exc = np.array([[0, 1], [int(np.nonzero(~mask)[0][0]), 2], [3, 4]])
    nbx = Nonbonded(n, exc, np.ones((3, 2)), BETA, cutoff, params, atom_idxs=idxs, device="cpu", dtype=F32)
    keep = np.isin(exc, idxs).all(1)
    assert nbx.tail_idxs.tolist() == exc[keep].tolist()
