"""The port's utility surface (timemachine_torch/lib.py) against
timemachine_tpu/lib.py, on inputs made from a numpy seed, in float64 on the
CPU: the cases of tests/test_lib.py on both packages.

Tolerances: the Hilbert permutations, the block bounds and the neighbour
lists equal (the same float64 operations in the same order); the
segmented logsumexp to 1e-12 relative (numpy's and torch's sums);
NonbondedMolEnergy, uniform and ragged, to 1e-10 relative (the same pair
function, summed in another order). The sampler is held to its formula on
its own uniforms (ROADMAP P32) and to the distribution.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.special import logsumexp as scipy_logsumexp

from timemachine_torch import lib as tl

torch.set_num_threads(1)  # the suite's workers share the host's cores

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
TOL_LSE = 1e-12
TOL_MOL_ENERGY = 1e-10


def _jl():
    from timemachine_tpu import lib as jl

    return jl


def _box_coords(seed, n, bw):
    rng = np.random.default_rng(seed)
    # some atoms outside the box, so that the wrap is exercised
    return rng.uniform(-0.5 * bw, 1.5 * bw, (n, 3)), np.eye(3) * bw


@pytest.mark.parametrize("bits", [3, 5])
def test_hilbert_keys_of_cell_centres_are_jaxs_lut(bits):
    """HilbertSort's index of a cell, hilbert_keys at its centre, is the
    entry of JAX's hilbert_lut for every cell."""
    from timemachine_tpu.ops.pallas.nonbonded_kernel import hilbert_lut

    from timemachine_torch.ops.nonbonded_kernel import hilbert_keys

    side = 1 << bits
    g = torch.arange(side, dtype=torch.float64)
    cells = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(-1, 3)
    np.testing.assert_array_equal(hilbert_keys((cells + 0.5) / side, bits).numpy(), hilbert_lut(bits))


@pytest.mark.parametrize("seed,n,bw", [(0, 600, 3.0), (1, 97, 2.1)])
def test_hilbert_sort_equals_jax_and_is_local(seed, n, bw):
    coords, box = _box_coords(seed, n, bw)
    perm = tl.HilbertSort(n, device=CPU).sort(coords, box)
    assert perm.dtype == np.uint32 and sorted(perm.tolist()) == list(range(n))
    np.testing.assert_array_equal(perm, _jl().HilbertSort(n).sort(coords, box))
    inside = np.mod(coords, bw)
    d_sorted = np.linalg.norm(np.diff(inside[perm], axis=0), axis=1).mean()
    d_rand = np.linalg.norm(np.diff(inside, axis=0), axis=1).mean()
    assert d_sorted < 0.5 * d_rand


@pytest.mark.parametrize("seed,n,bw,cutoff", [(1, 333, 3.0, 1.0), (4, 70, 2.5, 1.2)])
def test_neighborlist_equals_jax_and_covers_all_pairs(seed, n, bw, cutoff):
    coords, box = _box_coords(seed, n, bw)
    t_nb = tl.Neighborlist(n, device=CPU)
    j_nb = _jl().Neighborlist(n)
    nblist = t_nb.get_nblist(coords, box, cutoff)
    assert nblist == j_nb.get_nblist(coords, box, cutoff)
    assert t_nb.get_tile_ixn_count() == j_nb.get_tile_ixn_count() == sum(len(ids) for ids in nblist)
    assert t_nb.get_max_ixn_count() == j_nb.get_max_ixn_count()
    for a, b in zip(t_nb.compute_block_bounds(coords, box), j_nb.compute_block_bounds(coords, box)):
        np.testing.assert_array_equal(a, b)

    covered = set()
    for b, ids in enumerate(nblist):
        for j in ids:
            for i in range(b * 32, min((b + 1) * 32, n)):
                if i < j:
                    covered.add((i, j))
    d = coords[:, None, :] - coords[None, :, :]
    d -= bw * np.round(d / bw)
    ii, jj = np.nonzero(np.triu(np.sqrt((d**2).sum(-1)) < cutoff, k=1))
    assert all((i, j) in covered for i, j in zip(ii, jj))


def test_neighborlist_row_idxs_mode_equals_jax():
    coords, box = _box_coords(2, 200, 3.0)
    rows = np.arange(40, dtype=np.uint32)
    t_nb, j_nb = tl.Neighborlist(200, device=CPU), _jl().Neighborlist(200)
    for nb in (t_nb, j_nb):
        nb.set_row_idxs(rows)
    assert t_nb.get_num_row_idxs() == 40
    nblist = t_nb.get_nblist(coords, box, 1.0)
    assert nblist == j_nb.get_nblist(coords, box, 1.0)
    for a, b in zip(t_nb.compute_block_bounds(coords, box), j_nb.compute_block_bounds(coords, box)):
        np.testing.assert_array_equal(a, b)
    listed = set().union(*map(set, nblist))
    assert listed <= set(range(40, 200))
    d = coords[:40, None, :] - coords[None, 40:, :]
    d -= 3.0 * np.round(d / 3.0)
    hit_cols = np.nonzero((np.sqrt((d**2).sum(-1)) < 1.0).any(axis=0))[0] + 40
    assert set(hit_cols.tolist()) <= listed
    t_nb.reset_row_idxs()
    assert t_nb.get_num_row_idxs() == 200
    with pytest.raises(RuntimeError):
        t_nb.set_row_idxs(np.arange(200))
    with pytest.raises(RuntimeError):
        t_nb.resize(0)


def test_segmented_sumexp_matches_jax_and_scipy():
    rng = np.random.default_rng(3)
    segs = [rng.normal(0, 10, size=k).tolist() for k in (1, 5, 17, 100)]
    out = tl.SegmentedSumExp(128, 8, device=CPU).logsumexp(segs)
    ref = _jl().SegmentedSumExp(128, 8).logsumexp(segs)
    for o, r, seg in zip(out, ref, segs):
        assert o == pytest.approx(r, rel=TOL_LSE)
        assert o == pytest.approx(float(scipy_logsumexp(seg)), rel=TOL_LSE)
        assert o == pytest.approx(float(torch.logsumexp(torch.tensor(seg, dtype=torch.float64), 0)), rel=TOL_LSE)
    assert tl.SegmentedSumExp(4, 1, device=CPU).logsumexp([[]]) == [-np.inf]
    with pytest.raises(RuntimeError):
        tl.SegmentedSumExp(2, 1, device=CPU).logsumexp([[1.0, 2.0, 3.0]])


def test_segmented_sampler_distribution_and_repeat():
    sampler = tl.SegmentedWeightedRandomSampler(8, 2, seed=5, device=CPU)
    counts = np.zeros(3)
    draws = []
    for _ in range(600):
        idx = sampler.sample([[1.0, 2.0, 7.0], [5.0, 5.0]])
        draws.append(idx)
        counts[idx[0]] += 1
        assert idx[1] in (0, 1)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.7], atol=0.06)
    again = tl.SegmentedWeightedRandomSampler(8, 2, seed=5, device=CPU)
    assert [again.sample([[1.0, 2.0, 7.0], [5.0, 5.0]]) for _ in range(600)] == draws


def test_segmented_sampler_is_gumbel_argmax_of_its_uniforms():
    """Given the generator's uniforms, the draw is argmax(log w + Gumbel),
    JAX's categorical on the same noise."""
    import jax.numpy as jnp

    w = np.random.default_rng(6).uniform(0.1, 3.0, 12)
    sampler = tl.SegmentedWeightedRandomSampler(16, 1, seed=9, device=CPU)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(9)
    for _ in range(20):
        u = torch.rand(12, generator=gen, dtype=torch.float64).numpy()
        j = int(jnp.argmax(jnp.log(jnp.asarray(w)) - jnp.log(-jnp.log(jnp.asarray(u)))))
        assert sampler.sample([w]) == [j]


def test_segmented_sampler_rejects_bad_weights():
    sampler = tl.SegmentedWeightedRandomSampler(8, 1, seed=0, device=CPU)
    for bad in ([[-1.0, 2.0]], [[np.inf, 1.0]], [[0.0, 0.0]], [[1.0] * 9], [[1.0], [1.0]]):
        with pytest.raises(RuntimeError):
            sampler.sample(bad)


def _mol_energy_case():
    rng = np.random.default_rng(3)
    n = 60
    conf = rng.uniform(0, 2.4, (n, 3))
    box = np.eye(3) * 2.4
    params = np.stack([rng.uniform(-1, 1, n), rng.uniform(0.05, 0.15, n), rng.uniform(0.1, 0.6, n), rng.uniform(0, 0.3, n)], 1)
    return n, conf, params, box


@pytest.mark.parametrize("mols", [[[0, 1, 2], [3, 4, 5], [9, 10, 11]], [[0, 1, 2], [7, 8], [20]]], ids=["uniform", "ragged"])
def test_nonbonded_mol_energy_equals_jax(mols):
    n, conf, params, box = _mol_energy_case()
    out = tl.NonbondedMolEnergy(n, mols, beta=2.0, cutoff=1.2, device=CPU).execute(conf, params, box)
    ref = _jl().NonbondedMolEnergy(n, mols, beta=2.0, cutoff=1.2).execute(conf, params, box)
    assert out.shape == (len(mols),) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=TOL_MOL_ENERGY, atol=0)


def test_nonbonded_mol_energy_chunks_and_coincident_atoms():
    """Chunks of one molecule give the same energies; an atom on another
    molecule's atom gives +inf, as JAX's."""
    n, conf, params, box = _mol_energy_case()
    mols = [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(10)]
    me = tl.NonbondedMolEnergy(n, mols, beta=2.0, cutoff=1.2, device=CPU)
    whole = me.execute(conf, params, box)
    me.SLOTS = {"cpu": 3 * n}
    np.testing.assert_allclose(me.execute(conf, params, box), whole, rtol=1e-14, atol=0)
    conf[40], params[40, 3] = conf[0], params[0, 3]  # one point in 4D
    out = tl.NonbondedMolEnergy(n, mols, beta=2.0, cutoff=1.2, device=CPU).execute(conf, params, box)
    ref = _jl().NonbondedMolEnergy(n, mols, beta=2.0, cutoff=1.2).execute(conf, params, box)
    assert np.isinf(out[0]) and np.array_equal(np.isinf(out), np.isinf(ref))


def test_aliases_and_device_reset():
    assert tl.HilbertSort_f32 is tl.HilbertSort_f64 is tl.HilbertSort
    assert tl.Neighborlist_f32 is tl.Neighborlist
    assert tl.SegmentedSumExp_f64 is tl.SegmentedSumExp
    assert tl.SegmentedWeightedRandomSampler_f32 is tl.SegmentedWeightedRandomSampler
    assert tl.NonbondedMolEnergy_f64 is tl.NonbondedMolEnergy
    from timemachine_torch.ops import nonbonded_kernel

    nonbonded_kernel.es_switch_poly_coeffs(2.0, 1.2)
    tl.device_reset()
    assert not nonbonded_kernel._es_poly_cache
    assert issubclass(tl.InvalidHardware, Exception)
