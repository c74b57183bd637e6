"""The rowscan CUDA kernel against its plain PyTorch version, on a card.

Every test here needs a CUDA device and skips without one (decided in the
`cuda` fixture, never at import). This file imports no JAX, so it also runs
where JAX is not installed:

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: both sides are f32 and sum each atom's pairs in different
orders, and the kernel's rsqrt is approximate (2 ulp), so gradients and
per-atom energies agree to a relative norm of 1e-4 (measured ~1e-6).
"""

import numpy as np
import pytest
import torch

from timemachine_torch.ops import rowscan_kernel as rs

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
