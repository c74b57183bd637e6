"""Spatially decomposed MD (timemachine_torch/parallel/spatial_md.py) and
the interaction group's col_mask, against the JAX package and the port's
own Context, on JAX's fixture (tests/test_spatial_md.py): build_water_system
(2.6), 1,755 atoms, parameters and coordinates in float32 values on both
sides (the port computes in float64 on the CPU).

Four-rank cases run in 4 gloo processes (timemachine_torch.parallel.mesh
spawn_ranks, tests/torch_mesh_ranks.py); one rank is mesh=None in this
process. JAX's runner runs on 1 and 4 of the suite's 8 virtual CPU devices
(tests/conftest.py), its kernel in interpret mode.

Tolerances:
- at friction 0 the noise drops out (cc = 0): the port at 1 and 4 ranks
  against JAX at 1 and 4 devices over N_STEPS, x within 5e-4 nm and v
  within 5e-3 of the largest |v|, JAX's own bounds for its mesh against its
  Context (JAX's kernel and sums are float32);
- at friction 1, 4 ranks against 1 rank within 1e-10 nm (the same
  replicated noise, sums in another order), and 1 rank against the port's
  Context (its rowscan provider, the same seed) within 1e-8 nm; the force
  at the start, 4 ranks' against 1 rank's, within 1e-12 of its norm;
- NPT: the box finite and its volume within (0.9, 1.1) of the start, as
  JAX's test; 4 ranks against 1 rank bitwise in the box, which changes only
  through the accepted moves (the same uniforms on every rank);
- an interaction group partitioned under col_mask against the
  unpartitioned group: 4 ranks against 1 rank within 1e-10 nm, 1 rank
  against the Context within 1e-8 nm;
- the col_mask function against JAX's within 1e-12 relative (float64).
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests import torch_mesh_ranks as ranks
from timemachine_torch.convert import host_system_arrays
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.context import Context
from timemachine_torch.ops import nonbonded as t_nb
from timemachine_torch.parallel.mesh import spawn_ranks
from timemachine_tpu.md.utils import sample_velocities
from timemachine_tpu.ops import nonbonded as j_nb
from timemachine_tpu.parallel.spatial_md import make_spatial_md_runner as jax_runner

torch.set_num_threads(1)  # the suite's workers share the host's cores

TEMP, DT, N_STEPS, SEED = 300.0, 1e-3, 10, 2026


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """JAX's bound potentials and arrays, the case npz the ranks read, the
    port's runs at one rank and at four."""
    from timemachine_tpu.md.builders import build_water_system

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = build_water_system(2.6)
    bps = [bp.potential.bind(np.asarray(bp.params, np.float32)) for bp in cfg.host_system.get_U_fns()]
    masses = np.asarray(cfg.masses)
    x0 = np.asarray(cfg.conf, np.float32)
    box = np.asarray(cfg.box, np.float32)
    v0 = np.asarray(sample_velocities(masses, TEMP, seed=7), np.float32)
    arrays = host_system_arrays(cfg.host_system)
    for k, v in arrays.items():
        if k.endswith("_params"):
            arrays[k] = np.asarray(v, np.float32).astype(np.float64)
    d = tmp_path_factory.mktemp("spatial")
    case = dict(x0=x0.astype(np.float64), v0=v0.astype(np.float64), box=box.astype(np.float64), masses=masses,
                temp=TEMP, dt=DT, n_steps=N_STEPS, seed=SEED, **{f"hs_{k}": v for k, v in arrays.items()})
    np.savez(d / "case.npz", **case)
    spawn_ranks(ranks.spatial_rank, 4, (str(d / "case.npz"), str(d)), store_dir=str(d))
    four = [ranks.load(d, "spatial", r) for r in range(4)]
    return dict(bps=bps, masses=masses, x0=x0, v0=v0, box=box, case=case, one=ranks.spatial_runs(case, None),
                four=four)


def _jax_run(f, n_dev, friction):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("spatial",))
    make_run = jax_runner(f["bps"], f["masses"], mesh, interpret=True, conf0=f["x0"], box0=f["box"])
    x, v, _ = make_run(TEMP, DT, friction, N_STEPS)(f["x0"], f["v0"], f["box"], jax.random.key(SEED))
    return np.asarray(x), np.asarray(v)


def _context_x(f, with_group: bool):
    """The port's Context over the same potentials (the rowscan provider), integrator seed SEED."""
    case = f["case"]
    bps = ranks.water_host(case)
    if with_group:
        bps = ranks.with_group(bps, len(case["x0"]), next(p for p in bps if type(p).__name__ == "Nonbonded").params)
    nb = next(p for p in bps if type(p).__name__ == "Nonbonded")
    nb.configure(torch.as_tensor(case["box"]), torch.as_tensor(case["x0"]), kernel="rowscan")
    ctx = Context(case["x0"], case["v0"], case["box"], LangevinIntegrator(TEMP, DT, 1.0, case["masses"], seed=SEED), bps,
                  device="cpu")
    ctx.multiple_steps(N_STEPS)
    return ctx.get_x_t()


@pytest.mark.parametrize("n_dev", [1, 4])
def test_friction_zero_matches_jax_runner(fixture, n_dev):
    x_j, v_j = _jax_run(fixture, n_dev, 0.0)
    run = fixture["one"] if n_dev == 1 else fixture["four"][0]
    x, v = run["x_f0"], run["v_f0"]
    assert np.all(np.isfinite(x)) and np.abs(x - fixture["case"]["x0"]).max() > 1e-4  # it moved
    assert np.abs(x - x_j).max() < 5e-4
    assert np.abs(v - v_j).max() / max(np.abs(v_j).max(), 1.0) < 5e-3


def test_four_ranks_agree_with_one_and_with_each_other(fixture):
    one, four = fixture["one"], fixture["four"]
    for r in range(1, 4):  # every rank holds the same replicated state
        for key in four[0]:
            np.testing.assert_array_equal(four[r][key], four[0][key], err_msg=key)
    for key in ("x_f0", "x_f1", "x_ig"):
        assert np.abs(four[0][key] - one[key]).max() < 1e-10, key
    assert np.abs(four[0]["x_f1"] - one["x_f0"]).max() > 1e-4  # friction 1 draws noise


def test_one_rank_is_the_context(fixture):
    assert np.abs(fixture["one"]["x_f1"] - _context_x(fixture, False)).max() < 1e-8
    # the force a step takes (make_run.force): 4 ranks' all-reduced shares against one rank's
    one, four = fixture["one"]["force"], fixture["four"][0]["force"]
    assert np.linalg.norm(four - one) <= 1e-12 * np.linalg.norm(one)


def test_npt_box_moves_the_same_on_every_rank_count(fixture):
    one, four = fixture["one"], fixture["four"][0]
    box0 = fixture["case"]["box"]
    assert np.all(np.isfinite(one["box_npt"])) and np.all(np.isfinite(one["x_npt"]))
    assert 0.9 < np.linalg.det(one["box_npt"]) / np.linalg.det(box0) < 1.1
    np.testing.assert_array_equal(four["box_npt"], one["box_npt"])
    assert np.abs(four["x_npt"] - one["x_npt"]).max() < 1e-10


def test_partitioned_interaction_group_is_the_unpartitioned_group(fixture):
    one = fixture["one"]
    assert np.abs(one["x_ig"] - one["x_f1"]).max() > 1e-8  # the group moves the ligand-shaped atoms
    assert np.abs(one["x_ig"] - _context_x(fixture, True)).max() < 1e-8


def test_col_mask_matches_jax():
    """A padded column split, as the runner's: the repeated column 0 masked
    out, against JAX's function at the same arguments (float64)."""
    rng = np.random.default_rng(3)
    conf = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3) * 0.62 + rng.normal(0, 0.05, (64, 3))
    n = len(conf)
    params = np.stack([rng.uniform(-1, 1, n), rng.uniform(0.1, 0.2, n), rng.uniform(0.1, 0.9, n), rng.uniform(0, 0.1, n)], 1)
    box = np.eye(3) * 2.48
    rows = np.arange(5)
    cols = np.concatenate([np.arange(5, n), [5, 5, 5]])
    mask = np.arange(len(cols)) < n - 5
    mask[10] = False
    u_j, f_j = j_nb.interaction_group_energy_force(conf, params, box, rows, cols, 2.0, 1.2, col_mask=mask)
    t = torch.as_tensor
    u_t, f_t = t_nb.interaction_group_energy_force(t(conf), t(params), t(box), t(rows), t(cols), 2.0, 1.2, col_mask=t(mask))
    assert float(u_t) == pytest.approx(float(u_j), rel=1e-12)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-12, atol=1e-12 * np.abs(np.asarray(f_j)).max())
    u_all, _ = t_nb.interaction_group_energy_force(t(conf), t(params), t(box), t(rows), t(np.arange(5, n)), 2.0, 1.2)
    assert float(u_t) != pytest.approx(float(u_all), rel=1e-12)  # column 10 is out
