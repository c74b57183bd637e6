"""The rank side of the port's multi-rank tests (tests/test_torch_*.py
that spawn ranks): each function runs as one rank of a gloo process group
on the CPU, started by timemachine_torch.parallel.mesh.spawn_ranks, reads
its inputs from an npz the parent wrote, and writes its arrays with numpy
as `<out_dir>/<name>_r<rank>.npz` for the parent to compare. This module
imports no JAX (the ranks are new processes), and pytest does not collect
it.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from timemachine_torch.fe.system import HostSystem
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")


def save(out_dir, name: str, rank: int, **arrays):
    np.savez(Path(out_dir) / f"{name}_r{rank}.npz", **arrays)


def load(out_dir, name: str, rank: int) -> dict:
    with np.load(Path(out_dir) / f"{name}_r{rank}.npz") as z:
        return dict(z)


# -- rowscan_sweep_sharded -----------------------------------------------------------


def sweep_case(conf, params, box, triangular: bool, cutoff: float = 1.2):
    """The sweep's arguments up to the series on lists built for conf (f64, CPU)."""
    t = [torch.as_tensor(np.asarray(a)) for a in (conf, params, box)]
    mp = rs.suggest_max_pairs(t[0], t[2], cutoff, triangular=triangular)
    tiles = rs.build_rowscan_tiles(t[0], t[2], cutoff, mp, triangular=triangular)
    atoms = rs.assemble_atoms(t[0], t[2], tiles.pad_order, rs.param_rows(t[1], tiles.pad_order, t[0].shape[0]))
    return tiles, (atoms, tiles.row_start, tiles.row_count, tiles.col_ids, rs.sweep_scalars(t[2], cutoff))


def rowscan_sharded_rank(rank: int, case_path, out_dir):
    case = dict(np.load(case_path))
    mesh = make_mesh(CPU, "rows")
    series = rs.es_energy_force_series(float(case["beta"]), float(case["cutoff"]))
    out = {}
    for triangular in (False, True):
        _, args = sweep_case(case["conf"], case["params"], case["box"], triangular, float(case["cutoff"]))
        swept = rs.rowscan_sweep_sharded(*args, series, rs.FORCE_ENERGY, mesh, "rows", triangular=triangular)
        out[f"tri{int(triangular)}"] = swept.numpy()
    save(out_dir, "sharded", rank, **out)


# -- spatial MD ----------------------------------------------------------------------


def water_host(case: dict):
    """The port's potentials of the water box saved by the parent (CPU, f64)."""
    arrays = {k[len("hs_"):]: case[k] for k in case if k.startswith("hs_")}
    for k in ("beta", "cutoff"):
        arrays[k] = float(arrays[k])
    return HostSystem.from_arrays(arrays, device=CPU).get_U_fns()


def with_group(bps, n_atoms: int, params):
    """bps plus the ligand-shaped interaction group of atoms 0-5 against the rest."""
    from timemachine_torch.potentials import NonbondedInteractionGroup

    return list(bps) + [NonbondedInteractionGroup(n_atoms, np.arange(6), 2.0, 1.2, params, device=CPU)]


def spatial_runs(case: dict, mesh) -> dict:
    """The spatial runner's cases over `mesh` (None: this process alone):
    friction 0 and 1 (N steps each), NPT with a barostat every 3 steps (9
    steps), and an interaction group (friction 1)."""
    from timemachine_torch.parallel.spatial_md import make_spatial_md_runner

    bps = water_host(case)
    x0, v0, box, masses = case["x0"], case["v0"], case["box"], case["masses"]
    temp, dt, n_steps, seed = float(case["temp"]), float(case["dt"]), int(case["n_steps"]), int(case["seed"])
    make_run = make_spatial_md_runner(bps, masses, mesh, conf0=x0, box0=box)
    out = {"force": make_run.force(x0, box).numpy()}
    for friction in (0.0, 1.0):
        x, v, _ = make_run(temp, dt, friction, n_steps)(x0, v0, box, seed)
        out[f"x_f{int(friction)}"], out[f"v_f{int(friction)}"] = x.numpy(), v.numpy()
    n = len(x0)
    baro = MonteCarloBarostat(n, 1.013, temp, [np.arange(3 * w, 3 * w + 3) for w in range(n // 3)], interval=3, seed=0)
    x, _, b = make_run(temp, dt, 1.0, 9, barostat=baro)(x0, v0, box, seed)
    out["x_npt"], out["box_npt"] = x.numpy(), b.numpy()
    bps_ig = with_group(bps, n, next(p for p in bps if type(p).__name__ == "Nonbonded").params)
    make_ig = make_spatial_md_runner(bps_ig, masses, mesh, conf0=x0, box0=box)
    out["x_ig"] = make_ig(temp, dt, 1.0, n_steps)(x0, v0, box, seed)[0].numpy()
    return out


def spatial_rank(rank: int, case_path, out_dir):
    save(out_dir, "spatial", rank, **spatial_runs(dict(np.load(case_path)), make_mesh(CPU, "spatial")))


# -- sharded HREX --------------------------------------------------------------------


def harmonic_u(x, box, params):
    """3D harmonic wells (JAX's tests/test_hrex.py): U = k/2 |x|^2, params = (k,)."""
    del box
    return 0.5 * params[0] * torch.sum(x**2)


def harmonic_hrex(mesh, friction: float = 1.0, n_iters: int = 150, n_attempts=None, seed: int = 2024):
    """JAX's harmonic ladder: K = 8 wells of 4 atoms, 40 steps an iteration."""
    from timemachine_torch.constants import BOLTZ
    from timemachine_torch.parallel.hrex_sharded import run_hrex_sharded

    k_states, n_atoms, temperature = 8, 4, 300.0
    spring_ks = np.linspace(1000.0, 3000.0, k_states)
    rng = np.random.default_rng(0)
    xs0 = rng.normal(0, np.sqrt(BOLTZ * temperature / spring_ks)[:, None, None], (k_states, n_atoms, 3))
    vs0 = np.zeros_like(xs0) if friction else rng.normal(0, 0.5, xs0.shape)
    return run_hrex_sharded(
        harmonic_u, spring_ks[:, None], xs0, vs0, np.tile(np.eye(3) * 100.0, (k_states, 1, 1)), np.full(n_atoms, 12.0),
        temperature=temperature, dt=2e-3, friction=friction, n_iters=n_iters, steps_per_iter=40,
        neighbor_pairs=np.array([(i, i + 1) for i in range(k_states - 1)]),
        n_swap_attempts_per_iter=k_states**3 if n_attempts is None else n_attempts, seed=seed, mesh=mesh, device=CPU,
    )


def hrex_arrays(result) -> dict:
    return {f: getattr(result, f) for f in (
        "frames", "boxes", "replica_idx_by_state_by_iter", "accepted_by_pair_by_iter", "proposed_by_pair_by_iter",
        "final_coords", "final_velocities", "final_boxes", "log_q_kl_by_iter")}


def hrex_rank(rank: int, out_dir):
    from timemachine_torch.parallel.hrex_sharded import make_replica_mesh

    mesh = make_replica_mesh(CPU)
    save(out_dir, "hrex", rank, **hrex_arrays(harmonic_hrex(mesh)))
    save(out_dir, "hrex_f0", rank, **hrex_arrays(harmonic_hrex(mesh, friction=0.0, n_iters=3, n_attempts=0)))


# -- the production runner's replica mesh --------------------------------------------


def replica_runs(make_runner, mesh, n_iters: int = 3, n_steps: int = 5, split=None) -> dict:
    """Iterations of a ReplicaExchangeRunner from make_runner(mesh) -> (runner,
    start): each iteration's result, the final state arrays, and, with
    split, the state_dict after `split` iterations (pickled)."""
    runner, start = make_runner(mesh)
    runner.initialize(*start)
    runner.equilibrate(4)
    out, blob = {}, None
    for i in range(n_iters):
        if split is not None and i == split:
            blob = pickle.dumps(runner.state_dict())
        res = runner.advance_frame(n_steps)
        for f in ("frames_by_state", "boxes_by_state", "replica_idx_by_state", "accepted_by_pair", "proposed_by_pair",
                  "U_kl"):
            out[f"{f}_{i}"] = getattr(res, f)
    x, v, b = runner.final_state_arrays()
    out.update(final_x=x, final_v=v, final_box=b)
    counters = runner.water_counters_by_replica()
    if counters is not None:
        out["water_accepted"], out["water_proposed"] = counters
    if blob is not None:
        out["checkpoint"] = np.frombuffer(blob, dtype=np.uint8)
    return out


def replica_mesh_rank(rank: int, out_dir):
    """The water box's runner without and with the sampler (a checkpoint
    after 2 of 3 iterations), then run_sims_hrex on the harmonic states."""
    from tests.torch_replica_systems import harmonic_states, sims_hrex_arrays, water_runner

    from timemachine_torch.parallel.replica_exchange import make_replica_mesh

    mesh = make_replica_mesh(CPU)
    for name, sampler in (("replica", False), ("replica_water", True)):
        save(out_dir, name, rank, **replica_runs(lambda m, s=sampler: water_runner(s, m), mesh, split=2))
    save(out_dir, "sims_hrex", rank, **sims_hrex_arrays(harmonic_states()))
