"""Every part of the mesh code at small shapes on a mesh of spawned ranks
(counterpart of __graft_entry__.py's dryrun_multichip(n_devices)).

Each rank runs, over a mesh of all n_ranks ranks (K = n_ranks states):

1. run_hrex_sharded on a vacuum ligand's charge-decoupling ladder (ethanol
   from SMILES, its pair charges scaled down to 0 over K states), 2
   iterations of 5 steps;
2. run_sims_hrex, the production runner sharded over gcd(K, ranks) ranks,
   on that ladder and on K solvated decoupling windows as
   fe/absolute_hydration.setup_initial_states builds them (a 2.6 nm water
   box; --fire-steps cuts the host's FIRE);
3. make_spatial_md_runner on a 2.6 nm water box, 3 steps.

Rank 0 prints a line a part. The ranks are nccl processes where each has a
card of its own, else gloo processes (on the CPU, or sharing a card).

    python -m timemachine_torch.examples.dryrun_multichip [--n-ranks 2] [--device cpu] [--fire-steps 500]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time
import warnings

import numpy as np
import torch

from timemachine_torch.device import resolve_device, working_dtype


def _ladder(guest_modules, k_states: int):
    """K copies of the vacuum ligand's modules, the pair list's charges (the
    last term's column 0) scaled by 1 - lambda, lambda over [0, 1]."""
    ladder = []
    for lam in np.linspace(0, 1, k_states):
        mods = [copy.deepcopy(m) for m in guest_modules]
        with torch.no_grad():
            mods[-1].params[:, 0] *= 1.0 - lam
        ladder.append((float(lam), mods))
    return ladder


def _rank(rank: int, n_ranks: int, device_name: str, fire_steps: int, out_path: str):
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.chem.embed import embed_mol
    from timemachine_torch.convert import host_system_arrays
    from timemachine_torch.fe import absolute_hydration
    from timemachine_torch.fe.free_energy import AbsoluteFreeEnergy, HREXParams, InitialState, MDParams, run_sims_hrex
    from timemachine_torch.fe.system import HostSystem
    from timemachine_torch.fe.terms import make_summed_potential
    from timemachine_torch.fe.topology import BaseTopology
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md.builders import build_water_system
    from timemachine_torch.md.minimizer import fire_minimize_host
    from timemachine_torch.md.utils import sample_velocities
    from timemachine_torch.parallel.hrex_sharded import make_replica_mesh, run_hrex_sharded
    from timemachine_torch.parallel.mesh import make_mesh
    from timemachine_torch.parallel.spatial_md import make_spatial_md_runner

    device = resolve_device(device_name)
    dtype = working_dtype(device)
    k_states = n_ranks
    report = {}
    mesh = make_replica_mesh(device)
    t0 = time.perf_counter()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mol = embed_mol(mol_from_smiles("CCO", add_hs=True, name="lig"), seed=7)
        ff = Forcefield.load_default()
        guest = BaseTopology(mol, ff).setup_end_state()
    n = mol.num_atoms
    conf = np.asarray(mol.get_conf())
    masses = np.asarray(mol.masses)
    ladder = _ladder(guest.to_system(n, device=device, dtype=dtype).get_U_fns(), k_states)
    big_box = np.eye(3) * 100.0

    # 1. the bare-u_fn HREX over the ladder's flat parameters
    summed = make_summed_potential(ladder[0][1])
    flat = np.stack([make_summed_potential(mods).params.cpu().numpy() for _, mods in ladder])
    result = run_hrex_sharded(
        lambda x, box, p: summed.potential(x, p, box), flat, np.tile(conf, (k_states, 1, 1)),
        np.zeros((k_states, n, 3)), np.tile(big_box, (k_states, 1, 1)), masses, temperature=300.0, dt=1e-3, friction=1.0,
        n_iters=2, steps_per_iter=5, neighbor_pairs=np.array([(i, i + 1) for i in range(k_states - 1)]),
        n_swap_attempts_per_iter=k_states**3, seed=2026, mesh=mesh, device=device, dtype=torch.float64,
    )
    assert result.frames.shape == (2, k_states, n, 3) and np.all(np.isfinite(result.frames))
    report["run_hrex_sharded"] = dict(frames=list(result.frames.shape), accepted=int(result.accepted_by_pair_by_iter.sum()),
                                      seconds=round(time.perf_counter() - t0, 2))
    t0 = time.perf_counter()

    # 2. the production runner on the vacuum ladder and on solvated windows
    md_params = MDParams(n_frames=2, n_eq_steps=5, steps_per_frame=5, seed=2026,
                         hrex_params=HREXParams(n_frames_bisection=2))
    states = [
        InitialState(mods, LangevinIntegrator(300.0, 1e-3, 1.0, masses, seed=2026), None, conf,
                     sample_velocities(masses, 300.0, seed=300 + k), big_box, lam, np.arange(n, dtype=np.int32),
                     np.array([], dtype=np.int32))
        for k, (lam, mods) in enumerate(ladder)
    ]
    _, trajs, diagnostics, _ = run_sims_hrex(states, md_params, print_diagnostics_interval=None)
    assert len(trajs) == k_states and all(len(t.frames) == 2 for t in trajs)
    assert all(sorted(perm) == list(range(k_states)) for perm in diagnostics.replica_idx_by_state_by_iter)
    report["run_sims_hrex vacuum"] = dict(frames=[len(t.frames) for t in trajs],
                                          finite=bool(all(np.isfinite(t.frames[-1]).all() for t in trajs)),
                                          seconds=round(time.perf_counter() - t0, 2))
    t0 = time.perf_counter()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solv_config = build_water_system(2.6, mols=[mol])
        solv_config.box += np.diag([0.1, 0.1, 0.1])
        afe = AbsoluteFreeEnergy(mol, BaseTopology(mol, ff))
        # absolute_hydration.setup_initial_states with the host's FIRE steps a window exposed
        host_conf = fire_minimize_host([mol], solv_config, ff, n_steps_per_window=fire_steps, device=device)
        solv_states = [
            absolute_hydration._initial_state_at(afe, ff, solv_config, host_conf, 300.0, lam, 2026, device)
            for lam in np.linspace(1.0, 0.9, k_states)
        ]
    setup_seconds = round(time.perf_counter() - t0, 2)
    _, trajs_s, _, _ = run_sims_hrex(solv_states, md_params, print_diagnostics_interval=None)
    assert len(trajs_s) == k_states and all(len(t.frames) == 2 for t in trajs_s)
    finite = all(np.all(np.isfinite(np.asarray(t.frames[-1]))) for t in trajs_s)
    assert finite
    report["run_sims_hrex solvent"] = dict(atoms=len(solv_states[0].x0), frames=[len(t.frames) for t in trajs_s],
                                           finite=finite, setup_seconds=setup_seconds,
                                           seconds=round(time.perf_counter() - t0, 2))
    t0 = time.perf_counter()

    # 3. one water box's force pass over the mesh
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        host_config = build_water_system(2.6)
    host = HostSystem.from_arrays(host_system_arrays(host_config.host_system), device=device, dtype=dtype)
    w_x0 = np.asarray(host_config.conf, np.float32)
    w_box = np.asarray(host_config.box, np.float32)
    w_v0 = np.asarray(sample_velocities(host_config.masses, 300.0, seed=3), np.float32)
    make_run = make_spatial_md_runner(host.get_U_fns(), host_config.masses, make_mesh(device, "spatial"), conf0=w_x0,
                                      box0=w_box)
    x_out, v_out, _ = make_run(300.0, 1e-3, 1.0, n_steps=3)(w_x0, w_v0, w_box, 7)
    finite = bool(torch.isfinite(x_out).all() and torch.isfinite(v_out).all())
    assert finite
    report["make_spatial_md_runner"] = dict(atoms=len(w_x0), steps=3, finite=finite,
                                            seconds=round(time.perf_counter() - t0, 2))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(report, f)


def main(argv=None):
    parser = argparse.ArgumentParser(description="The mesh code at small shapes on a mesh of spawned ranks")
    parser.add_argument("--n-ranks", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fire-steps", type=int, default=500,
                        help="the solvated windows' host FIRE steps a window (setup_initial_states': 500)")
    args = parser.parse_args(argv)

    from timemachine_torch.parallel.mesh import default_backend, spawn_ranks

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        spawn_ranks(_rank, args.n_ranks, (args.n_ranks, str(device), args.fire_steps, out),
                    backend=default_backend(device, args.n_ranks), store_dir=tmp)
        with open(out) as f:
            report = json.load(f)
    for part, res in report.items():
        print(f"dryrun_multichip {args.n_ranks} ranks, {part}: {res}")
    print(f"dryrun_multichip OK ({args.n_ranks} ranks, {device.type})")
    return report


if __name__ == "__main__":
    main()
