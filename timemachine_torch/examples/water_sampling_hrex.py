"""HREX with the TIBD water sampler around a decoupling probe: the probe's
AHFE ladder in a water box, the sampler firing in every replica
(counterpart of examples/water_sampling_hrex.py; the probe system and its
observables are testsystems/water_sampling.py's, JAX's
water_sampling_common names).

    python -m timemachine_torch.examples.water_sampling_hrex [--box_width 3.0] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from timemachine_torch.constants import DEFAULT_TEMP
from timemachine_torch.fe.absolute_hydration import setup_initial_states
from timemachine_torch.fe.free_energy import (
    AbsoluteFreeEnergy,
    HREXParams,
    MDParams,
    WaterSamplingParams,
    run_sims_hrex,
)
from timemachine_torch.fe.topology import BaseTopology
from timemachine_torch.ff import Forcefield
from timemachine_torch.testsystems.water_sampling import DEFAULT_BB_RADIUS, build_probe_in_water, compute_occupancy


def main(argv=None):
    parser = argparse.ArgumentParser(description="HREX + water exchange around a decoupling probe")
    parser.add_argument("--smiles", type=str, default="C1C2CC3CC1CC(C2)C3")
    parser.add_argument("--box_width", type=float, default=3.0)
    parser.add_argument("--n_windows", type=int, default=6)
    parser.add_argument("--n_frames", type=int, default=50)
    parser.add_argument("--steps_per_frame", type=int, default=100)
    parser.add_argument("--n_eq_steps", type=int, default=1000)
    parser.add_argument("--water_sampling_interval", type=int, default=100)
    parser.add_argument("--n_proposals", type=int, default=500)
    parser.add_argument("--radius", type=float, default=DEFAULT_BB_RADIUS * 2)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    mol, host_config = build_probe_in_water(args.smiles, args.box_width, args.seed)
    ff = Forcefield.load_default()

    md_params = MDParams(
        n_frames=args.n_frames,
        n_eq_steps=args.n_eq_steps,
        steps_per_frame=args.steps_per_frame,
        seed=args.seed,
        hrex_params=HREXParams(),
        water_sampling_params=WaterSamplingParams(
            interval=args.water_sampling_interval,
            n_proposals=args.n_proposals,
            batch_size=min(250, args.n_proposals),
            radius=args.radius,
        ),
    )

    # lambda ladder: 0 = fully coupled probe ... 1 = decoupled (pure water)
    lambda_schedule = np.linspace(1.0, 0.0, args.n_windows)
    bt = BaseTopology(mol, ff)
    afe = AbsoluteFreeEnergy(mol, bt)
    initial_states = setup_initial_states(afe, ff, host_config, DEFAULT_TEMP, lambda_schedule, args.seed,
                                          device=args.device)

    pair_bar, trajectories, hrex_diag, water_diag = run_sims_hrex(initial_states, md_params)

    print("\nswap acceptance rates (neighbor pairs):")
    print(np.round(hrex_diag.cumulative_swap_acceptance_rates[-1], 3))
    if water_diag is not None:
        counts = water_diag.cumulative_proposals_by_state()  # (n_states, 2) = (accepted, proposed)
        with np.errstate(invalid="ignore", divide="ignore"):
            rates = np.where(counts[:, 1] > 0, counts[:, 0] / np.maximum(counts[:, 1], 1), 0.0)
        print("water move acceptance per window:")
        print(np.round(rates, 4))

    ligand_idxs = initial_states[0].ligand_idxs
    print("\nper-window occupancy traces (waters within radius of probe centroid):")
    for k, (lamb, traj) in enumerate(zip(lambda_schedule, trajectories)):
        occs = [
            compute_occupancy(np.asarray(x), np.asarray(b), ligand_idxs, args.radius) // 3
            for x, b in zip(traj.frames, traj.boxes)
        ]
        uniq, counts = np.unique(occs, return_counts=True)
        tag = " (coupled)" if np.isclose(lamb, 0.0) else ""
        print(f"lambda={lamb:.2f}{tag}: occupancies {dict(zip(uniq.tolist(), counts.tolist()))}")

    print(f"\ndecoupling dG estimate: {np.sum(pair_bar.dGs):.2f} kJ/mol")
    return pair_bar, trajectories, hrex_diag, water_diag


if __name__ == "__main__":
    main()
