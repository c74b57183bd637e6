"""The RBFE legs of a ligand pair from an SDF: vacuum, solvent and complex,
each by HREX with REST and the water sampler, written through a FileClient
(results.npz, the end states' frames, the pickled result and host, the
HREX plots) (counterpart of examples/run_rbfe_legs.py). Each leg is a task
of a DevicePoolClient over get_device_count() cards; with --device cpu the
legs run in this process.

    python -m timemachine_torch.examples.run_rbfe_legs --sdf_path L.sdf --mol_a A --mol_b B \
        [--pdb_path P.pdb] [--legs vacuum solvent complex] [--device cuda]
"""

from __future__ import annotations

import pickle
from argparse import ArgumentParser
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from timemachine_torch.chem.sdf import write_sdf
from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
from timemachine_torch.fe import atom_mapping
from timemachine_torch.fe.free_energy import HREXParams, MDParams, RESTParams, WaterSamplingParams
from timemachine_torch.fe.plots import plot_as_png_fxn, plot_water_proposals_by_state
from timemachine_torch.fe.rbfe import (
    DEFAULT_NUM_WINDOWS,
    HREXSimulationResult,
    run_complex,
    run_solvent,
    run_vacuum,
)
from timemachine_torch.fe.utils import get_mol_name, read_sdf_mols_by_name
from timemachine_torch.ff import Forcefield
from timemachine_torch.md.exchange.utils import get_radius_of_mol_pair
from timemachine_torch.parallel.client import DevicePoolClient, FileClient, SerialClient, get_device_count


def run_leg(file_client, mol_a, mol_b, core, leg_name, ff, pdb_path, md_params, n_windows, min_overlap, device=None):
    """Run one leg on `device` (None: the card) and store results.npz, the
    end states' frames, the pickled SimulationResult and host, and the HREX
    plots (where matplotlib renders them)."""
    np.random.seed(md_params.seed)
    host_config = None
    kw = dict(n_windows=n_windows, min_overlap=min_overlap, device=device)
    if leg_name == "vacuum":
        res = run_vacuum(mol_a, mol_b, core, ff, None, md_params, **kw)
    elif leg_name == "solvent":
        res, host_config = run_solvent(mol_a, mol_b, core, ff, None, md_params, **kw)
    elif leg_name == "complex":
        assert pdb_path is not None
        res, host_config = run_complex(mol_a, mol_b, core, ff, str(Path(pdb_path).expanduser()), md_params, **kw)
    else:
        raise ValueError(f"Invalid leg: {leg_name}")

    pred_dg = float(np.sum(res.final_result.dGs))
    pred_dg_err = float(np.linalg.norm(res.final_result.dG_errs))
    print(f"{get_mol_name(mol_a)} -> {get_mol_name(mol_b)} (kJ/mol) | {leg_name} {pred_dg:.2f} +- {pred_dg_err:.2f}")

    Path(file_client.full_path(leg_name)).mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        file_client.full_path(Path(leg_name) / "results.npz"),
        pred_dg=pred_dg,
        pred_dg_err=pred_dg_err,
        overlaps=res.final_result.overlaps,
        n_windows=len(res.final_result.initial_states),
    )
    np.savez_compressed(
        file_client.full_path(Path(leg_name) / "lambda0_traj.npz"),
        coords=np.array(res.trajectories[0].frames),
        boxes=np.asarray(res.trajectories[0].boxes),
    )
    np.savez_compressed(
        file_client.full_path(Path(leg_name) / "lambda1_traj.npz"),
        coords=np.array(res.trajectories[-1].frames),
        boxes=np.asarray(res.trajectories[-1].boxes),
    )
    file_client.store(Path(leg_name) / "simulation_result.pkl", pickle.dumps(res))
    if host_config is not None:
        file_client.store(Path(leg_name) / "host_config.pkl", pickle.dumps(host_config))

    if isinstance(res, HREXSimulationResult) and res.hrex_plots is not None:
        file_client.store(Path(leg_name) / "hrex_transition_matrix.png", res.hrex_plots.transition_matrix_png)
        file_client.store(
            Path(leg_name) / "hrex_swap_acceptance_rates_convergence.png",
            res.hrex_plots.swap_acceptance_rates_convergence_png,
        )
        file_client.store(
            Path(leg_name) / "hrex_replica_state_distribution_heatmap.png",
            res.hrex_plots.replica_state_distribution_heatmap_png,
        )
        if res.water_sampling_diagnostics is not None:
            file_client.store(
                Path(leg_name) / "water_sampling_acceptances.png",
                plot_as_png_fxn(
                    plot_water_proposals_by_state,
                    [state.lamb for state in res.final_result.initial_states],
                    res.water_sampling_diagnostics.cumulative_proposals_by_state(),
                ),
            )
    return pred_dg, pred_dg_err


def main(argv=None):
    parser = ArgumentParser(description="Run the RBFE legs for a pair of molecules")
    parser.add_argument("--sdf_path", required=True)
    parser.add_argument("--mol_a", required=True)
    parser.add_argument("--mol_b", required=True)
    parser.add_argument("--pdb_path")
    parser.add_argument("--n_eq_steps", default=200_000, type=int)
    parser.add_argument("--n_frames", default=2000, type=int)
    parser.add_argument("--steps_per_frame", default=400, type=int)
    parser.add_argument("--n_windows", default=DEFAULT_NUM_WINDOWS, type=int)
    parser.add_argument("--min_overlap", default=0.667, type=float)
    parser.add_argument("--target_overlap", default=0.667, type=float)
    parser.add_argument("--seed", default=2025, type=int)
    parser.add_argument("--legs", default=["vacuum", "solvent", "complex"], nargs="+")
    parser.add_argument("--forcefield", default=None, help="Forcefield name (default: built-in default)")
    parser.add_argument("--n_devices", default=None, type=int)
    parser.add_argument("--water_sampling_padding", type=float, default=0.4)
    parser.add_argument("--disable_water_sampling", action="store_true")
    parser.add_argument("--rest_max_temperature_scale", default=3.0, type=float)
    parser.add_argument("--rest_temperature_scale_interpolation", default="exponential")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if "complex" in args.legs:
        assert args.pdb_path is not None, "Must provide PDB to run complex leg"

    mols_by_name = read_sdf_mols_by_name(args.sdf_path)
    np.random.seed(args.seed)
    mol_a = mols_by_name[args.mol_a]
    mol_b = mols_by_name[args.mol_b]

    output_dir = args.output_dir
    if output_dir is None:
        date_str = datetime.now().strftime("%Y_%b_%d_%H_%M")
        output_dir = f"rbfe_{date_str}_{args.mol_a}_{args.mol_b}"
    dest_dir = Path(output_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    file_client = FileClient(dest_dir)

    ff = Forcefield.load_from_file(args.forcefield) if args.forcefield else Forcefield.load_default()
    mol_radius = get_radius_of_mol_pair(mol_a, mol_b)

    md_params = MDParams(
        n_eq_steps=args.n_eq_steps,
        n_frames=args.n_frames,
        steps_per_frame=args.steps_per_frame,
        seed=args.seed,
        hrex_params=HREXParams(
            optimize_target_overlap=args.target_overlap,
            rest_params=(
                RESTParams(args.rest_max_temperature_scale, args.rest_temperature_scale_interpolation)
                if args.rest_max_temperature_scale != 1.0
                else None
            ),
        ),
        water_sampling_params=(
            None if args.disable_water_sampling else WaterSamplingParams(radius=mol_radius + args.water_sampling_padding)
        ),
    )

    core = atom_mapping.get_cores(mol_a, mol_b, **DEFAULT_ATOM_MAPPING_KWARGS)[0]

    with open(file_client.full_path("md_params.pkl"), "wb") as ofs:
        pickle.dump(md_params, ofs)
    with open(file_client.full_path("core.pkl"), "wb") as ofs:
        pickle.dump(core, ofs)
    with open(file_client.full_path("ff.py"), "w") as ofs:
        ofs.write(ff.serialize())
    write_sdf([mol_a, mol_b], file_client.full_path("mols.sdf"))

    device = torch.device(args.device)
    if device.type == "cuda":
        n_devices = args.n_devices or get_device_count()
        pool = DevicePoolClient(n_devices)
        device = None  # each task's card is the one its worker sees
    else:
        pool = SerialClient()
    pool.verify()

    futures = [
        pool.submit(
            run_leg, file_client, mol_a, mol_b, core, leg_name, ff, args.pdb_path,
            md_params, args.n_windows, args.min_overlap, device,
        )
        for leg_name in args.legs
    ]
    return [fut.result() for fut in futures]


if __name__ == "__main__":
    main()
