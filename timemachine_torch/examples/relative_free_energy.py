"""Relative binding free energy of a ligand pair: the solvent and complex
legs, with each window's frames written as CIF (counterpart of
examples/relative_free_energy.py).

    python -m timemachine_torch.examples.relative_free_energy --n_frames N --ligands L.sdf \
        --mol_a_name A --mol_b_name B --protein P.pdb [--legs solvent complex] [--device cuda]

Without arguments it runs the hif2a pair of testsystems/relative.py, whose
ligands_40.sdf the repository does not hold: it raises FileNotFoundError.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
from timemachine_torch.fe import atom_mapping, cif_writer
from timemachine_torch.fe.free_energy import HREXParams, MDParams, WaterSamplingParams
from timemachine_torch.fe.rbfe import run_complex, run_solvent
from timemachine_torch.fe.single_topology import AtomMapMixin
from timemachine_torch.fe.utils import read_sdf
from timemachine_torch.ff import Forcefield
from timemachine_torch.testsystems.data import path_to_data
from timemachine_torch.testsystems.relative import get_hif2a_ligand_pair_single_topology


def write_trajectory_as_cif(mol_a, mol_b, core, all_frames, host_topology, prefix):
    """One CIF per window, {prefix}_{window}.cif: the host and both end-state
    ligands at every frame, in Angstrom."""
    atom_map_mixin = AtomMapMixin(mol_a, mol_b, core)
    n_host_atoms = sum(len(res.atomic_nums) for res in host_topology.residues)
    for window_idx, window_frames in enumerate(all_frames):
        writer = cif_writer.CIFWriter([host_topology, mol_a, mol_b], f"{prefix}_{window_idx}.cif")
        for frame in window_frames:
            host_frame = frame[:n_host_atoms]
            ligand_frame = frame[n_host_atoms:]
            mol_ab_frame = cif_writer.convert_single_topology_mols(ligand_frame, atom_map_mixin)
            writer.write_frame(np.concatenate([host_frame, mol_ab_frame]) * 10)
        writer.close()


def run_pair(mol_a, mol_b, core, forcefield, md_params, protein_path, legs=("solvent", "complex"), output_dir=".",
             n_windows=None, device=None):
    """Each leg on `device` (None: the card): its overlap plot (where
    matplotlib renders it), its windows' CIF frames and its dG line."""
    from pathlib import Path

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    runners = {"solvent": (run_solvent, None), "complex": (run_complex, protein_path)}
    results = {}
    for leg in legs:
        runner, host_arg = runners[leg]
        res, host_config = runner(mol_a, mol_b, core, forcefield, host_arg, md_params=md_params, n_windows=n_windows,
                                  device=device)
        if res.plots is not None:
            with open(out / f"{leg}_overlap.png", "wb") as fh:
                fh.write(res.plots.overlap_detail_png)
        write_trajectory_as_cif(
            mol_a, mol_b, core, res.frames, host_config.host_topology, str(out / f"{leg}_traj")
        )
        print(
            f"{leg} dG: {np.sum(res.final_result.dGs):.3f} "
            f"+- {np.linalg.norm(res.final_result.dG_errs):.3f} kJ/mol"
        )
        results[leg] = res
    return results


def hif2a_pair(device=None):
    mol_a, mol_b, core = get_hif2a_ligand_pair_single_topology()
    forcefield = Forcefield.load_default()
    protein_path = str(path_to_data("data", "hif2a_nowater_min.pdb"))
    md_params = MDParams(n_frames=100, n_eq_steps=200_000, steps_per_frame=400, seed=2023)
    return run_pair(mol_a, mol_b, core, forcefield, md_params, protein_path=protein_path, device=device)


def get_mol_by_name(mols, name):
    for m in mols:
        if m.name == name:
            return m
    raise AssertionError("Mol not found")


def read_from_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Estimate relative free energy difference between complex and solvent legs."
    )
    parser.add_argument("--n_frames", type=int, required=True)
    parser.add_argument("--ligands", type=str, required=True)
    parser.add_argument("--mol_a_name", type=str, required=True)
    parser.add_argument("--mol_b_name", type=str, required=True)
    parser.add_argument("--protein", type=str, required=True)
    parser.add_argument("--n_eq_steps", type=int, default=10_000)
    parser.add_argument("--steps_per_frame", type=int, default=400)
    parser.add_argument("--seed", type=int, default=2023)
    parser.add_argument("--use_hrex", action="store_true")
    parser.add_argument("--use_water_sampling", action="store_true")
    parser.add_argument("--legs", nargs="+", default=["solvent", "complex"], choices=["solvent", "complex"])
    parser.add_argument("--output_dir", default=".")
    parser.add_argument("--n_windows", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    mols = read_sdf(args.ligands)
    mol_a = get_mol_by_name(mols, args.mol_a_name)
    mol_b = get_mol_by_name(mols, args.mol_b_name)

    core = atom_mapping.get_cores(mol_a, mol_b, **DEFAULT_ATOM_MAPPING_KWARGS)[0]

    md_params = MDParams(
        n_frames=args.n_frames,
        n_eq_steps=args.n_eq_steps,
        steps_per_frame=args.steps_per_frame,
        seed=args.seed,
        hrex_params=HREXParams() if args.use_hrex else None,
        water_sampling_params=WaterSamplingParams() if args.use_water_sampling else None,
    )
    forcefield = Forcefield.load_default()
    return run_pair(
        mol_a, mol_b, core, forcefield, md_params, args.protein,
        legs=tuple(args.legs), output_dir=args.output_dir, n_windows=args.n_windows, device=args.device,
    )


def main(argv=None):
    """The hif2a pair without arguments, else the pair the arguments name."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        return hif2a_pair()
    return read_from_args(argv)


if __name__ == "__main__":
    main()
