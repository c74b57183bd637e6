"""Water sampling by targeted-insertion MC in a Context: a native water box
whose first water is the target, the TIBD mover firing every batch of MD
steps (counterpart of examples/water_sampling_mc.py).

    python -m timemachine_torch.examples.water_sampling_mc [--box_width 2.6] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from timemachine_torch.constants import DEFAULT_TEMP
from timemachine_torch.convert import host_system_arrays
from timemachine_torch.device import resolve_device, working_dtype
from timemachine_torch.fe.model_utils import apply_hmr
from timemachine_torch.fe.system import HostSystem
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.builders import build_water_system
from timemachine_torch.md.context import Context
from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove
from timemachine_torch.potentials import all_pairs_kernel
from timemachine_torch.testsystems.water_sampling import compute_density, compute_occupancy


def main(argv=None):
    parser = argparse.ArgumentParser(description="Water sampling with targeted-insertion MC")
    parser.add_argument("--box_width", type=float, default=2.6)
    parser.add_argument("--radius", type=float, default=0.6)
    parser.add_argument("--n_iterations", type=int, default=20)
    parser.add_argument("--md_steps_per_batch", type=int, default=100)
    parser.add_argument("--mc_proposals_per_batch", type=int, default=200)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    host_config = build_water_system(args.box_width)
    n = host_config.conf.shape[0]
    host_system = HostSystem.from_arrays(host_system_arrays(host_config.host_system), device=device,
                                         dtype=working_dtype(device))
    bps = host_system.get_U_fns()
    # the all-pairs form JAX's Context takes at this size on this device (get_context's rule)
    nb = host_system.nonbonded_all_pairs
    x_dev = torch.as_tensor(host_config.conf, device=device, dtype=nb.params.dtype)
    box_dev = torch.as_tensor(host_config.box, device=device, dtype=nb.params.dtype)
    nb.configure(box_dev, x_dev, kernel=all_pairs_kernel("context", n, device))
    water_idxs = np.arange(n).reshape(-1, 3)
    center_idxs = np.array([0, 1, 2], dtype=np.int32)

    print(f"{n} atoms; initial density {compute_density(n // 3, host_config.box):.1f} kg/m^3")

    mover = TIBDExchangeMove(
        n_atoms=n,
        ligand_idxs=center_idxs,
        water_idxs=[g for g in water_idxs[1:]],
        params=np.asarray(host_config.host_system.nonbonded_all_pairs.params),
        temperature=DEFAULT_TEMP,
        beta=2.0,
        cutoff=1.2,
        radius=args.radius,
        seed=args.seed,
        n_proposals=args.mc_proposals_per_batch,
        interval=args.md_steps_per_batch,
    )

    masses = apply_hmr(host_config.masses, host_config.host_system.bond.potential.idxs)
    intg = LangevinIntegrator(DEFAULT_TEMP, 2.5e-3, 1.0, masses, seed=args.seed + 1)
    ctxt = Context(x_dev, torch.zeros_like(x_dev), host_config.box, intg, bps, movers=[mover], device=device)

    occupancies = []
    for it in range(args.n_iterations):
        ctxt.multiple_steps(args.md_steps_per_batch)
        occ = compute_occupancy(ctxt.get_x_t(), ctxt.get_box(), center_idxs, args.radius)
        occupancies.append(occ)
        st = ctxt._mover_states[0]
        print(
            f"iter {it:3d} | occupancy {occ:3d} | water moves {int(st.n_accepted)}/{int(st.n_proposed)} "
            f"| density {compute_density(n // 3, ctxt.get_box()):.1f} kg/m^3"
        )
    return ctxt, occupancies


if __name__ == "__main__":
    main()
