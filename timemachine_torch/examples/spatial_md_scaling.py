"""Spatially decomposed MD over a mesh of ranks: a usage demonstration and a
scaling probe (counterpart of examples/spatial_md_scaling.py).

One water box's whole force pass (the sweep's row slabs, the bonded terms,
the exclusion pairs) is split over the ranks of a mesh with one all-reduce
of the force a step (parallel/spatial_md.py), and the example prints
steps/s for each mesh size. Each mesh size runs as that many spawned ranks
of a new process group: nccl where each rank has a card of its own, gloo on
the CPU and for ranks that share a card.

    python -m timemachine_torch.examples.spatial_md_scaling --box-width 2.6 --n-steps 10 --mesh-sizes 1 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import warnings

import numpy as np
import torch

from timemachine_torch.device import resolve_device, working_dtype


def _rank(rank: int, args: dict, n_ranks: int, out_path: str):
    """One rank's run: a warm-up run, then the timed run; rank 0 writes the result."""
    from timemachine_torch.convert import host_system_arrays
    from timemachine_torch.fe.system import HostSystem
    from timemachine_torch.md.builders import build_water_system
    from timemachine_torch.md.utils import sample_velocities
    from timemachine_torch.parallel.mesh import make_mesh
    from timemachine_torch.parallel.spatial_md import make_spatial_md_runner

    device = resolve_device(args["device"])
    mesh = make_mesh(device, "spatial")  # first: it sets this rank's card, where the tensors below go
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        host_config = build_water_system(args["box_width"])
    host = HostSystem.from_arrays(host_system_arrays(host_config.host_system), device=device, dtype=working_dtype(device))
    x0 = np.asarray(host_config.conf, np.float32)
    box = np.asarray(host_config.box, np.float32)
    v0 = np.asarray(sample_velocities(host_config.masses, args["temperature"], seed=7), np.float32)
    make_run = make_spatial_md_runner(host.get_U_fns(), host_config.masses, mesh, conf0=x0, box0=box)
    run = make_run(args["temperature"], args["dt"], 1.0, args["n_steps"])
    run(x0, v0, box, 2026)  # warm-up: the kernel's build and first launches
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, _, _ = run(x0, v0, box, 2026)
    finite = bool(torch.isfinite(x).all())  # a host sync
    elapsed = time.perf_counter() - t0
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(dict(n_atoms=len(x0), ranks=n_ranks, seconds=elapsed, finite=finite), f)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Spatially decomposed MD: steps/s by mesh size")
    parser.add_argument("--box-width", type=float, default=2.6, help="water box width (nm)")
    parser.add_argument("--n-steps", type=int, default=10)
    parser.add_argument("--temperature", type=float, default=300.0)
    parser.add_argument("--dt", type=float, default=1e-3, help="ps")
    parser.add_argument("--mesh-sizes", type=int, nargs="*", default=None,
                        help="rank counts to time (default: powers of 2 up to the devices there are)")
    parser.add_argument("--interpret", action="store_true",
                        help="JAX's option; no counterpart (the CPU runs the sweep's plain version)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from timemachine_torch.parallel.mesh import default_backend, spawn_ranks

    device = resolve_device(args.device)
    available = torch.cuda.device_count() if device.type == "cuda" else (os.cpu_count() or 1)
    sizes = args.mesh_sizes or [d for d in (1, 2, 4, 8, 16) if d <= max(available, 1)]
    rank_args = dict(box_width=args.box_width, n_steps=args.n_steps, temperature=args.temperature, dt=args.dt,
                     device=str(device))
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for n_ranks in sizes:
            backend = default_backend(device, n_ranks)
            out = os.path.join(tmp, f"mesh{n_ranks}.json")
            spawn_ranks(_rank, n_ranks, (rank_args, n_ranks, out), backend=backend, store_dir=tmp)
            with open(out) as f:
                res = json.load(f)
            if not res["finite"]:
                raise RuntimeError(f"mesh={n_ranks}: the coordinates are not finite")
            if not results:
                print(f"# {res['n_atoms']} atoms, device={device.type}")
            rate = args.n_steps / res["seconds"]
            print(f"mesh={n_ranks} ({backend}): {rate:.2f} steps/s ({res['seconds'] / args.n_steps * 1e3:.2f} ms/step)")
            results.append(dict(mesh=n_ranks, backend=backend, steps_per_s=rate))
    return results


if __name__ == "__main__":
    main()
