"""The mesh code's two entry points on the CPU, through main(argv):
timemachine_torch/examples/spatial_md_scaling.py (JAX's
examples/spatial_md_scaling.py: one water box's spatial runner timed at
mesh sizes 1 and 2, each a set of spawned gloo ranks) and
timemachine_torch/examples/dryrun_multichip.py (__graft_entry__.py's
dryrun_multichip: run_hrex_sharded, run_sims_hrex on a vacuum ladder and on
solvated windows, and the spatial runner, on 2 ranks; the solvated host's
FIRE cut to 40 steps a window from setup_initial_states' 500 to keep the
file's time). Each must print finite output: steps/s for every mesh size,
and every part's report finite.
"""

import math
import re

import torch

from timemachine_torch.examples import dryrun_multichip, spatial_md_scaling

torch.set_num_threads(1)  # the suite's workers share the host's cores


def test_spatial_md_scaling_times_each_mesh_size(capsys):
    results = spatial_md_scaling.main(["--box-width", "2.6", "--n-steps", "3", "--mesh-sizes", "1", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["mesh"] for r in results] == [1, 2]
    assert all(math.isfinite(r["steps_per_s"]) and r["steps_per_s"] > 0 for r in results)
    rates = re.findall(r"mesh=(\d) \(gloo\): ([0-9.]+) steps/s", out)
    assert [int(m) for m, _ in rates] == [1, 2] and all(float(v) > 0 for _, v in rates)
    assert "1755 atoms" in out


def test_dryrun_multichip_on_two_ranks(capsys):
    report = dryrun_multichip.main(["--n-ranks", "2", "--device", "cpu", "--fire-steps", "40"])
    out = capsys.readouterr().out
    assert "dryrun_multichip OK (2 ranks, cpu)" in out
    assert report["run_hrex_sharded"]["frames"] == [2, 2, 9, 3]
    assert report["run_sims_hrex vacuum"]["finite"] and report["run_sims_hrex solvent"]["finite"]
    assert report["run_sims_hrex solvent"]["frames"] == [2, 2]
    assert report["make_spatial_md_runner"]["finite"] and report["make_spatial_md_runner"]["atoms"] == 1755
