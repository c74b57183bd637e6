"""The production HREX runner's replica axis over a mesh
(timemachine_torch/parallel/replica_exchange.py ReplicaExchangeRunner(...,
mesh=), md/context.py BatchedContext draw_rows) and run_sims_hrex's
sharding (fe/free_energy.py), on the CPU: 4 gloo ranks
(tests/torch_mesh_ranks.py) against the no-mesh run in this process.

The systems (tests/torch_replica_systems.py): four replicas of
tests/test_torch_hrex_resume.py's water box, its bonds and angles with
each state's own bond parameters, the barostat every 3 steps, and in a
second case the TIBD water sampler every 10 steps with each state's own
ligand charges; four of JAX's harmonic states for run_sims_hrex.

Every draw of the batch is made whole on every rank and sliced, so the
mesh run is the no-mesh run: bitwise (tolerance 0) in every iteration's
frames, boxes, permutation, accepted and proposed counts and U_kl over 3
iterations of 5 steps after 4 of equilibration, in the final x, v and box,
and in the sampler's counters; every rank returns the same. A checkpoint
taken on 4 ranks after 2 iterations resumes on one rank bitwise into the
third. run_sims_hrex on 4 ranks (one replica a rank) gives the no-mesh
run's frames, boxes, velocities, permutations and BAR estimates bitwise.
"""

import pickle

import numpy as np
import pytest
import torch

from tests import torch_mesh_ranks as ranks
from tests.torch_replica_systems import harmonic_states, sims_hrex_arrays, water_runner
from timemachine_torch.parallel.mesh import spawn_ranks

torch.set_num_threads(1)  # the suite's workers share the host's cores


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("replica_mesh")
    spawn_ranks(ranks.replica_mesh_rank, 4, (str(d),), store_dir=str(d))
    return d


def _assert_equal(a: dict, b: dict, keys):
    for key in keys:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("name,sampler", [("replica", False), ("replica_water", True)])
def test_mesh_run_is_the_no_mesh_run(runs, name, sampler):
    ref = ranks.replica_runs(lambda m: water_runner(sampler, m), None)
    keys = [k for k in ref if k != "checkpoint"]
    for r in range(4):
        _assert_equal(ranks.load(runs, name, r), ref, keys)
    assert any(ref[f"accepted_by_pair_{i}"].sum() > 0 for i in range(3))  # swaps were accepted
    box0 = np.eye(3) * 2.0
    assert any(not np.array_equal(ref[f"boxes_by_state_{i}"][0], box0) for i in range(3))  # the barostat moved a box
    if sampler:
        assert ref["water_proposed"].tolist() == [30] * 4 and ref["water_accepted"].sum() > 0


def test_checkpoint_on_four_ranks_resumes_on_one(runs):
    four = ranks.load(runs, "replica", 0)
    state = pickle.loads(four["checkpoint"].tobytes())
    assert state["xs"].shape[0] == 4 and state["mover_leaves"][0].shape == (4,)  # the no-mesh form
    runner, _ = water_runner(False)
    runner.load_state_dict(state)
    res = runner.advance_frame(5)
    for f in ("frames_by_state", "boxes_by_state", "replica_idx_by_state", "accepted_by_pair", "proposed_by_pair", "U_kl"):
        np.testing.assert_array_equal(getattr(res, f), four[f"{f}_2"], err_msg=f)
    x, v, b = runner.final_state_arrays()
    _assert_equal(dict(final_x=x, final_v=v, final_box=b), four, ("final_x", "final_v", "final_box"))


def test_run_sims_hrex_on_four_ranks_is_the_one_rank_run(runs):
    ref = sims_hrex_arrays(harmonic_states())
    for r in range(4):
        _assert_equal(ranks.load(runs, "sims_hrex", r), ref, ref.keys())
    assert np.all(np.isfinite(ref["dGs"])) and len(ref["dGs"]) == 3
