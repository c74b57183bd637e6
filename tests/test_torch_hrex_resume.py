"""HREX checkpoint and resume: ReplicaExchangeRunner.state_dict and
load_state_dict of the port (timemachine_torch/parallel/replica_exchange.py)
against the JAX runner's contract (tests/test_free_energy.py::
test_replica_exchange_checkpoint_resume_bitwise).

The port's random streams are generators' carried states (ROADMAP P15,
P37), so a checkpoint carries them: a run resumed from a pickled
state_dict() is bitwise the uninterrupted one (tolerance 0) in its frames,
boxes, permutations, accepted and proposed counts, U_kl, the water
sampler's counters and every mover state's field. Cases: JAX's three
harmonic states (2 + 2 iterations of 5 steps, seed 13); a water box whose
barostat fires on both sides of the split; the same with the TIBD water
sampler, which fires before the split and after it. The pickled dict holds
no torch object, holds every key of JAX's, and a checkpoint recorded on
another device type raises.
"""

import pickle

import numpy as np
import pytest
import torch

from timemachine_torch import potentials as tp
from timemachine_torch.fe import free_energy as tfe
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.context import Context
from timemachine_torch.md.exchange.exchange_mover import random_rotation_matrix
from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove
from timemachine_torch.md.hrex import get_swap_attempts_per_iter_heuristic
from timemachine_torch.parallel.replica_exchange import ReplicaExchangeRunner

torch.set_num_threads(1)  # the suite's workers share the host's cores

TEMP = 300.0
CPU = torch.device("cpu")
N_WATERS, BOX_NM = 18, 2.0


def _harmonic_state(lamb):
    """JAX's tests/test_free_energy.py make_harmonic_state on the port."""
    x0 = np.array([[0.0, 0, 0], [0.12, 0, 0]])
    bond = tp.HarmonicBond(np.array([[0, 1]], dtype=np.int32), np.array([[20000.0 * (1.0 + lamb), 0.11]]), 2, device=CPU)
    intg = LangevinIntegrator(TEMP, 1.5e-3, 1.0, np.array([12.0, 12.0]), seed=5)
    return tfe.InitialState([bond], intg, None, x0, np.zeros_like(x0), np.eye(3) * 10.0, lamb,
                            np.array([0], dtype=np.int32), np.array([], dtype=np.int32))


def _harmonic_runner():
    states = [_harmonic_state(lamb) for lamb in (0.0, 0.5, 1.0)]
    runner = ReplicaExchangeRunner(
        tfe.get_context(states[0]), [[p.params for p in s.potentials] for s in states], temperature=TEMP,
        neighbor_pairs=[(0, 1), (1, 2)], n_swap_attempts_per_iter=get_swap_attempts_per_iter_heuristic(3),
        max_delta_states=2, seed=13,
    )
    start = ([s.x0 for s in states], [s.v0 for s in states], [s.box0 for s in states])
    return runner, start


def _water_box(seed):
    """Rigid waters at random places (tests/test_exchange.py's box), with charged water parameters."""
    rng = np.random.default_rng(seed)
    template = np.array([[0.0, 0, 0], [0.09572, 0, 0], [-0.024, 0.0927, 0]])
    conf = np.concatenate([template @ random_rotation_matrix(rng).T + rng.uniform(0, BOX_NM, 3) for _ in range(N_WATERS)])
    params = np.zeros((3 * N_WATERS, 4))
    q = np.sqrt(138.935456)
    params[0::3, 0], params[1::3, 0], params[2::3, 0] = -0.834 * q, 0.417 * q, 0.417 * q
    params[0::3, 1], params[0::3, 2] = 0.315 / 2, np.sqrt(0.635)
    return conf, params


def _water_runner(with_sampler: bool):
    """Three replicas of the water box: bonds and angles (no pair term), a
    barostat every 3 steps and, optionally, the TIBD sampler every 10 steps
    around the first water, its parameters per state."""
    confs = [_water_box(s) for s in (31, 32, 33)]
    n = 3 * N_WATERS
    waters = np.arange(n).reshape(N_WATERS, 3)
    bonds = np.concatenate([waters[:, [0, 1]], waters[:, [0, 2]]])
    bond = tp.HarmonicBond(bonds, np.tile([4e5, 0.09572], (len(bonds), 1)), n, device=CPU)
    angle = tp.HarmonicAngle(waters[:, [1, 0, 2]], np.tile([400.0, 1.8242, 0.0], (N_WATERS, 1)), n, device=CPU)
    masses = np.tile([16.0, 2.0, 2.0], N_WATERS)
    movers = [MonteCarloBarostat(n, 1.013, TEMP, list(waters), interval=3, seed=2024)]
    params = confs[0][1]
    water_params = None
    if with_sampler:
        movers.append(TIBDExchangeMove(n, np.arange(3), waters[1:], params, TEMP, 2.0, 1.2, 0.7, seed=22,
                                       n_proposals=30, interval=10))
        water_params = [np.where(np.arange(n)[:, None] < 3, params * (1.0 - 0.4 * k), params) for k in range(3)]
    ctx = Context(confs[0][0], np.zeros((n, 3)), np.eye(3) * BOX_NM, LangevinIntegrator(TEMP, 1.5e-3, 1.0, masses, seed=7),
                  [bond, angle], movers, device=CPU)
    runner = ReplicaExchangeRunner(
        ctx, [[bond.params * (1.0 + 0.1 * k), angle.params] for k in range(3)], temperature=TEMP,
        neighbor_pairs=[(0, 1), (1, 2)], n_swap_attempts_per_iter=27, max_delta_states=2, seed=13,
        water_params_by_state=water_params,
    )
    start = ([c for c, _ in confs], [np.zeros((n, 3))] * 3, [np.eye(3) * BOX_NM] * 3)
    return runner, start


def _split_and_resume(make, n_eq=0, n_steps=5):
    """(results straight, results resumed, final state dicts, pickled checkpoint): 2 + 2 iterations, split after 2."""
    straight, start = make()
    straight.initialize(*start)
    straight.equilibrate(n_eq)
    for _ in range(2):
        straight.advance_frame(n_steps)
    blob = pickle.dumps(straight.state_dict())
    res_a = [straight.advance_frame(n_steps) for _ in range(2)]

    resumed, _ = make()
    resumed.load_state_dict(pickle.loads(blob))
    res_b = [resumed.advance_frame(n_steps) for _ in range(2)]
    return res_a, res_b, (straight, resumed), blob


def _assert_bitwise(res_a, res_b, runners):
    for a, b in zip(res_a, res_b):
        for field in ("frames_by_state", "boxes_by_state", "replica_idx_by_state", "accepted_by_pair",
                      "proposed_by_pair", "U_kl"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    end_a, end_b = (r.state_dict() for r in runners)
    assert end_a.keys() == end_b.keys()
    for key in end_a:
        if key == "mover_leaves":
            assert len(end_a[key]) == len(end_b[key])
            for la, lb in zip(end_a[key], end_b[key]):
                np.testing.assert_array_equal(la, lb)
        else:
            np.testing.assert_array_equal(end_a[key], end_b[key], err_msg=key)


def test_resume_is_bitwise_on_jax_harmonic_states():
    res_a, res_b, runners, _ = _split_and_resume(_harmonic_runner)
    _assert_bitwise(res_a, res_b, runners)
    assert runners[1].iteration == 4 and runners[1].t == 20
    assert any(int(r.accepted_by_pair.sum()) > 0 for r in res_a)


def test_resume_is_bitwise_with_the_barostat_firing_across_the_split():
    res_a, res_b, runners, blob = _split_and_resume(lambda: _water_runner(False), n_eq=4)
    _assert_bitwise(res_a, res_b, runners)
    baro = runners[1].batch.get_mover_states()[0]
    # none in the 4 equilibration steps (interval 15 there), then every 3 steps: 3 before the split, 4 after it
    assert [int((t + 1) % 3 == 0) for t in range(4, 24)].count(1) == 7 == int(baro.total_attempted[0])
    before = pickle.loads(blob)
    assert not np.array_equal(before["boxes"], runners[1].batch.get_box())  # the box moved after the split


def test_resume_is_bitwise_with_the_water_sampler_firing_after_the_split():
    res_a, res_b, runners, blob = _split_and_resume(lambda: _water_runner(True))
    _assert_bitwise(res_a, res_b, runners)
    acc_a, prop_a = runners[0].water_counters_by_replica()
    acc_b, prop_b = runners[1].water_counters_by_replica()
    np.testing.assert_array_equal(acc_a, acc_b)
    np.testing.assert_array_equal(prop_a, prop_b)
    assert prop_b.tolist() == [60, 60, 60]  # firings at t = 9 (before the split) and 19 (after it)
    assert int(acc_b.sum()) > 0
    ckpt_prop = pickle.loads(blob)["mover_leaves"][6 + 1]  # the sampler's n_proposed, after the barostat's 6 fields
    assert ckpt_prop.tolist() == [30, 30, 30]
    # the sampler's parameters went in as they were: state k's ligand charges scaled by 1 - 0.4 k
    params_b = runners[1].batch.get_mover_states()[1].params.numpy()
    perm = res_b[-1].replica_idx_by_state  # the permutation of the last segment, whose start set the parameters
    for k in range(3):
        np.testing.assert_array_equal(params_b[perm[k], :3, 0], runners[1]._water_params[k, :3, 0].numpy())


def test_checkpoint_pickles_without_torch_and_has_jax_keys():
    from timemachine_tpu.fe import free_energy as jfe
    from timemachine_tpu.integrators import LangevinIntegrator as JL
    from timemachine_tpu.parallel.replica_exchange import ReplicaExchangeRunner as JRunner
    from timemachine_tpu.potentials import BoundPotential, HarmonicBond

    runner, start = _water_runner(True)
    runner.initialize(*start)
    runner.advance_frame(10)
    state = runner.state_dict()
    blob = pickle.dumps(state)
    assert b"torch" not in blob
    assert all(isinstance(v, (np.ndarray, int, str, list)) for v in state.values())
    assert all(isinstance(leaf, np.ndarray) for leaf in state["mover_leaves"])
    assert state["device_type"] == "cpu" and state["step"] == state["t"] == 10

    x0 = np.array([[0.0, 0, 0], [0.12, 0, 0]])
    j_states = [
        jfe.InitialState([BoundPotential(HarmonicBond(np.array([[0, 1]], dtype=np.int32)), np.array([[2e4 * (1 + lamb), 0.11]]))],
                         JL(TEMP, 1.5e-3, 1.0, np.array([12.0, 12.0]), 5), None, x0, np.zeros_like(x0), np.eye(3) * 10.0,
                         lamb, np.array([0], dtype=np.int32), np.array([], dtype=np.int32))
        for lamb in (0.0, 1.0)
    ]
    j_runner = JRunner(jfe.get_context(j_states[0]), [[np.asarray(bp.params) for bp in s.potentials] for s in j_states],
                       temperature=TEMP, neighbor_pairs=[(0, 1)], n_swap_attempts_per_iter=8, max_delta_states=1, seed=13)
    j_runner.initialize([s.x0 for s in j_states], [s.v0 for s in j_states], [s.box0 for s in j_states])
    assert set(j_runner.state_dict()) <= set(state)


def test_checkpoint_of_another_device_type_raises():
    runner, start = _harmonic_runner()
    runner.initialize(*start)
    runner.advance_frame(5)
    state = runner.state_dict()
    state["device_type"] = "cuda"
    fresh, _ = _harmonic_runner()
    with pytest.raises(ValueError, match="cannot resume"):
        fresh.load_state_dict(state)


def test_mismatched_movers_raise():
    runner, start = _water_runner(True)
    runner.initialize(*start)
    state = runner.state_dict()
    other, _ = _water_runner(False)
    with pytest.raises(ValueError, match="mover states"):
        other.load_state_dict(state)
