"""The port's water exchange movers (timemachine_torch/md/exchange/) against
timemachine_tpu's, on tests/test_exchange.py's random water boxes.

Both packages run in float64 on the CPU. The interaction block is held to
BLOCK_TOL, the full and incremental weights to WEIGHT_TOL. The two numpy
prototypes draw their proposals from default_rng(seed) in the same order,
so from one seed they choose the same waters and sites, bitwise; their
log acceptance agrees to WEIGHT_TOL. The Context mover draws from a
torch.Generator where JAX folds keys (ROADMAP P28), so it is held to JAX's
function given JAX's draws: JAX's traced proposals (chosen, direction,
site, rotation, log uniform) replayed through the port's proposal step give
JAX's raw log acceptance (WEIGHT_TOL), every decision, the count accepted
and the final coordinates (X_TOL nm). Its own draws are held to the ideal
gas's sphere occupancy, as JAX's test holds JAX's; the batched mover at
K = 3 to three single movers fed the same draws; a rerun to the first,
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.constants import BOLTZ
from timemachine_torch.md.exchange import exchange_mover as tem
from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove
from timemachine_torch.md.states import CoordsVelBox
from timemachine_torch.ops import nonbonded as tnb
from timemachine_tpu.md.exchange import exchange_mover as jem
from timemachine_tpu.md.exchange.targeted_insertion import TIBDExchangeMove as JTIBD
from timemachine_tpu.md.states import CoordsVelBox as JCVB
from timemachine_tpu.ops import nonbonded as jnb

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF, TEMP = 2.0, 1.2, 300.0
KT = BOLTZ * TEMP
BLOCK_TOL = 1e-12  # of the block's largest |value|
WEIGHT_TOL = 1e-10  # kT
X_TOL = 1e-10  # nm
CPU = torch.device("cpu")


def make_water_box(n_waters: int, box_width: float, seed: int, charged=True):
    """Rigid TIP3P-ish waters at random placements (tests/test_exchange.py's)."""
    rng = np.random.default_rng(seed)
    water_template = np.array([[0.0, 0, 0], [0.09572, 0, 0], [-0.024, 0.0927, 0]])
    coords = []
    for _ in range(n_waters):
        loc = rng.uniform(0, box_width, 3)
        rot = jem.random_rotation_matrix(rng)
        coords.append(water_template @ rot.T + loc)
    conf = np.concatenate(coords)
    n = 3 * n_waters
    params = np.zeros((n, 4))
    if charged:
        q = np.sqrt(138.935456)
        params[0::3, 0] = -0.834 * q
        params[1::3, 0] = 0.417 * q
        params[2::3, 0] = 0.417 * q
        params[0::3, 1] = 0.315 / 2
        params[0::3, 2] = np.sqrt(0.635)
    water_idxs = np.arange(n).reshape(n_waters, 3)
    box = np.eye(3) * box_width
    return conf, params, water_idxs, box


def _t(a):
    return torch.as_tensor(np.array(a), device=CPU)


def test_nonbonded_block_matches_jax():
    conf, params, _, box = make_water_box(24, 2.0, seed=0)
    params[:, 3] = np.random.default_rng(1).uniform(0.0, 0.3, len(params))  # w offsets
    a, b = np.arange(0, 30), np.arange(30, 72)
    ref = np.asarray(jnb.nonbonded_block_unsummed(conf[a], conf[b], box, params[a], params[b], BETA, CUTOFF))
    got = tnb.nonbonded_block_unsummed(_t(conf[a]), _t(conf[b]), _t(box), _t(params[a]), _t(params[b]), BETA, CUTOFF)
    assert got.shape == ref.shape and np.count_nonzero(ref) > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BLOCK_TOL * np.abs(ref).max())
    total = float(tnb.nonbonded_block(_t(conf[a]), _t(conf[b]), _t(box), _t(params[a]), _t(params[b]), BETA, CUTOFF))
    assert abs(total - float(jnb.nonbonded_block(conf[a], conf[b], box, params[a], params[b], BETA, CUTOFF))) <= (
        BLOCK_TOL * np.abs(ref).sum())


def test_weights_full_and_incremental_match_jax():
    conf, params, water_idxs, box = make_water_box(20, 2.0, seed=1)
    j_full, j_inc = jem.make_weight_fns(params, water_idxs, BETA, CUTOFF, KT)
    t_full, t_inc = tem.make_weight_fns(params, water_idxs, BETA, CUTOFF, KT, weight_chunk=7, device=CPU)
    w_j, w_t = np.asarray(j_full(conf, box)), t_full(conf, box).numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=WEIGHT_TOL)
    rng = np.random.default_rng(2)
    for _ in range(5):
        chosen = int(rng.integers(0, 20))
        new_pos = jem.randomly_rotate_and_translate(conf[water_idxs[chosen]], rng.uniform(0, 2.0, 3), rng)
        after_j, x_j = j_inc(conf, box, chosen, new_pos, w_j)
        after_t, x_t = t_inc(conf, box, chosen, new_pos, w_j)
        np.testing.assert_allclose(after_t.numpy(), np.asarray(after_j), rtol=0, atol=WEIGHT_TOL)
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
        conf, w_j = np.asarray(x_j), np.asarray(j_full(np.asarray(x_j), box))


@pytest.mark.parametrize("kind", ["bd", "tibd"])
def test_prototypes_propose_as_jax_from_one_seed(kind):
    """50 proposals from seed 4 in both packages, each accepted or not by
    one shared uniform: the same trial coordinates (chosen water, site,
    rotation) bitwise, the log acceptance within WEIGHT_TOL (of its size
    where a clash makes it large)."""
    conf, params, water_idxs, box = make_water_box(18, 2.0, seed=3)
    if kind == "bd":
        j_mover = jem.BDExchangeMove(BETA, CUTOFF, params, water_idxs, TEMP, seed=4)
        t_mover = tem.BDExchangeMove(BETA, CUTOFF, params, water_idxs, TEMP, seed=4, device=CPU)
    else:
        lig, waters = water_idxs[0], water_idxs[1:]
        j_mover = jem.TIBDExchangeMove(BETA, CUTOFF, params, waters, TEMP, lig, radius=0.7, seed=4)
        t_mover = tem.TIBDExchangeMove(BETA, CUTOFF, params, waters, TEMP, lig, radius=0.7, seed=4, device=CPU)
    shared = np.random.default_rng(5)
    x_j = JCVB(conf, np.zeros_like(conf), box)
    x_t = CoordsVelBox(conf, np.zeros_like(conf), box)
    n_accepted = 0
    for _ in range(50):
        trial_j, log_p_j = j_mover.propose(x_j)
        trial_t, log_p_t = t_mover.propose(x_t)
        np.testing.assert_array_equal(trial_t.coords, np.asarray(trial_j.coords))
        assert abs(float(log_p_t) - float(log_p_j)) <= WEIGHT_TOL * max(1.0, abs(float(log_p_j)))
        if np.log(shared.random()) < float(log_p_j):
            x_j, x_t, n_accepted = trial_j, trial_t, n_accepted + 1
    assert 0 < n_accepted < 50


def _mover(conf, params, water_idxs, ligand_idxs, radius, seed, n_proposals, **kw):
    return dict(n_atoms=conf.shape[0], ligand_idxs=ligand_idxs, water_idxs=water_idxs, params=params, temperature=TEMP,
                beta=BETA, cutoff=CUTOFF, radius=radius, seed=seed, n_proposals=n_proposals, interval=400, **kw)


def test_context_mover_replays_jax_trace():
    """JAX's scan mover's traced firing (tests/test_exchange.py's system),
    its proposals fed to the port's proposal step move for move."""
    n_prop = 80
    conf, params, water_idxs, box = make_water_box(18, 2.0, seed=21)
    lig = np.array([0, 1, 2])
    kw = _mover(conf, params, water_idxs[1:], lig, 0.7, 22, n_prop)
    j_mover = JTIBD(**kw)
    j_state, x_fin, _, _, recs = j_mover.move_traced(
        j_mover.init_state(), jnp.asarray(conf), jnp.zeros_like(conf), jnp.asarray(box), jax.random.key(23)
    )
    recs = {k: np.asarray(v) for k, v in recs.items()}
    firing = TIBDExchangeMove(**kw).make_move_fn(None, CPU).firing
    feed = {k: _t(recs[k])[:, None] for k in ("chosen", "i2o", "site", "rot", "log_u")}
    x, raw, accept, n1, _ = firing.replay(_t(params)[None], _t(conf)[None], _t(box)[None], feed)
    np.testing.assert_array_equal(n1[:, 0].numpy(), recs["n1"])
    np.testing.assert_allclose(raw[:, 0].numpy(), recs["raw_log_p"], rtol=0, atol=WEIGHT_TOL)
    np.testing.assert_array_equal(accept[:, 0].numpy(), recs["accept"])
    assert int(accept.sum()) == int(j_state.n_accepted) > 0
    np.testing.assert_allclose(x[0].numpy(), np.asarray(x_fin), rtol=0, atol=X_TOL)


def _fire(mover, x, box, state=None, dtype=torch.float64):
    move = mover.make_move_fn(None, CPU)
    state = mover.init_state(CPU, dtype) if state is None else state
    return move(state, _t(x), torch.zeros_like(_t(x)), _t(box))


def test_context_mover_ideal_gas_occupancy():
    """tests/test_exchange.py::test_scan_mover_ideal_gas_occupancy on the
    port's own draws: with every interaction off the sphere holds W
    vol_sphere / vol_box waters on average."""
    n_waters, box_width, radius = 30, 2.2, 0.7
    conf, params, water_idxs, box = make_water_box(n_waters, box_width, seed=13, charged=False)
    lig = np.array([0, 1, 2])
    mover = TIBDExchangeMove(**_mover(conf, params, water_idxs[1:], lig, radius, 14, 200))
    move = mover.make_move_fn(None, CPU)
    state, x = mover.init_state(CPU, torch.float64), _t(conf)
    counts = []
    for i in range(12):
        state, x, _, _ = move(state, x, torch.zeros_like(x), _t(box))
        if i >= 2:
            inner, _ = jem.get_water_groups(x.numpy(), box, x.numpy()[lig].mean(0), water_idxs[1:], radius)
            counts.append(len(inner))
    expected = (n_waters - 1) * (4 / 3 * np.pi * radius**3) / box_width**3
    assert np.mean(counts) == pytest.approx(expected, abs=2.5), (np.mean(counts), expected)
    assert int(state.n_proposed) == 12 * 200 and 0 < int(state.n_accepted) <= 12 * 200


def test_context_mover_state_params_swap():
    """The same mover and draws under the state's parameters and under all
    zeros: other coordinates, and more moves accepted without interactions."""
    conf, params, water_idxs, box = make_water_box(24, 1.6, seed=5)
    mover = TIBDExchangeMove(**_mover(conf, params, water_idxs[1:], water_idxs[0], 0.5, 3, 50))
    state_a = mover.init_state(CPU, torch.float64)
    state_b = mover.init_state(CPU, torch.float64)
    state_b.params = torch.zeros_like(state_b.params)
    sa, xa, _, _ = _fire(mover, conf, box, state_a)
    sb, xb, _, _ = _fire(mover, conf, box, state_b)
    assert not torch.allclose(xa, xb)
    assert int(sb.n_accepted) > int(sa.n_accepted)


def test_batched_mover_equals_single_movers():
    """K = 3 systems in one firing against three single firings fed each
    system's slice of the same draws."""
    boxes = [make_water_box(18, 2.0, seed=s) for s in (31, 32, 33)]
    conf0, params, water_idxs, box = boxes[0]
    mover = TIBDExchangeMove(**_mover(conf0, params, water_idxs[1:], np.array([0, 1, 2]), 0.7, 9, 60))
    move = mover.make_move_fn(None, CPU)
    xs = torch.stack([_t(b[0]) for b in boxes])
    bx = _t(box)[None].expand(3, 3, 3)
    state = mover.init_state(CPU, torch.float64, shape=(3,))
    uniforms, normals = mover.draw(state.generator, 3, CPU)
    sk, xk, _, _, tk = move.with_draws(state, xs, torch.zeros_like(xs), bx, uniforms, normals, with_trace=True)
    for k in range(3):
        s1, x1, _, _, t1 = move.with_draws(
            mover.init_state(CPU, torch.float64), xs[k], torch.zeros_like(xs[k]), _t(box),
            uniforms[:, k : k + 1], normals[:, k : k + 1], with_trace=True,
        )
        for key in ("chosen", "i2o", "accept", "n1"):
            assert torch.equal(t1[key][:, 0], tk[key][:, k]), key
        torch.testing.assert_close(x1, xk[k], rtol=0, atol=1e-12)
        assert int(s1.n_accepted) == int(sk.n_accepted[k]) and int(sk.n_proposed[k]) == 60
    assert int(sk.n_accepted.sum()) > 0


def test_context_mover_is_bitwise_on_repeat_and_rigid():
    """Two firings from one seed are bitwise equal; the waters stay rigid,
    the ligand and the box untouched."""
    conf, params, water_idxs, box = make_water_box(18, 2.0, seed=10)
    lig = np.array([0, 1, 2])
    mover = TIBDExchangeMove(**_mover(conf, params, water_idxs[1:], lig, 0.7, 11, 50))
    s1, x1, _, b1 = _fire(mover, conf, box)
    s2, x2, _, _ = _fire(mover, conf, box)
    assert torch.equal(x1, x2) and int(s1.n_accepted) == int(s2.n_accepted)
    assert int(s1.n_proposed) == 50 and 0 < int(s1.n_accepted) <= 50
    x1 = x1.numpy()
    for a, b in ((0, 1), (0, 2), (1, 2)):
        d_ref = np.linalg.norm(conf[water_idxs][:, a] - conf[water_idxs][:, b], axis=-1)
        d_new = np.linalg.norm(x1[water_idxs][:, a] - x1[water_idxs][:, b], axis=-1)
        np.testing.assert_allclose(d_new, d_ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(x1[lig], conf[lig])
    np.testing.assert_array_equal(b1.numpy(), box)
