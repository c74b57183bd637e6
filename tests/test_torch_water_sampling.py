"""Water sampling through the port's drivers (timemachine_torch/fe/free_energy.py
get_context, run_sims_hrex, the Context's list rebuild) on the probe-in-water
system of the JAX package's examples/water_sampling_hrex.py, at its test's
size (tests/test_examples.py::test_water_sampling_hrex: a 2.6 nm box, 2
windows, 3 frames of 10 steps, the sampler every 10 steps with 20 proposals).

Both packages get the probe (adamantane) at the JAX package's embedding and
each its own water box of the same seed. get_context with
WaterSamplingParams builds JAX's mover: the same waters, parameters (to
PARAM_TOL of each column's largest |value|), seed, radius, interval and
proposal count. The port's states run in float64 on the CPU, their host's
FIRE cut to FIRE_STEPS in one window (JAX's are left unminimized: only its
mover is read; every FIRE step is a dense float64 force on one CPU thread). A
Context whose host term runs the rowscan sweep's plain version (one window
in a WIDE_BOX nm box: at BOX its lists hold every pair) rebuilds its lists
after the sampler fires: the next force through them
equals a fresh build's at the same x (FORCE_TOL), where the lists from
before the firing, after an accepted teleport, miss it by more than the
card's 1e-5 of the all-pairs norm (the control). run_sims_hrex, batched
and time-multiplexed, returns WaterSamplingDiagnostics of JAX's shape, its
proposal counts n_proposals times the firings of each state's segments, as
JAX's drivers record them (the batched driver without equilibration, the
time-multiplexed one with it). JAX's driver is not run: its compile alone
would take the file's budget.
"""

import copy
import warnings
from dataclasses import replace

import numpy as np
import pytest
import torch

from timemachine_torch.chem import mol_from_smiles as t_mol_from_smiles
from timemachine_torch.fe import absolute_hydration as tah
from timemachine_torch.fe import free_energy as tfe
from timemachine_torch.fe.topology import BaseTopology as TBT
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.md import builders as tb
from timemachine_torch.md import minimizer as tmin
from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove
from timemachine_torch.parallel.replica_exchange import ReplicaExchangeRunner
from timemachine_torch.potentials import NonbondedAllPairs
from timemachine_torch.testsystems.water_sampling import (
    DEFAULT_BB_RADIUS, PROBE_SMILES, build_probe_in_water, compute_density, compute_occupancy,
)

torch.set_num_threads(1)  # the suite's workers share the host's cores

BOX, WIDE_BOX, SEED, N_WINDOWS = 2.6, 4.0, 2026, 2
WSP = tfe.WaterSamplingParams(interval=10, n_proposals=20, batch_size=20, radius=0.92)
# 4 equilibration steps and 3 local steps a frame put one firing in every replica's segment of both
# drivers (the time-multiplexed driver's segments share one step counter)
N_EQ, N_FRAMES, STEPS_PER_FRAME, LOCAL_STEPS = 4, 3, 10, 3
FIRE_STEPS = 60  # the host's FIRE at λ 0.1 only: enough for a stable start at BOX
PARAM_TOL = 1e-12
FORCE_TOL = 1e-12  # of the fresh build's force norm
CONTROL_MISS = 1e-5  # of the all-pairs force norm: the card's limit, which stale lists must exceed
CPU = torch.device("cpu")


def _md(**kw):
    kw = {"water_sampling_params": WSP, **kw}
    return tfe.MDParams(n_frames=N_FRAMES, n_eq_steps=N_EQ, steps_per_frame=STEPS_PER_FRAME, seed=SEED,
                        hrex_params=tfe.HREXParams(), **kw)


@pytest.fixture(scope="module")
def probe():
    """Both packages' probe at JAX's embedding, force field and water box."""
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.chem.embed import embed_mol as j_embed_mol
    from timemachine_tpu.ff import Forcefield as JF
    from timemachine_tpu.md.builders import build_water_system

    j_mol = j_mol_from_smiles(PROBE_SMILES, add_hs=True, name="probe")
    j_embed_mol(j_mol, seed=SEED)
    t_mol = t_mol_from_smiles(PROBE_SMILES, add_hs=True, name="probe")
    t_mol.set_conf(np.asarray(j_mol.get_conf()))
    jff, tff = JF.load_default(), TF.load_default()
    return dict(j_mol=j_mol, t_mol=t_mol, jff=jff, tff=tff, j_host=build_water_system(BOX, mols=[j_mol]),
                t_host=tb.build_water_system(BOX, mols=[t_mol]))


@pytest.fixture(scope="module")
def states(probe):
    """The decoupling ladder linspace(1, 0, N_WINDOWS) in both packages:
    the port's host FIRE-minimized (FIRE_STEPS, one window), JAX's not."""
    from timemachine_tpu.fe import absolute_hydration as jah
    from timemachine_tpu.fe.free_energy import AbsoluteFreeEnergy as JAFE
    from timemachine_tpu.fe.topology import BaseTopology as JBT
    from timemachine_tpu.md import minimizer as jmin

    schedule = np.linspace(1.0, 0.0, N_WINDOWS)
    j_afe = JAFE(probe["j_mol"], JBT(probe["j_mol"], probe["jff"]))
    t_afe = tfe.AbsoluteFreeEnergy(probe["t_mol"], TBT(probe["t_mol"], probe["tff"]))
    t_fire = tmin.fire_minimize_host
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmin, "fire_minimize_host", lambda mols, host_config, *a, **k: np.asarray(host_config.conf))
        mp.setattr(tmin, "fire_minimize_host", lambda *a, **k: t_fire(*a, n_steps_per_window=FIRE_STEPS, n_windows=1, **k))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            j_states = jah.setup_initial_states(j_afe, probe["jff"], probe["j_host"], 300.0, schedule, SEED)
        t_states = tah.setup_initial_states(t_afe, probe["tff"], probe["t_host"], 300.0, schedule, SEED, device=CPU)
    return j_states, t_states


def test_probe_system_is_the_examples(probe, monkeypatch):
    """The port's build_probe_in_water makes the examples' system (the
    embedding stubbed with JAX's conformer: the port's own takes about half
    a minute on the CPU), and its observables are the examples' helpers'."""
    import sys
    from pathlib import Path

    from timemachine_torch.chem import embed as tembed

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
    try:
        import water_sampling_common as wsc
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(tembed, "embed_mol", lambda mol, seed: mol.set_conf(np.asarray(probe["j_mol"].get_conf())))
    mol, host = build_probe_in_water(box_width=BOX, seed=SEED)
    assert mol.num_atoms == 26 and host.num_water_atoms == host.conf.shape[0]
    np.testing.assert_array_equal(host.conf, np.asarray(probe["j_host"].conf))
    np.testing.assert_array_equal(host.box, np.asarray(probe["j_host"].box))
    x = np.concatenate([host.conf, mol.get_conf()])
    lig = np.arange(host.conf.shape[0], x.shape[0])
    for r in (0.25, 0.46, 0.92):
        assert compute_occupancy(x, host.box, lig, r) == wsc.compute_occupancy(x, host.box, lig, r)
    assert compute_density(host.conf.shape[0] // 3, host.box) == wsc.compute_density(host.conf.shape[0] // 3, host.box)
    assert DEFAULT_BB_RADIUS == wsc.DEFAULT_BB_RADIUS


def test_get_context_builds_jax_mover(states):
    from timemachine_tpu.fe import free_energy as jfe

    j_states, t_states = states
    md_j = jfe.MDParams(n_frames=1, n_eq_steps=0, steps_per_frame=1, seed=SEED, water_sampling_params=jfe.WaterSamplingParams(
        interval=WSP.interval, n_proposals=WSP.n_proposals, batch_size=WSP.batch_size, radius=WSP.radius))
    for js, ts in zip(j_states, t_states):
        jm = jfe.get_context(js, md_j).movers[-1]
        ctx = tfe.get_context(ts, _md())
        tm = ctx.movers[-1]
        assert [type(m).__name__ for m in ctx.movers] == ["MonteCarloBarostat", "TIBDExchangeMove"]
        assert isinstance(tm, TIBDExchangeMove) and tm.moves_atoms_nonlocally
        np.testing.assert_array_equal(tm.water_idxs, np.asarray(jm.water_idxs))
        np.testing.assert_array_equal(tm.ligand_idxs, np.asarray(jm.ligand_idxs))
        scale = np.maximum(np.abs(np.asarray(jm.params)).max(0), 1e-300)
        assert (np.abs(tm.params - np.asarray(jm.params)) / scale).max() <= PARAM_TOL
        for field in ("n_atoms", "seed", "radius", "interval", "n_proposals", "batch_size", "beta", "cutoff", "temperature"):
            assert getattr(tm, field) == getattr(jm, field), field
        assert len(tm.water_idxs) == ts.x0[: -len(ts.ligand_idxs)].shape[0] // 3


def _spy_on_firings(ctx, k):
    """Wrap mover k's move: record the lists before each firing and the moves accepted."""
    seen = {"stale": None, "accepted": 0}
    move = ctx._move_fns[k]

    def spy(state, x, v, box):
        seen["stale"] = ctx._prov_states
        out = move(state, x, v, box)
        seen["accepted"] += int(out[0].n_accepted) - int(state.n_accepted)
        return out

    ctx._move_fns[k] = spy
    return seen


@pytest.fixture(scope="module")
def wide_state(probe):
    """One window (λ 1) of the probe in a WIDE_BOX nm box, its host not
    minimized: wide enough that the rowscan lists leave pairs out."""
    t_afe = tfe.AbsoluteFreeEnergy(probe["t_mol"], TBT(probe["t_mol"], probe["tff"]))
    host = tb.build_water_system(WIDE_BOX, mols=[probe["t_mol"]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmin, "fire_minimize_host", lambda mols, host_config, *a, **k: np.asarray(host_config.conf))
        return tah.setup_initial_states(t_afe, probe["tff"], host, 300.0, [1.0], SEED, device=CPU)[0]


def test_context_rebuilds_lists_after_a_firing(wide_state):
    """The host term on the rowscan sweep (its plain version here), the
    sampler firing after the first step: the Context's lists are then a
    fresh build's at the moved coordinates, and the lists from before the
    firing miss the force."""
    state = replace(wide_state, potentials=[copy.deepcopy(p) for p in wide_state.potentials])
    host_i = next(i for i, p in enumerate(state.potentials) if isinstance(p, NonbondedAllPairs))
    x0, box0 = torch.as_tensor(state.x0), torch.as_tensor(state.box0)
    state.potentials[host_i].configure(box0, x0, kernel="rowscan")
    md = _md(water_sampling_params=replace(WSP, interval=1, n_proposals=200, batch_size=200))
    ctx = tfe.get_context(state, md)
    seen = _spy_on_firings(ctx, 1)
    ctx.multiple_steps(1)
    assert seen["accepted"] > 0  # a water was teleported, beyond any list's skin
    prov = ctx._providers[host_i]
    x, box = ctx._x, ctx._box
    with torch.no_grad():
        f_ctx = prov[1](ctx._prov_states[host_i], x, box, 1)[0]
        f_fresh = prov[1](prov[0](x, box), x, box, 1)[0]
        f_stale = prov[1](seen["stale"][host_i], x, box, 1)[0]
        f_ap = NonbondedAllPairs.energy_force(ctx.potentials[host_i], x, box)[1]
    norm = float(torch.linalg.vector_norm(f_fresh))
    assert float(torch.linalg.vector_norm(f_ctx - f_fresh)) <= FORCE_TOL * norm
    assert float(torch.linalg.vector_norm(f_stale - f_fresh)) > CONTROL_MISS * float(torch.linalg.vector_norm(f_ap))


def _expected_proposals(time_multiplexed: bool) -> np.ndarray:
    """(frames, states) proposals: n_proposals per firing, a firing after
    each global step t with (t + 1) % interval == 0 of a state's segment
    (the batched driver: every replica's frame; the time-multiplexed one:
    the segments in state order on one step counter, equilibration at frame
    0 and the frame's global steps, its local steps firing nothing)."""
    counts = np.zeros((N_FRAMES, N_WINDOWS), dtype=np.int64)
    t = N_EQ if not time_multiplexed else 0
    for f in range(N_FRAMES):
        for s in range(N_WINDOWS):
            if not time_multiplexed:
                start, n_global, n_all = t, STEPS_PER_FRAME, STEPS_PER_FRAME
            else:
                start = t
                n_global = (N_EQ if f == 0 else 0) + STEPS_PER_FRAME - LOCAL_STEPS
                n_all = n_global + LOCAL_STEPS
            counts[f, s] = WSP.n_proposals * sum((u + 1) % WSP.interval == 0 for u in range(start, start + n_global))
            if time_multiplexed:
                t += n_all
        if not time_multiplexed:
            t += STEPS_PER_FRAME
    return counts


@pytest.mark.parametrize("time_multiplexed", [False, True])
def test_run_sims_hrex_returns_water_diagnostics(states, time_multiplexed):
    md = _md(local_md_params=tfe.LocalMDParams(local_steps=LOCAL_STEPS) if time_multiplexed else None)
    res, trajs, diag, water = tfe.run_sims_hrex(states[1], md, print_diagnostics_interval=None)
    assert isinstance(water, tfe.WaterSamplingDiagnostics)
    counts = np.asarray(water.proposals_by_state_by_iter)
    assert counts.shape == (N_FRAMES, N_WINDOWS, 2)
    np.testing.assert_array_equal(counts[..., 1], _expected_proposals(time_multiplexed))
    assert np.all(counts[..., 0] >= 0) and np.all(counts[..., 0] <= counts[..., 1])
    np.testing.assert_array_equal(water.cumulative_proposals_by_state(), counts.sum(0))
    assert len(res.bar_results) == N_WINDOWS - 1 and all(len(t.frames) == N_FRAMES for t in trajs)
    assert np.all(np.isfinite(np.asarray(trajs[-1].frames)))


def test_runner_gives_each_replica_its_states_water_params(states):
    """At initialize and at every segment each replica's sampler holds the
    water parameters of the state it samples, swaps included."""
    t_states = states[1]
    ctx = tfe.get_context(t_states[0], _md())
    water_params = [tfe.get_water_sampler_params(s) for s in t_states]
    assert not np.array_equal(water_params[0], water_params[1])  # the ligand's rows differ along λ
    runner = ReplicaExchangeRunner(
        ctx, [[p.params for p in s.potentials] for s in t_states], temperature=300.0, neighbor_pairs=[(0, 0), (0, 1)],
        n_swap_attempts_per_iter=4, max_delta_states=None, seed=SEED, water_params_by_state=water_params,
    )
    runner.initialize([s.x0 for s in t_states], [s.v0 for s in t_states], [s.box0 for s in t_states])

    def mover_params():
        return runner.batch.get_mover_states()[1].params.numpy()

    np.testing.assert_array_equal(mover_params(), np.stack(water_params))
    runner.perm = np.array([1, 0])  # replica 1 samples state 0, replica 0 state 1
    runner.equilibrate(1)
    np.testing.assert_array_equal(mover_params(), np.stack(water_params[::-1]))
    assert runner.water_counters_by_replica()[1].tolist() == [0, 0]  # no firing in one step
