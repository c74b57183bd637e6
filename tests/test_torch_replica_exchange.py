"""The port's replica-parallel HREX (timemachine_torch/parallel/
replica_exchange.py, md/context.py BatchedContext, the batched rowscan
provider and fe/free_energy.py run_sims_hrex) against timemachine_tpu and
against the port's own single-system path.

The windows are tests/test_torch_rbfe.py's three small ethanol -> propane
windows (λ 0, 0.4, 1: K = 3) on the CPU, where the sweeps run their plain
PyTorch versions.

Tolerances (stated per test): the exact-function terms in f64 to 1e-10
relative; the host term to HOST_REL of its energy against JAX's dense exact
erfc on the CPU, which the port's dense form is (measured 1e-15 to 2.3e-15;
1.05e-3 at the windows' unrelaxed x0 while the port ran the rowscan
polynomial, ROADMAP P11); the batched path against K single-system runs of the port in f64
to 1e-12 relative (the same arithmetic; only the order of a few sums over
the interaction group's grid differs). The provider, batched-step, banded
and run_sims_hrex tests run the host term in both of FORMS: rowscan, the
card's HREX path (lists, vmapped polynomial exclusions, f64 banded
energies), and dense, the CPU's (configure_all_pairs' choice here).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_rbfe import EXACT_TERMS, FORMS, HOST, TEMP, as_form, small  # noqa: E402, F401  (small: the fixture)
from timemachine_torch.fe import free_energy as tfe  # noqa: E402
from timemachine_torch.md import hrex as th  # noqa: E402
from timemachine_torch.md.context import BatchedContext  # noqa: E402
from timemachine_torch.md.states import CoordsVelBox  # noqa: E402
from timemachine_torch.ops import rowscan_kernel as rs  # noqa: E402
from timemachine_torch.parallel.replica_exchange import ReplicaExchangeRunner  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores

F64 = torch.float64
BETA, CUTOFF = 2.0, 1.2
HOST_REL = 1e-10


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _params(states):
    return [torch.stack([s.potentials[i].params for s in states]) for i in range(len(states[0].potentials))]


def _runner(states, max_delta, perm=None, seed=1):
    """A runner over the states, replica r at states[r]'s x0, v0 and box0,
    with the permutation `perm` (state -> replica) applied."""
    k = len(states)
    runner = ReplicaExchangeRunner(
        tfe.get_context(states[0]), [[p.params for p in s.potentials] for s in states], temperature=TEMP,
        neighbor_pairs=[(i, i + 1) for i in range(k - 1)], n_swap_attempts_per_iter=k**3,
        max_delta_states=max_delta, seed=seed,
    )
    runner.initialize([s.x0 for s in states], [s.v0 for s in states], [s.box0 for s in states])
    if perm is not None:
        runner.perm = np.asarray(perm)
        runner.batch.set_params(runner._params_of_replicas())
    return runner


# -- the provider's energy under other parameters --------------------------------


@pytest.mark.parametrize("form", FORMS)
def test_fifth_provider_function_matches_u(small, form):
    """The host term's provider energy under another window's parameters
    against the term's u with those parameters, f64, to 1e-12 relative. In
    the rowscan form the lists are built with window 0's parameters, the
    rows re-gathered through the cached order, and the polynomial exclusion
    correction is included; the dense form recomputes every pair with its
    exclusion masks."""
    s0, s2 = as_form(small["port"][0], form), small["port"][2]
    nb = s0.potentials[HOST]
    x, box = _t(s0.x0), _t(s0.box0)
    init, _, energy, _, energy_with_params = nb.md_force_provider()
    state = init(x, box)
    for params in (s2.potentials[HOST].params, nb.params * torch.tensor([0.9, 1.0, 1.1, 1.0], dtype=F64)):
        u = float(energy_with_params(state, x, params, box))
        assert u == pytest.approx(float(nb.u(x, params, box)), rel=1e-12)
    assert float(energy_with_params(state, x, nb.params, box)) == pytest.approx(float(energy(state, x, box)), rel=1e-12)


def _fluid(n, box_side, seed):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, box_side, (n, 3))
    params = np.stack([rng.uniform(-0.5, 0.5, n) * 11.8, rng.uniform(0.05, 0.16, n), rng.uniform(0.2, 0.9, n),
                       rng.uniform(0.0, 0.1, n)], 1)
    return conf, params


def test_batched_sweep_plain_is_each_systems_sweep():
    """rowscan_sweep_batched on CPU tensors (its plain version) is
    rowscan_sweep_plain of each system in the masked form, F and U, with
    several systems reading one replica's lists (list_of_system)."""
    box = _t(np.eye(3) * 3.1)
    confs, params = zip(*[_fluid(700, 3.1, seed) for seed in (0, 1)])
    mask = torch.ones(700, dtype=torch.bool)
    mask[:9] = False
    series = rs.es_energy_force_series(BETA, CUTOFF)
    tiles = [rs.build_rowscan_tiles(_t(c), box, CUTOFF + 0.1, 4096, triangular=True, atom_mask=mask) for c in confs]
    lists_of = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32)
    prm = [_t(params[int(k)]) * (1.0 + 0.05 * b) for b, k in enumerate(lists_of)]
    atoms = torch.stack([
        rs.assemble_atoms(_t(confs[int(k)]), box, tiles[int(k)].pad_order,
                          rs.param_rows(prm[b], tiles[int(k)].pad_order, 700, mask))
        for b, k in enumerate(lists_of)
    ])
    stacked = [torch.stack([getattr(t, f) for t in tiles]) for f in ("row_start", "row_count", "col_ids")]
    scalars = rs.sweep_scalars(box, CUTOFF).expand(len(lists_of), 4).contiguous()
    for mode in (rs.FORCE, rs.ENERGY):
        out = rs.rowscan_sweep_batched(atoms, *stacked, lists_of, scalars, series, mode)
        for b, k in enumerate(lists_of.tolist()):
            t = tiles[k]
            ref = rs.rowscan_sweep_plain(atoms[b], t.row_start, t.row_count, t.col_ids, scalars[b], series, mode, True)
            assert torch.equal(out[b], ref)
        assert out.abs().sum() > 0


def test_batched_provider_matches_single_and_poisons_one_replica():
    """The batched provider against the single provider of each replica:
    forces and energies bitwise (f64 plain sweeps), the energy under S
    parameter sets equal to the single fifth function's; with max_pairs
    below one replica's listed tiles only that replica comes back NaN."""
    box = _t(np.eye(3) * 6.0)
    (c0, p0), (_, p1) = _fluid(1500, 6.0, 0), _fluid(1500, 6.0, 1)
    c1 = 0.2 * c0  # collapsed into a corner: every chunk pair listed
    xs, ps, boxes = _t(np.stack([c0, c1])), _t(np.stack([p0, p1])), box.expand(2, 3, 3).contiguous()
    counts = [int(rs.build_rowscan_tiles(xs[k], box, CUTOFF + 0.1, 10**6, triangular=True).row_count.sum()) for k in (0, 1)]
    assert counts[0] != counts[1]
    for cap, poisoned in ((max(counts), ()), (min(counts), (int(np.argmax(counts)),))):
        single = rs.make_nonbonded_rowscan_md(BETA, CUTOFF, cap)
        init, apply, energy, energy_with_params = rs.make_nonbonded_rowscan_md_batched(BETA, CUTOFF, cap)
        state = init(xs, ps, boxes)
        f, state = apply(state, xs, ps, boxes, 1)
        u = energy(state, xs, boxes)
        sets = torch.stack([ps, ps * 1.1, ps.flip(0)], 1)  # (K, S, N, 4)
        u_sets = energy_with_params(state, xs, sets, boxes)
        for k in range(2):
            if k in poisoned:
                assert torch.isnan(f[k]).all() and torch.isnan(u[k]) and torch.isnan(u_sets[k]).all()
                continue
            st = single[0](xs[k], ps[k], box)
            assert torch.equal(f[k], single[1](st, xs[k], ps[k], box, 1)[0])
            assert torch.equal(u[k], single[2](st, xs[k], ps[k], box))
            for s in range(3):
                assert torch.equal(u_sets[k, s], single[3](st, xs[k], sets[k, s], box))


# -- the batched step ---------------------------------------------------------------


def _feed_uniforms(ctx, uniforms, k=None):
    """Give ctx's barostat the uniforms uniforms[move] (row k for a single
    Context) instead of its generator's."""
    move_with = ctx.movers[0].make_move_with_uniforms(lambda x, b: ctx._mover_energy(x, b, True), ctx.device)
    n = [0]

    def move(state, x, v, box):
        u = uniforms[n[0]] if k is None else uniforms[n[0]][k]
        n[0] += 1
        return move_with(state, x, v, box, u[..., 0], u[..., 1])

    ctx._move_fns[0] = move


@pytest.mark.parametrize("form", FORMS)
def test_batched_step_matches_single_contexts(small, form):
    """30 steps of the three windows in one BatchedContext against three
    single-system Contexts, f64, fed the same (K, N, 3) noise and barostat
    uniforms, the barostat every 15 steps (and, in the rowscan form, the
    lists rebuilt at step 20): x, v and box to 1e-12 relative, the
    barostat's counters equal."""
    states = [as_form(s, form) for s in small["port"]]
    k = len(states)
    singles = [tfe.get_context(s) for s in states]
    batch = BatchedContext(
        singles[0], np.stack([s.x0 for s in states]), np.stack([s.v0 for s in states]),
        np.stack([s.box0 for s in states]), _params(states), seed=0,
    )
    rng = np.random.default_rng(4)
    uniforms = [_t(rng.random((k, 2))) for _ in range(2)]
    for c in [batch, *singles]:
        c.set_barostat_interval(15)
        c.multiple_steps(0)
    _feed_uniforms(batch, uniforms)
    for r, c in enumerate(singles):
        _feed_uniforms(c, uniforms, r)
    with torch.no_grad():
        for _ in range(30):
            noise = _t(rng.normal(size=batch._x.shape))
            batch._one_step(noise)
            for r, c in enumerate(singles):
                c._one_step(noise[r])
    for r, c in enumerate(singles):
        for a, b in ((batch.get_x_t()[r], c.get_x_t()), (batch.get_v_t()[r], c.get_v_t()), (batch.get_box()[r], c.get_box())):
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
        bs, ss = batch.get_mover_states()[0], c.get_mover_states()[0]
        assert int(bs.total_attempted[r]) == int(ss.total_attempted) == 2
        assert int(bs.total_accepted[r]) == int(ss.total_accepted)
    assert not np.array_equal(batch.get_box()[0], states[0].box0)  # a move was accepted


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_step_operations_do_not_grow_with_k(small, monkeypatch):
    """One step that neither rebuilds nor moves the box dispatches as many
    tensor operations at K = 2 as at K = 3: every term runs once for all
    replicas. The host term is configured as the card's, kernel="rowscan"
    (the CPU's rule would take the dense form): its sweep, one kernel
    launch on a card, is stubbed here, where its plain version loops over
    systems."""

    def stub(atoms, *args, **kwargs):
        return atoms.new_zeros((*atoms.shape[:2], 4))

    monkeypatch.setattr(rs, "rowscan_sweep_batched", stub)
    counts = []
    for k in (2, 3):
        states = [as_form(s, "rowscan") for s in small["port32"][:k]]
        batch = BatchedContext(
            tfe.get_context(states[0]), np.stack([s.x0 for s in states]), np.stack([s.v0 for s in states]),
            np.stack([s.box0 for s in states]), _params(states), seed=0,
        )
        batch.multiple_steps(1)  # the rebuild at step 0
        with torch.no_grad(), _CountOps() as c:
            batch._one_step()
        counts.append(c.n)
    assert counts[0] == counts[1] > 100


# -- the banded energies ----------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("max_delta", [1, None])
def test_banded_energies_match_jax_potential_matrix(small, max_delta, form):
    """The port's compute_potential_matrix (on the replicas' coordinates
    with the permutation [2, 0, 1]) against JAX's: the exact-function
    terms' sum to 1e-10 relative, the host term (the dense form in both
    packages) to HOST_REL of its energy (measured 2.3e-15), the +inf
    pattern identical. The runner's banded U_kl, its host term in `form`
    (rowscan: the batched provider's f64 banded energies through one list
    build, the exclusions vmapped), against the port's
    compute_potential_matrix of every term, the host term's through that
    form's single-system u, to 1e-10 relative (f64; other lists, other sum
    order)."""
    from timemachine_tpu.fe import free_energy as jfe
    from timemachine_tpu.md import hrex as jh
    from timemachine_tpu.md.states import CoordsVelBox as JCoordsVelBox
    from timemachine_tpu.potentials import make_summed_potential

    jstates, states = small["jax"], small["port"]
    formed = [as_form(s, form) for s in states]
    perm = [2, 0, 1]
    reps = [CoordsVelBox(s.x0, s.v0, s.box0) for s in states]
    jhrex = jh.HREX([JCoordsVelBox(*r) for r in reps], perm)
    hrex = th.HREX(reps, perm)

    def jax_matrix(terms):
        sums = [make_summed_potential([js.potentials[i] for i in terms]) for js in jstates]
        params = np.stack([np.asarray(sp.params) for sp in sums])
        return jfe.compute_potential_matrix(sums[0].potential, jhrex, params, max_delta)

    def port_matrix(terms, states=states):
        pots = [states[0].potentials[i] for i in terms]
        by_state = [[s.potentials[i].params for i in terms] for s in states]
        return tfe.compute_potential_matrix(
            lambda x, ps, b: sum(pot.u(_t(x), p, _t(b)) for pot, p in zip(pots, ps)), hrex, by_state, max_delta
        )

    j_exact, j_host = jax_matrix(EXACT_TERMS), jax_matrix([HOST])
    exact, host = port_matrix(EXACT_TERMS), port_matrix([HOST])
    finite = np.isfinite(j_exact)
    assert (finite == np.isfinite(exact)).all() and (finite == np.isfinite(j_host)).all()
    assert finite.sum() == (7 if max_delta == 1 else 9)
    assert np.abs(exact[finite] - j_exact[finite]).max() <= 1e-10 * np.abs(j_exact[finite]).max()
    assert np.abs(host[finite] - j_host[finite]).max() <= HOST_REL * np.abs(j_host[finite]).max()

    banded = _runner(formed, max_delta, perm).banded_energies()
    assert (np.isfinite(banded) == finite).all()
    total = exact + port_matrix([HOST], formed)
    assert np.abs(banded[finite] - total[finite]).max() <= 1e-10 * np.abs(total[finite]).max()
    checked = tfe.verify_and_sanitize_potential_matrix(banded, perm)
    assert np.array_equal(checked, banded)


def test_verify_and_sanitize_potential_matrix():
    """NaN entries become +inf with a warning; a non-finite or too large
    energy of a replica at its own state fails."""
    U = np.array([[1.0, np.nan], [np.inf, 2.0]])
    with pytest.warns(tfe.IndeterminateEnergyWarning):
        out = tfe.verify_and_sanitize_potential_matrix(U, [0, 1])
    assert np.isposinf(out[0, 1]) and out[0, 0] == 1.0
    with pytest.raises(AssertionError):
        tfe.verify_and_sanitize_potential_matrix(U, [1, 0])
    with pytest.raises(AssertionError):
        tfe.verify_and_sanitize_potential_matrix(np.diag([1.0, 2e9]), [0, 1])


# -- run_sims_hrex ---------------------------------------------------------------------

HREX_MD = tfe.MDParams(n_frames=3, n_eq_steps=2, steps_per_frame=2, seed=2023, hrex_params=tfe.HREXParams())


@pytest.fixture(scope="module", params=FORMS)
def hrex_runs(request, small):
    """Two runs of run_sims_hrex over the three small windows in f32 on the
    CPU (2 equilibration steps, 3 frames 2 steps apart), the host term in
    each of FORMS."""
    states = [as_form(s, request.param) for s in small["port32"]]
    return [tfe.run_sims_hrex(states, HREX_MD, print_diagnostics_interval=None) for _ in range(2)]


def test_run_sims_hrex_is_finite_and_repeats_bitwise(hrex_runs):
    """run_sims_hrex: 2 finite pair-BAR results over 3 windows, 3 frames and
    boxes a state with final velocities and volume scales, diagnostics of
    the right shapes, the host term's works exactly zero, and a second run
    bitwise equal (frames, boxes, permutations, u_kln)."""
    (res, trajs, diag, water), (res2, trajs2, diag2, _) = hrex_runs
    assert water is None and len(res.bar_results) == 2 and len(trajs) == 3
    assert np.isfinite(res.dGs).all() and np.isfinite(res.dG_errs).all()
    for t in trajs:
        assert len(t.frames) == len(t.boxes) == 3 and t.final_velocities.shape == t.frames[0].shape
        assert t.final_barostat_volume_scale_factor is not None and np.isfinite(t.frames).all()
    assert np.asarray(diag.replica_idx_by_state_by_iter).shape == (3, 3)
    assert np.asarray(diag.fraction_accepted_by_pair_by_iter).shape == (3, 2, 2)
    assert diag.cumulative_swap_acceptance_rates.shape == (3, 2) and diag.transition_matrix.shape == (3, 3)
    assert all(sum(p for _, p in it) == 27 for it in diag.fraction_accepted_by_pair_by_iter)
    u = res.u_kln_by_component_by_lambda
    assert not (u[:, HOST, 0, 1] - u[:, HOST, 0, 0]).any()
    assert np.array_equal(u, res2.u_kln_by_component_by_lambda)
    assert diag.replica_idx_by_state_by_iter == diag2.replica_idx_by_state_by_iter
    for t, t2 in zip(trajs, trajs2):
        assert all(np.array_equal(a, b) for a, b in zip(list(t.frames) + t.boxes, list(t2.frames) + t2.boxes))


def test_hrex_simulation_result_by_replica(small, hrex_runs):
    """HREXSimulationResult.extract_trajectories_by_replica regroups the
    frames by replica, and trajectories_by_replica_to_by_state (against
    JAX's) takes them back."""
    from timemachine_tpu.fe import free_energy as jfe

    res, trajs, diag, _ = hrex_runs[0]
    sim = tfe.HREXSimulationResult(res, None, trajs, HREX_MD, [res], hrex_diagnostics=diag)
    lig = small["port32"][0].ligand_idxs
    by_replica = sim.extract_ligand_trajectories_by_replica()
    assert by_replica.shape == (3, 3, len(lig), 3)
    perms = diag.replica_idx_by_state_by_iter
    back = tfe.trajectories_by_replica_to_by_state(by_replica, perms)
    assert np.array_equal(back, np.array([np.asarray(t.frames)[:, lig] for t in trajs]))
    assert np.array_equal(back, jfe.trajectories_by_replica_to_by_state(by_replica, perms))
    assert [len(f) for f in sim.frames] == [3, 3, 3] and sim.boxes[0].shape == (3, 3, 3)


def test_run_sims_hrex_two_states_identity_pair(small):
    """With two states run_sims_hrex adds the identity pair (0, 0) for the
    scan and strips it from the diagnostics: one pair reported."""
    md = tfe.MDParams(n_frames=2, n_eq_steps=0, steps_per_frame=2, seed=3, hrex_params=tfe.HREXParams())
    res, trajs, diag, _ = tfe.run_sims_hrex(small["port32"][:2], md, print_diagnostics_interval=1)
    assert len(res.bar_results) == 1 and np.isfinite(res.dGs).all()
    assert np.asarray(diag.fraction_accepted_by_pair_by_iter).shape == (2, 1, 2)
    assert all(p <= 8 for it in diag.fraction_accepted_by_pair_by_iter for _, p in it)


def test_refusals(small):
    """REST, local MD and water sampling, which raised before they were
    ported, are accepted: HREXParams takes RESTParams, MDParams takes
    LocalMDParams and WaterSamplingParams, and run_sims_hrex then returns
    the water sampler's diagnostics."""
    assert tfe.HREXParams(rest_params=tfe.RESTParams(2.0)).rest_params.max_temperature_scale == 2.0
    md = tfe.MDParams(n_frames=1, n_eq_steps=0, steps_per_frame=1, seed=1, hrex_params=tfe.HREXParams())
    assert tfe.MDParams(**{**md.__dict__, "local_md_params": tfe.LocalMDParams(1)}).local_md_params.local_steps == 1
    wsp = tfe.WaterSamplingParams(interval=1, n_proposals=2, batch_size=2, radius=0.5)
    water = tfe.run_sims_hrex(small["port32"], tfe.MDParams(**{**md.__dict__, "water_sampling_params": wsp}))[3]
    assert isinstance(water, tfe.WaterSamplingDiagnostics)
    assert water.proposals_by_state_by_iter.shape == (1, 3, 2) and (water.proposals_by_state_by_iter[..., 1] == 2).all()


# -- REST windows in the batched step ------------------------------------------------------

REST_LAMBDAS = (0.25, 0.5, 0.75)


@pytest.fixture(scope="module")
def rest_states(small):
    """Three REST windows of the small edge (SingleTopologyREST, max
    temperature scale 3, λ 0.25, 0.5, 0.75) built by the port in the
    fixture's 2.6 nm box, at the coordinates, velocities and box of the
    fixture's three windows, f64 on the CPU."""
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.fe import rbfe as trbfe
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.md.builders import build_water_system

    st = small["st"]
    mols = []
    for m in (st.mol_a, st.mol_b):
        tm = mol_from_smiles({"ethanol": "CCO", "propane": "CCC"}[m.name], add_hs=True, name=m.name)
        tm.set_conf(np.asarray(m.get_conf()))
        mols.append(tm)
    ff = Forcefield.load_default()
    rest = trbfe.make_single_topology(*mols, np.asarray(st.core), ff, tfe.RESTParams(3.0))
    cfg = build_water_system(2.6, ff.water_ff, mols=mols)
    host = trbfe.Host(cfg.host_system, cfg.masses, cfg.conf, cfg.box, cfg.num_water_atoms, cfg.host_topology)
    out = []
    for lamb, ref in zip(REST_LAMBDAS, small["port"]):
        s = trbfe.setup_initial_state(rest, lamb, host, TEMP, 2023, device="cpu", dtype=F64)
        s.x0, s.v0, s.box0 = ref.x0, ref.v0, ref.box0
        out.append(s)
    return rest, out


@pytest.mark.parametrize("form", FORMS)
def test_rest_windows_batched_step_and_banded_energies(rest_states, form):
    """K = 3 REST windows, whose propers, ligand pair list and interaction
    group differ by state (the REST-scaled entries): 4 steps in one
    BatchedContext against three single Contexts fed the same noise, f64,
    x and v to 1e-12 relative; the runner's banded U_kl (max_delta_states 1
    and None, the permutation [2, 0, 1]) against compute_potential_matrix
    of every term at each state's own parameters, to 1e-10 relative, the
    +inf pattern identical."""
    st, states = rest_states
    scale = [st.get_energy_scale_factor(lamb) for lamb in REST_LAMBDAS]
    assert scale[1] < scale[0] < 1.0 and len(st.target_proper_idxs) > 0
    for i in (2, 5, 7):  # proper, nonbonded_pair_list, nonbonded_ixn_group
        assert not torch.equal(states[0].potentials[i].params, states[2].potentials[i].params)
    formed = [as_form(s, form) for s in states]
    singles = [tfe.get_context(s) for s in formed]
    batch = BatchedContext(
        singles[0], np.stack([s.x0 for s in formed]), np.stack([s.v0 for s in formed]),
        np.stack([s.box0 for s in formed]), _params(formed), seed=0,
    )
    for c in [batch, *singles]:
        c.multiple_steps(0)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for _ in range(4):
            noise = _t(rng.normal(size=batch._x.shape))
            batch._one_step(noise)
            for r, c in enumerate(singles):
                c._one_step(noise[r])
    for r, c in enumerate(singles):
        for a, b in ((batch.get_x_t()[r], c.get_x_t()), (batch.get_v_t()[r], c.get_v_t())):
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()

    perm = [2, 0, 1]
    hrex = th.HREX([CoordsVelBox(s.x0, s.v0, s.box0) for s in states], perm)
    pots = formed[0].potentials
    for max_delta in (1, None):
        banded = _runner(formed, max_delta, perm).banded_energies()
        ref = tfe.compute_potential_matrix(
            lambda x, ps, b: sum(pot.u(_t(x), p, _t(b)) for pot, p in zip(pots, ps)), hrex,
            [[p.params for p in s.potentials] for s in formed], max_delta,
        )
        finite = np.isfinite(ref)
        assert (np.isfinite(banded) == finite).all() and finite.sum() == (7 if max_delta == 1 else 9)
        assert np.abs(banded[finite] - ref[finite]).max() <= 1e-10 * np.abs(ref[finite]).max()


# -- the API members that HREX brought -------------------------------------------------


def test_api_members_match_jax(small):
    """PairBarResult's by-component accessors, Trajectory.extend and
    Trajectory.empty, InitialState.total_energy_fn and compute_u_kn against
    JAX's: BAR fields equal; the total energy to HOST_REL of the host
    term's (measured 9.9e-16) and each exact term's sum to 1e-10; u_kn
    likewise (measured 2.3e-15)."""
    from timemachine_tpu.fe import free_energy as jfe
    from timemachine_tpu.fe.stored_arrays import StoredArrays

    rng = np.random.default_rng(0)
    results = [
        tfe.BarResult(1.0, 0.1, rng.random(8), 0.5, rng.random(8), rng.random((8, 2, 2, 3))) for _ in range(2)
    ]
    jres = [jfe.BarResult(**r.__dict__) for r in results]
    pr, jpr = tfe.PairBarResult(small["port"], results), jfe.PairBarResult(small["jax"], jres)
    np.testing.assert_array_equal(pr.dG_err_by_component_by_lambda, jpr.dG_err_by_component_by_lambda)
    np.testing.assert_array_equal(pr.overlap_by_component_by_lambda, jpr.overlap_by_component_by_lambda)

    frames = [rng.random((2, 5, 3)) for _ in range(2)]
    traj = tfe.Trajectory.empty()
    jtraj = jfe.Trajectory.empty()
    for f in frames:
        traj.extend(tfe.Trajectory(list(f), [np.eye(3)] * 2, f[-1], 0.5))
        jtraj.extend(jfe.Trajectory(StoredArrays.from_chunks([f]), [np.eye(3)] * 2, f[-1], 0.5))
    assert np.array_equal(np.array(traj.frames), np.array(jtraj.frames))
    assert np.array_equal(traj.final_velocities, jtraj.final_velocities) and traj.final_barostat_volume_scale_factor == 0.5

    s, js = small["port"][1], small["jax"][1]
    u = float(s.total_energy_fn()(_t(s.x0), _t(s.box0)))
    u_j = float(js.total_energy_fn()(js.x0, js.box0))
    host = float(s.potentials[HOST].u(_t(s.x0), s.potentials[HOST].params, _t(s.box0)))
    assert abs(u - u_j) <= HOST_REL * abs(host)

    trajs = [tfe.Trajectory([np.asarray(st.x0)], [np.asarray(st.box0)], None) for st in small["port"]]
    jtrajs = [jfe.Trajectory(StoredArrays.from_chunks([np.asarray(st.x0)[None]]), [np.asarray(st.box0)], None)
              for st in small["jax"]]
    (u_kn, n_k), (ju_kn, jn_k) = tfe.compute_u_kn(trajs, small["port"]), jfe.compute_u_kn(jtrajs, small["jax"])
    assert np.array_equal(n_k, jn_k) and u_kn.shape == ju_kn.shape == (3, 3)
    assert np.abs(u_kn - ju_kn).max() <= HOST_REL * abs(host) / (0.0083144626 * TEMP)
