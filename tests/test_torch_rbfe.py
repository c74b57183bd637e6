"""The solvent RBFE leg of the port against timemachine_tpu: the window's
potentials, the velocity Verlet Context, the Context methods the leg uses,
the pair-BAR u_kln and run_sims_sequential (MBAR and BAR are held in
tests/test_torch_bar.py, the committed cache of the 12 ethanol -> propane
states in tests/test_torch_rbfe_cache.py).

The small windows are the JAX package's own: ethanol -> propane (embedded
with seed 7, as tests/test_rbfe_default.py does) in build_water_system(2.6)
(the smallest box that holds twice the 1.2 nm cutoff), at λ 0, 0.4 and 1,
from fe/rbfe.py setup_initial_state without the host's pre-equilibration;
each window's ligand is relaxed in its fixed host by 200 steps of the
port's FIRE, and the coordinates are given to both packages.

Tolerances (stated per test): exact-function terms in f64 to 1e-10
relative. The
host term runs JAX's dense exact-erfc form in both packages on the CPU: its
energies agree to HOST_REL (measured 1.5e-15 on these frames; 4.7e-4 while
the port ran the rowscan polynomial, ROADMAP P11), and its works are
exactly zero in both
(tests/test_torch_rbfe_masked.py holds the function against JAX's masked
rowscan path). The Context tests run each window in both host forms
(FORMS): rowscan, the card's at the leg's size, whose lists a rebuild and a
reset must renew, and dense, the CPU's (configure_all_pairs' choice here).

Run `python tests/test_torch_rbfe.py --write-cache` to rebuild
timemachine_torch/testsystems/cache/rbfe_solvent_ethanol_propane.npz with
the JAX package (its pre-equilibration and 12 minimizations take an hour or
more on a CPU).
"""

import copy
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from timemachine_torch import convert  # noqa: E402
from timemachine_torch.fe import free_energy as tfe  # noqa: E402
from timemachine_torch.integrators import VelocityVerletIntegrator  # noqa: E402
from timemachine_torch.md.context import Context  # noqa: E402
from timemachine_torch.md.fire import FireMinimizationConfig, fire_minimize  # noqa: E402
from timemachine_torch.md.utils import sample_velocities  # noqa: E402
from timemachine_torch.testsystems import rbfe_solvent  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores

F64 = torch.float64
TEMP = 300.0
SMILES, NAMES, EMBED_SEED = ("CCO", "CCC"), ("ethanol", "propane"), 7
LAMBDAS_SMALL = (0.0, 0.4, 1.0)
TERMS = ("bond", "angle", "proper", "improper", "chiral_atom", "nonbonded_pair_list", "nonbonded_all_pairs", "nonbonded_ixn_group")
EXACT_TERMS = [i for i, t in enumerate(TERMS) if t != "nonbonded_all_pairs"]
HOST = TERMS.index("nonbonded_all_pairs")
HOST_REL = 1e-10
FORMS = ("rowscan", "dense")  # the host term's Context form on the card at the leg's size, on the CPU


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _edge_inputs(confs=None):
    """(mol_a, mol_b, core, forcefield) of the ethanol -> propane edge, the
    molecules embedded with EMBED_SEED, or given the conformers `confs`
    (the cache records the embedding's, which takes 20 s on a CPU)."""
    from timemachine_tpu.chem import mol_from_smiles
    from timemachine_tpu.chem.embed import embed_mol
    from timemachine_tpu.constants import DEFAULT_ATOM_MAPPING_KWARGS
    from timemachine_tpu.fe.atom_mapping import get_cores
    from timemachine_tpu.ff import Forcefield

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mols = [mol_from_smiles(s, add_hs=True, name=n) for s, n in zip(SMILES, NAMES)]
        for k, m in enumerate(mols):
            if confs is None:
                embed_mol(m, seed=EMBED_SEED)
            else:
                m.set_conf(np.asarray(confs[k]))
        core = get_cores(*mols, **DEFAULT_ATOM_MAPPING_KWARGS)[0]
    return mols[0], mols[1], core, Forcefield.load_default()


def _cache_meta():
    return rbfe_solvent.metadata(rbfe_solvent.load_arrays())


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.fixture(scope="module")
def small():
    """The three small windows in both packages, each ligand relaxed in its
    fixed host by the port's FIRE (the coordinates written into both), the
    port's also in f32 (the Context tests, which hold runs bitwise, run in
    it for speed), and the edge's SingleTopology."""
    _jax()
    from timemachine_tpu.fe.rbfe import Host, setup_initial_state
    from timemachine_tpu.fe.single_topology import SingleTopology
    from timemachine_tpu.md.builders import build_water_system

    meta = _cache_meta()
    mol_a, mol_b, core, ff = _edge_inputs((meta["conf_a"], meta["conf_b"]))
    st = SingleTopology(mol_a, mol_b, core, ff)
    cfg = build_water_system(2.6, ff.water_ff, mols=[mol_a, mol_b])
    host = Host(cfg.host_system, cfg.masses, cfg.conf, cfg.box, cfg.num_water_atoms, cfg.host_topology)
    j_states = [setup_initial_state(st, lamb, host, TEMP, 2023) for lamb in LAMBDAS_SMALL]
    states = []
    for js in j_states:
        s = convert.initial_state_from_jax(js, device="cpu", dtype=F64)
        tfe.configure_all_pairs(s)
        box, lig = _t(s.box0), torch.as_tensor(s.ligand_idxs, dtype=torch.int64)

        def ligand_force(x):
            f = sum(p.energy_force(x, box)[1] for i, p in enumerate(s.potentials) if i != HOST)
            return torch.zeros_like(f).index_copy_(0, lig, f[lig])

        s.x0 = js.x0 = fire_minimize(_t(s.x0), ligand_force, FireMinimizationConfig(200)).numpy()
        states.append(s)
    port32 = [convert.initial_state_from_jax(js, device="cpu", dtype=torch.float32) for js in j_states]
    return dict(st=st, jax=j_states, port=states, port32=port32)


def _jax_u_f(bp, x, box):
    """The JAX term's energy and force, jitted as the JAX package's Context
    runs it (one compile costs less than eager dispatch's per-op compiles)."""
    jax = _jax()
    import jax.numpy as jnp

    u_f = jax.jit(jax.value_and_grad(lambda xx, p, b: bp.potential(xx, p, b)))
    u, g = u_f(jnp.asarray(x), jnp.asarray(bp.params), jnp.asarray(box))
    return float(u), -np.asarray(g)


@pytest.mark.parametrize("lamb_i", range(len(LAMBDAS_SMALL)))
@pytest.mark.parametrize("term", EXACT_TERMS, ids=[TERMS[i] for i in EXACT_TERMS])
def test_window_term_matches_jax(small, term, lamb_i):
    """Each exact-function term of a window (bonded, chiral, the ligand's
    precomputed pairs, the interaction group) against the JAX term in f64:
    energy (energy_force and u) and force to 1e-10 relative."""
    js, s = small["jax"][lamb_i], small["port"][lamb_i]
    pot = s.potentials[term]
    x, box = _t(js.x0), _t(js.box0)
    u_j, f_j = _jax_u_f(js.potentials[term], js.x0, js.box0)
    u, f = pot.energy_force(x, box)
    assert float(u) == pytest.approx(u_j, rel=1e-10, abs=1e-10)
    assert float(pot.u(x, pot.params, box)) == pytest.approx(u_j, rel=1e-10, abs=1e-10)
    assert np.abs(f.numpy() - f_j).max() <= 1e-10 * max(np.abs(f_j).max(), 1.0)


def _pairs_case(seed, n=24, p=40):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1.5, (n, 3))
    params = np.stack([rng.uniform(-1, 1, n), rng.uniform(0.05, 0.2, n), rng.uniform(0.1, 0.9, n), rng.uniform(0, 0.3, n)], 1)
    idxs = np.array(sorted({tuple(sorted(rng.choice(n, 2, replace=False))) for _ in range(p)}))
    scales = rng.uniform(0, 1, (len(idxs), 2)) * (rng.random((len(idxs), 2)) > 0.2)
    return x, params, idxs, scales, np.eye(3) * 2.0


@pytest.mark.parametrize("cls", ["NonbondedPairList", "NonbondedExclusions", "NonbondedPairListPrecomputed"])
def test_pair_list_terms_match_jax(cls):
    """The pair-list terms no window of this leg carries on its own (and the
    precomputed one on random rows) against the JAX classes in f64, some
    pairs across the box and beyond the cutoff, some scales zero: energy
    and force to 1e-10 relative; the two flagged rigid-invariant as in JAX."""
    import jax.numpy as jnp

    from timemachine_torch import potentials as tp
    from timemachine_tpu import potentials as jp

    x, params, idxs, scales, box = _pairs_case(0)
    beta, cutoff = 2.0, 1.0
    if cls == "NonbondedPairListPrecomputed":
        params = np.random.default_rng(1).uniform(0.05, 0.9, (len(idxs), 4)) * [1, 0.3, 1, 0.2]
        pot = tp.NonbondedPairListPrecomputed(idxs, params, beta, cutoff, len(x), device="cpu")
        jpot = jp.NonbondedPairListPrecomputed(idxs, beta, cutoff)
    else:
        pot = getattr(tp, cls)(idxs, scales, params, beta, cutoff, len(x), device="cpu")
        jpot = getattr(jp, cls)(idxs, scales, beta, cutoff)
    assert pot.rigid_group_invariant == getattr(jpot, "rigid_group_invariant", False)
    u_j, f_j = _jax_u_f(jpot.bind(jnp.asarray(params)), x, box)
    u, f = pot.energy_force(_t(x), _t(box))
    assert float(u) == pytest.approx(u_j, rel=1e-10)
    assert float(pot.energy(_t(x), _t(box))) == pytest.approx(u_j, rel=1e-10)
    assert np.abs(f.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("cls", ["ChiralAtomRestraint", "ChiralBondRestraint"])
def test_chiral_terms_volume_sign(cls, sign):
    """Chiral restraints on a tetrahedron and a torsion in both handednesses
    (mirrored in z): the restraint is live only for the volume sign it
    penalizes; energy and force against the JAX term to 1e-10 relative, and
    the live case is nonzero; only the atom restraint is flagged
    rigid-invariant, as in JAX."""
    import jax.numpy as jnp

    from timemachine_torch import potentials as tp
    from timemachine_tpu import potentials as jp

    x = np.array([[0.0, 0.0, 0.0], [0.1, 0.0, 0.03], [-0.05, 0.09, 0.03], [-0.05, -0.09, 0.03], [0.12, 0.1, 0.02]])
    x = x * np.array([1.0, 1.0, sign]) + 1.0
    idxs = np.array([[0, 1, 2, 3], [4, 0, 1, 2]])
    k = np.array([1000.0, 700.0])
    if cls == "ChiralAtomRestraint":
        pot, jpot = tp.ChiralAtomRestraint(idxs, k, 5, device="cpu"), jp.ChiralAtomRestraint(idxs)
    else:
        signs = np.array([1.0, -1.0])
        pot, jpot = tp.ChiralBondRestraint(idxs, signs, k, 5, device="cpu"), jp.ChiralBondRestraint(idxs, signs)
    assert pot.rigid_group_invariant == getattr(jpot, "rigid_group_invariant", False)
    box = np.eye(3) * 3.0
    u_j, f_j = _jax_u_f(jpot.bind(jnp.asarray(k)), x, box)
    u, f = pot.energy_force(_t(x), _t(box))
    assert float(u) == pytest.approx(u_j, rel=1e-10, abs=1e-12)
    assert np.abs(f.numpy() - f_j).max() <= 1e-10 * max(np.abs(f_j).max(), 1.0)
    assert (u_j > 0) == (float(u) > 0)
    assert any(
        _jax_u_f(jpot.bind(jnp.asarray(k)), x * np.array([1.0, 1.0, s]), box)[0] > 0 for s in (1.0, -1.0)
    )


@pytest.mark.parametrize("lamb", LAMBDAS_SMALL)
def test_guest_system_from_arrays_matches_jax(small, lamb):
    """GuestSystem.from_arrays on the arrays of the JAX package's vacuum
    hybrid (SingleTopology.setup_intermediate_state) against that
    GuestSystem: get_U_fns lists the same terms in the same order, and
    every field's energy and force (the inactive chiral bond term too) at
    the hybrid's conformer in a 10 nm box agree to 1e-10 relative in f64."""
    from dataclasses import fields

    from timemachine_torch.fe.system import GuestSystem
    from timemachine_tpu.fe.utils import get_romol_conf

    st = small["st"]
    vac = st.setup_intermediate_state(lamb)
    x0 = np.asarray(st.combine_confs(get_romol_conf(st.mol_a), get_romol_conf(st.mol_b), lamb))
    box = np.eye(3) * 10.0
    port = GuestSystem.from_arrays(
        convert.host_guest_arrays([getattr(vac, f.name) for f in fields(vac)]), len(x0), device="cpu"
    )
    assert [type(p).__name__ for p in port.get_U_fns()] == [type(bp.potential).__name__ for bp in vac.get_U_fns()]
    for f in fields(vac):
        u_j, f_j = _jax_u_f(getattr(vac, f.name), x0, box)
        u, force = getattr(port, f.name).energy_force(_t(x0), _t(box))
        assert float(u) == pytest.approx(u_j, rel=1e-10, abs=1e-10), f.name
        assert np.abs(force.numpy() - f_j).max() <= 1e-10 * max(np.abs(f_j).max(), 1.0), f.name


@pytest.mark.parametrize("case", ["compatible", "pressure", "water_params"])
def test_assert_ensembles_compatible_matches_jax(small, case):
    """assert_ensembles_compatible on windows 0 and 2 in both packages: they
    pass, with get_water_sampler_params equal to JAX's; window 2 given
    another barostat pressure, or another charge on one water atom of its
    host term, fails in both."""
    from dataclasses import replace

    import jax.numpy as jnp

    from timemachine_tpu.fe import free_energy as jfe

    (j0, _, j2), (s0, _, s2) = small["jax"], small["port"]
    if case == "pressure":
        j2 = replace(j2, barostat=replace(j2.barostat, pressure=2.0 * j2.barostat.pressure))
        s2 = replace(s2, barostat=replace(s2.barostat, pressure=2.0 * s2.barostat.pressure))
    elif case == "water_params":
        params = np.asarray(j2.potentials[HOST].params).copy()
        params[0, 0] += 0.1
        j2 = replace(j2, potentials=[*j2.potentials[:HOST], j2.potentials[HOST].potential.bind(jnp.asarray(params)),
                                     *j2.potentials[HOST + 1:]])
        host = copy.deepcopy(s2.potentials[HOST])
        host.params.copy_(torch.as_tensor(params))
        s2 = replace(s2, potentials=[*s2.potentials[:HOST], host, *s2.potentials[HOST + 1:]])
    if case == "compatible":
        tfe.assert_ensembles_compatible(s0, s2)
        jfe.assert_ensembles_compatible(j0, j2)
        for s, j in ((s0, j0), (s2, j2)):
            np.testing.assert_array_equal(tfe.get_water_sampler_params(s), jfe.get_water_sampler_params(j))
    else:
        for check, a, b in ((tfe.assert_ensembles_compatible, s0, s2), (jfe.assert_ensembles_compatible, j0, j2)):
            with pytest.raises(AssertionError):
                check(a, b)


def test_velocity_verlet_context_matches_jax(small):
    """The vacuum hybrid ligand at λ 0.5 (bonded and chiral terms only, f64,
    no noise) under VelocityVerletIntegrator: 200 steps in one call and then
    50 more in another, x and v against JAX's Context to 1e-9 (relative to
    their largest entries); the port's step() equals multiple_steps(1)
    bitwise."""
    from timemachine_tpu.integrators import VelocityVerletIntegrator as JVV
    from timemachine_tpu.md.context import Context as JContext

    st = small["st"]
    vac = st.setup_intermediate_state(0.5)
    bps = [bp for bp in vac.get_U_fns() if type(bp.potential).__name__ != "NonbondedPairListPrecomputed"]
    from timemachine_torch import potentials as tp
    from timemachine_tpu.fe.utils import get_romol_conf

    x0 = st.combine_confs(get_romol_conf(st.mol_a), get_romol_conf(st.mol_b), 0.5)
    masses = np.asarray(st.combine_masses())
    v0 = sample_velocities(masses, TEMP, 11)
    box = np.eye(3) * 10.0

    def port_terms():
        return [
            getattr(tp, type(bp.potential).__name__)(np.asarray(bp.potential.idxs), np.asarray(bp.params), len(x0), device="cpu")
            for bp in bps
        ]

    ctx = Context(x0, v0, box, VelocityVerletIntegrator(1.5e-3, masses), port_terms(), device="cpu")
    jctx = JContext(x0, v0, box, JVV(1.5e-3, masses), bps)
    for n in (200, 50):
        ctx.multiple_steps(n)
        jctx.multiple_steps(n)
        for a, b in ((ctx.get_x_t(), jctx.get_x_t()), (ctx.get_v_t(), jctx.get_v_t())):
            assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()
    c1 = Context(x0, v0, box, VelocityVerletIntegrator(1.5e-3, masses), port_terms(), device="cpu")
    c2 = Context(x0, v0, box, VelocityVerletIntegrator(1.5e-3, masses), port_terms(), device="cpu")
    c1.step()
    c2.multiple_steps(1)
    assert np.array_equal(c1.get_x_t(), c2.get_x_t()) and np.array_equal(c1.get_v_t(), c2.get_v_t())


def as_form(state, kernel):
    """A deep copy of the state with its host term configured as `kernel`
    (one of FORMS), which get_context keeps."""
    s = copy.deepcopy(state)
    dt = s.potentials[HOST].params.dtype
    s.potentials[HOST].configure(torch.as_tensor(s.box0, dtype=dt), torch.as_tensor(s.x0, dtype=dt), kernel=kernel)
    return s


def _ctx(state, interval=None):
    ctx = tfe.get_context(state)
    if interval is not None:
        ctx.set_barostat_interval(interval)
    return ctx


def _same_run(a: Context, b: Context):
    return all(np.array_equal(f(a), f(b)) for f in (Context.get_x_t, Context.get_v_t, Context.get_box))


@pytest.mark.parametrize("form", FORMS)
def test_compute_u_t_is_the_sum_of_the_terms(small, form):
    """compute_u_t is the sum of the window's terms' u(x, params, box), the
    host term's through its configured form's (the same bits): rowscan's
    F+U entry, or the dense form."""
    s = as_form(small["port32"][1], form)
    ctx = _ctx(s)
    x, box = (torch.as_tensor(a, dtype=torch.float32) for a in (s.x0, s.box0))
    assert ctx.compute_u_t() == float(sum(p.u(x, p.params, box) for p in ctx.potentials))
    assert [np.array_equal(p, q.params.numpy()) for p, q in zip(ctx.get_params(), s.potentials)] == [True] * len(TERMS)


@pytest.mark.parametrize("form", FORMS)
def test_step_equals_multiple_steps(small, form):
    """Three step() calls are one multiple_steps(3), bitwise, in each host
    form."""
    s = as_form(small["port32"][0], form)
    a, b = _ctx(s), _ctx(s)
    for _ in range(3):
        a.step()
    b.multiple_steps(3)
    assert _same_run(a, b)


def test_set_barostat_interval(small):
    """set_barostat_interval returns the previous interval and takes effect
    at once, keeping the barostat's state; without a barostat it returns
    None."""
    ctx = _ctx(small["port32"][0])
    baro, state0 = ctx.get_barostat()
    assert baro.interval == 25 and ctx.set_barostat_interval(2) == 25
    ctx.multiple_steps(6)
    assert int(ctx.get_barostat()[1].total_attempted) == 3 and int(state0.total_attempted) == 0
    assert ctx.set_barostat_interval(25) == 2 and ctx.get_barostat()[0].interval == 25
    s = small["port32"][0]
    bare = Context(s.x0, s.v0, s.box0, s.integrator, [], device="cpu")
    assert bare.set_barostat_interval(15) is None and bare.get_barostat() is None


@pytest.mark.parametrize("form", FORMS)
def test_reset_for_state_equals_a_fresh_context(small, form):
    """A window run in a Context reused from another window (after steps
    there) is bitwise the run of a fresh Context of that window: x, v, box
    and the barostat's state after 6 steps with the barostat every 3 (so
    its generator, reseeded from the new window's barostat seed, is drawn
    from). In the rowscan form the reset renews the lists built for the
    first window."""
    s0, s2 = (as_form(small["port32"][i], form) for i in (0, 2))
    assert s0.barostat.seed != s2.barostat.seed
    reused = _ctx(s0, 3)
    reused.multiple_steps(4)
    reused.reset_for_state(s2)
    fresh = _ctx(s2, 3)
    for c in (reused, fresh):
        c.multiple_steps(6)
    assert _same_run(reused, fresh)
    a, b = reused.get_barostat()[1], fresh.get_barostat()[1]
    assert torch.equal(a.volume_scale, b.volume_scale) and int(a.total_accepted) == int(b.total_accepted)
    assert int(a.total_attempted) == 2


@pytest.fixture(scope="module")
def jax_run(small):
    """JAX's run_sims_sequential over the three small windows: 3 frames 4
    steps apart, no equilibration (one runner to compile); its pair-BAR
    result, and its trajectories as the port's."""
    from timemachine_tpu.fe.free_energy import MDParams, run_sims_sequential

    md = MDParams(n_frames=3, n_eq_steps=0, steps_per_frame=4, seed=2023)
    result, trajs = run_sims_sequential(small["jax"], md, TEMP)
    return result, [tfe.Trajectory([np.asarray(f) for f in t.frames], list(t.boxes), None) for t in trajs]


def test_pair_bar_ulkns_match_jax(small, jax_run):
    """generate_pair_bar_ulkns on the frames of JAX's run against JAX's
    u_kln, per component: every exact-function term to 1e-10 of its largest
    |u|; the host term (the dense exact-erfc form in both) to HOST_REL
    (measured 1.5e-15), with its works exactly zero in both."""
    result, trajs = jax_run
    u = tfe.generate_pair_bar_ulkns(small["port"], trajs, TEMP)
    u_j = result.u_kln_by_component_by_lambda
    assert u.shape == u_j.shape == (2, len(TERMS), 2, 2, 3)
    for j in range(len(TERMS)):
        scale = max(np.abs(u_j[:, j]).max(), 1.0)
        assert np.abs(u[:, j] - u_j[:, j]).max() <= (HOST_REL if j == HOST else 1e-10) * scale, TERMS[j]
    for uk in (u, u_j):
        assert not (uk[:, HOST, 0, 1] - uk[:, HOST, 0, 0]).any() and not (uk[:, HOST, 1, 0] - uk[:, HOST, 1, 1]).any()


RSS_MD = tfe.MDParams(n_frames=2, n_eq_steps=2, steps_per_frame=2, seed=2023)


@pytest.fixture(scope="module", params=FORMS)
def port_runs(request, small):
    """Two runs of run_sims_sequential over the three small windows on the
    CPU in f32 (2 equilibration steps, 2 frames 2 steps apart), the host
    term in each of FORMS; the windows run, and the runs."""
    states = [as_form(s, request.param) for s in small["port32"]]
    return states, [tfe.run_sims_sequential(states, RSS_MD, TEMP) for _ in range(2)]


def test_run_sims_sequential_is_finite_and_repeats_bitwise(port_runs):
    """run_sims_sequential: finite ΔG and errors, the host term's works
    exactly zero, and a second run bitwise equal to the first (frames and
    u_kln)."""
    (res, trajs), (res2, trajs2) = port_runs[1]
    assert np.all(np.isfinite(res.dGs)) and np.all(np.isfinite(res.dG_errs))
    u = res.u_kln_by_component_by_lambda
    assert not (u[:, HOST, 0, 1] - u[:, HOST, 0, 0]).any()
    assert np.array_equal(u, res2.u_kln_by_component_by_lambda)
    for t, t2 in zip(trajs, trajs2):
        assert all(np.array_equal(a, b) for a, b in zip(list(t.frames) + t.boxes, list(t2.frames) + t2.boxes))


def test_sample_equals_the_reused_window(port_runs):
    """sample() of the last window, in a Context of its own and taking its
    frames one at a time, is bitwise the trajectory run_sims_sequential
    took for it in the Context reused from the first window (frames,
    boxes, final velocities and the barostat's volume scale)."""
    states, runs = port_runs
    t = tfe.sample(states[2], RSS_MD, max_buffer_frames=1)
    ref = runs[0][1][2]
    assert all(np.array_equal(a, b) for a, b in zip(list(t.frames) + t.boxes, list(ref.frames) + ref.boxes))
    assert np.array_equal(t.final_velocities, ref.final_velocities) and t.final_barostat_volume_scale_factor == ref.final_barostat_volume_scale_factor


# -- the cache's writer (python tests/test_torch_rbfe.py --write-cache) --------

CACHE_BOX_WIDTH, CACHE_HEADROOM, CACHE_SEED, CACHE_MIN_CUTOFF = 4.0, 0.1, 2023, 0.7
CACHE_LAMBDAS = np.linspace(0.0, 1.0, 12)


def build_cache_states():
    """The JAX package's solvent-leg states of the edge, as
    fe/rbfe.py run_solvent and estimate_relative_free_energy build them: a
    4.0 nm TIP3P box around both ligands plus 0.1 nm of headroom, the host
    pre-equilibrated, the 12-window linear grid minimized with min_cutoff
    0.7, seed 2023 (DEFAULT_MD_PARAMS'). Returns (states, metadata)."""
    _jax()
    from timemachine_tpu.fe.rbfe import DEFAULT_MD_PARAMS, AlchemicalEdge
    from timemachine_tpu.md import builders

    assert DEFAULT_MD_PARAMS.seed == CACHE_SEED
    t0 = time.perf_counter()
    mol_a, mol_b, core, ff = _edge_inputs()
    host_config = builders.build_water_system(CACHE_BOX_WIDTH, ff.water_ff, mols=[mol_a, mol_b])
    host_config.box += np.diag([CACHE_HEADROOM] * 3)
    edge = AlchemicalEdge.create(mol_a, mol_b, core, ff, host_config, "solvent", CACHE_SEED)
    states = edge.build_grid_states(CACHE_LAMBDAS, CACHE_MIN_CUTOFF)
    meta = dict(
        smiles=np.array(SMILES), names=np.array(NAMES), embed_seed=EMBED_SEED, seed=CACHE_SEED,
        box_width=CACHE_BOX_WIDTH, headroom=CACHE_HEADROOM, lambdas=CACHE_LAMBDAS, min_cutoff=CACHE_MIN_CUTOFF,
        core=np.asarray(core), conf_a=mol_a.get_conf(), conf_b=mol_b.get_conf(),
        build_seconds=time.perf_counter() - t0,
    )
    return states, meta


def _equal_across(values) -> bool:
    return all(v.shape == values[0].shape and np.array_equal(v, values[0]) for v in values)


def write_cache(states, meta, path=rbfe_solvent.CACHE):
    """The states' arrays in the layout testsystems/rbfe_solvent.py reads:
    potentials' arrays, x0 and box0 once under s_<key> where every window
    has the same, else per window under w_<key>; v0 as the seed it was
    drawn from where that redraw is bitwise the state's."""
    per = []
    for s in states:
        a = convert.host_guest_arrays(s)
        a["x0"], a["box0"] = np.asarray(s.x0), np.asarray(s.box0)
        per.append(a)
    out = {}
    for k in per[0]:
        vals = [np.asarray(a[k]) for a in per]
        out[("s_" if _equal_across(vals) else "w_") + k] = vals[0] if _equal_across(vals) else np.stack(vals)
    s0 = states[0]
    intg, baro = s0.integrator, s0.barostat
    masses = np.asarray(intg.masses)
    for s in states:
        assert np.array_equal(np.asarray(s.integrator.masses), masses) and s.barostat.interval == baro.interval
        assert len(s.barostat.group_idxs) == len(baro.group_idxs)
        assert all(np.array_equal(np.asarray(g), np.asarray(h)) for g, h in zip(s.barostat.group_idxs, baro.group_idxs))
    v0_seeds = []
    for s in states:
        seed = int(s.barostat.seed) - 1  # fe/rbfe.py: the barostat's seed is the velocities' + 1
        v0_seeds.append(seed if np.array_equal(sample_velocities(masses, intg.temperature, seed), np.asarray(s.v0)) else -1)
    if min(v0_seeds) < 0:
        out["w_v0"] = np.stack([np.asarray(s.v0) for s in states])
    groups = [np.asarray(g) for g in baro.group_idxs]
    interacting = [np.asarray(s.interacting_atoms) for s in states]
    out.update(
        lamb=np.array([s.lamb for s in states]),
        integrator_seed=np.array([s.integrator.seed for s in states]),
        barostat_seed=np.array([s.barostat.seed for s in states]),
        v0_seed=np.array(v0_seeds),
        temperature=float(intg.temperature), dt=float(intg.dt), friction=float(intg.friction), masses=masses,
        pressure=float(baro.pressure), barostat_interval=int(baro.interval),
        adaptive_scaling_enabled=bool(baro.adaptive_scaling_enabled),
        initial_volume_scale_factor=float(baro.initial_volume_scale_factor),
        group_sizes=np.array([len(g) for g in groups]), group_atoms=np.concatenate(groups),
        ligand_idxs=np.asarray(s0.ligand_idxs), protein_idxs=np.asarray(s0.protein_idxs),
        interacting_counts=np.array([len(i) for i in interacting]), interacting_atoms=np.concatenate(interacting),
        **{f"meta_{k}": v for k, v in meta.items()},
    )
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-cache" not in sys.argv:
        sys.exit("usage: python tests/test_torch_rbfe.py --write-cache")
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _jax().config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    cache_states, cache_meta = build_cache_states()
    write_cache(cache_states, cache_meta)
    print(f"wrote {rbfe_solvent.CACHE} ({cache_meta['build_seconds']:.0f} s to build the states)")
