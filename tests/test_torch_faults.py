"""The two API faults of the port against the JAX package, repaired.

Context.reset_for_state(initial_state, seed=None): with a seed, the
Langevin noise, the barostat's generator and the TIBD water sampler's are
reseeded from it as a state built with integrator seed `seed` seeds them
(ROADMAP P38): the run equals a fresh Context of that state, bitwise, and a
second reset with the same seed repeats it bitwise, while seed + 1 moves all
three generators elsewhere. Without a seed the run is the fresh Context of
the state itself, as before. A 1.6 nm water box whose nonbonded cutoff is
cut to 0.75 nm (the Context takes a box over twice the cutoff), 50 NPT
steps with a barostat move every 10 steps and the sampler firing every 25,
on the CPU in float64.

testsystems/dhfr.py: JAX's setup_dhfr (its native branch, OpenMM absent),
setup_dhfr_native in both atom orders and setup_dhfr_scale_waterbox (at
3,000 atoms) against the port's: conformer, box and masses exact, every
potential's indices and parameters exact, the host functions in JAX's order
and types.

And ROADMAP R15: both packages' get_biphenyl build the molecule without its
hydrogens, so AM1 refuses its 69 valence electrons and both fall back to
the same Gasteiger charges with the same warning.
"""

import warnings

import numpy as np
import pytest
import torch

from timemachine_torch.convert import host_system_arrays
from timemachine_torch.fe.free_energy import InitialState
from timemachine_torch.fe.system import HostSystem
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md import builders as tb
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.context import Context
from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove, water_sampler_seed
from timemachine_torch.testsystems import dhfr as tdhfr
from timemachine_tpu.testsystems import dhfr as jdhfr

torch.set_num_threads(1)  # the suite's workers share the host's cores

BOX, CUTOFF, N_STEPS, SEED = 1.6, 0.75, 50, 2031
BAROSTAT_INTERVAL, SAMPLER_INTERVAL = 10, 25


@pytest.fixture(scope="module")
def water():
    """A water box's state (integrator seed SEED, barostat seed SEED + 7) and
    a maker of Contexts over it with a barostat and the TIBD sampler."""
    hc = tb.build_water_system(BOX)
    n = hc.conf.shape[0]
    arrays = host_system_arrays(hc.host_system)
    arrays["cutoff"] = CUTOFF
    hs = HostSystem.from_arrays(arrays, device="cpu")
    pots = hs.get_U_fns()
    hs.nonbonded_all_pairs.configure(torch.as_tensor(hc.box), torch.as_tensor(hc.conf), kernel="dense")
    groups = [np.asarray(g) for g in hc.host_topology.group_idxs]
    intg = LangevinIntegrator(300.0, 1.5e-3, 1.0, hc.masses, SEED)
    baro = MonteCarloBarostat(n, 1.013, 300.0, groups, BAROSTAT_INTERVAL, SEED + 7)
    v0 = np.zeros((n, 3))
    state = InitialState(pots, intg, baro, hc.conf, v0, hc.box, 0.0, np.arange(3, dtype=np.int32),
                         np.array([], dtype=np.int32))
    params = np.asarray(hs.nonbonded_all_pairs.params)

    def sampler(seed):
        return TIBDExchangeMove(n_atoms=n, ligand_idxs=np.arange(3), water_idxs=list(np.arange(3, n).reshape(-1, 3)),
                                params=params, temperature=300.0, beta=2.0, cutoff=CUTOFF, radius=0.6, seed=seed,
                                n_proposals=20, interval=SAMPLER_INTERVAL)

    def context(integrator_seed, barostat_seed, sampler_seed):
        intg_k = LangevinIntegrator(300.0, 1.5e-3, 1.0, hc.masses, integrator_seed)
        baro_k = MonteCarloBarostat(n, 1.013, 300.0, groups, BAROSTAT_INTERVAL, barostat_seed)
        return Context(hc.conf, v0, hc.box, intg_k, pots, movers=[baro_k, sampler(sampler_seed)], device="cpu")

    return state, context


def _run(ctx):
    """x, box and the three generators' states after N_STEPS steps."""
    ctx.multiple_steps(N_STEPS)
    baro_state, sampler_state = ctx._mover_states
    return dict(
        x=ctx.get_x_t(), box=ctx.get_box(), noise=ctx._noise.get_state(),
        barostat=baro_state.generator.get_state(), sampler=sampler_state.generator.get_state(),
        accepted=int(sampler_state.n_accepted), proposed=int(sampler_state.n_proposed),
        barostat_attempts=int(baro_state.total_attempted),
    )


def _assert_bitwise(a, b):
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_reset_for_state_with_a_seed_reseeds_all_three_streams(water):
    state, context = water
    s = 4242
    ctx = context(1, 2, 3)  # seeds the reset must replace
    first = _run(ctx.reset_for_state(state, seed=s))
    again = _run(ctx.reset_for_state(state, seed=s))
    _assert_bitwise(first, again)
    assert first["barostat_attempts"] == N_STEPS // BAROSTAT_INTERVAL
    assert first["proposed"] == 20 * (N_STEPS // SAMPLER_INTERVAL)
    assert np.all(np.isfinite(first["x"]))
    # P38: the streams of a state whose integrator seed is s
    _assert_bitwise(first, _run(context(s, s + 1, water_sampler_seed(s))))
    other = _run(ctx.reset_for_state(state, seed=s + 1))
    for stream in ("noise", "barostat", "sampler"):
        assert not torch.equal(first[stream], other[stream]), stream
    assert not np.array_equal(first["x"], other["x"])


def test_reset_for_state_without_a_seed_is_the_fresh_context(water):
    state, context = water
    ctx = context(1, 2, 3)
    got = _run(ctx.reset_for_state(state))
    _assert_bitwise(got, _run(context(SEED, SEED + 7, water_sampler_seed(SEED))))


def test_reset_for_state_takes_jax_signature():
    import inspect

    from timemachine_tpu.md.context import Context as JContext

    t, j = inspect.signature(Context.reset_for_state), inspect.signature(JContext.reset_for_state)
    assert list(t.parameters) == list(j.parameters)
    assert t.parameters["seed"].default is j.parameters["seed"].default is None


def _assert_module_matches_bound(mod, bp):
    assert type(mod).__name__ == type(bp.potential).__name__
    np.testing.assert_array_equal(mod.params.numpy(), np.asarray(bp.params, np.float64))
    if type(mod).__name__ == "Nonbonded":
        exc, scales = mod._exclusions
        np.testing.assert_array_equal(exc, np.asarray(bp.potential.exclusion_idxs))
        np.testing.assert_array_equal(scales, np.asarray(bp.potential.scale_factors))
        assert (mod.beta, mod.cutoff) == (bp.potential.beta, bp.potential.cutoff)
    else:
        np.testing.assert_array_equal(mod.idxs.numpy(), np.asarray(bp.potential.idxs))


@pytest.mark.parametrize("waters_first", (False, True))
def test_setup_dhfr_native_matches_jax(waters_first):
    j = jdhfr.setup_dhfr_native(waters_first=waters_first)
    t = tdhfr.setup_dhfr_native(waters_first=waters_first, device="cpu")
    for k in ("conf", "box", "masses"):
        np.testing.assert_array_equal(getattr(t, k), np.asarray(getattr(j, k)), err_msg=k)
    assert t.num_water_atoms == j.num_water_atoms
    jfns, tfns = j.host_system.get_U_fns(), t.host_system.get_U_fns()
    assert len(jfns) == len(tfns)
    for mod, bp in zip(tfns, jfns):
        _assert_module_matches_bound(mod, bp)


def test_setup_dhfr_matches_jax():
    jfns, jmasses, jconf, jbox = jdhfr.setup_dhfr()
    tfns, tmasses, tconf, tbox = tdhfr.setup_dhfr(device="cpu")
    np.testing.assert_array_equal(tconf, np.asarray(jconf))
    np.testing.assert_array_equal(tbox, np.asarray(jbox))
    np.testing.assert_array_equal(tmasses, np.asarray(jmasses))
    assert [type(m).__name__ for m in tfns] == [type(bp.potential).__name__ for bp in jfns]
    for mod, bp in zip(tfns, jfns):
        _assert_module_matches_bound(mod, bp)


def test_setup_dhfr_scale_waterbox_matches_jax():
    j = jdhfr.setup_dhfr_scale_waterbox(n_atoms_target=3_000)
    t = tdhfr.setup_dhfr_scale_waterbox(n_atoms_target=3_000)
    for k in ("conf", "box", "masses"):
        np.testing.assert_array_equal(getattr(t, k), np.asarray(getattr(j, k)), err_msg=k)
    assert t.num_water_atoms == j.num_water_atoms
    jfns, tfns = j.host_system.get_U_fns(), t.host_system.get_U_fns()
    assert [type(bp.potential).__name__ for bp in tfns] == [type(bp.potential).__name__ for bp in jfns]
    for tbp, jbp in zip(tfns, jfns):
        np.testing.assert_array_equal(tbp.params.numpy(), np.asarray(jbp.params, np.float64))
        for field in ("idxs", "exclusion_idxs", "scale_factors"):
            if hasattr(jbp.potential, field):
                np.testing.assert_array_equal(getattr(tbp.potential, field), np.asarray(getattr(jbp.potential, field)))


def test_setup_dhfr_signatures_are_jax():
    import inspect

    for name in ("setup_dhfr", "setup_dhfr_native", "setup_dhfr_scale_waterbox"):
        t, j = inspect.signature(getattr(tdhfr, name)), inspect.signature(getattr(jdhfr, name))
        jp = list(j.parameters.values())
        tp = list(t.parameters.values())[: len(jp)]
        assert [p.name for p in tp] == [p.name for p in jp], name
        for a, b in zip(tp, jp):
            if a.name != "cache_path":  # JAX's default is its cache file or TM_DHFR_CACHE
                assert a.default == b.default, (name, a.name)


def test_biphenyl_is_built_without_hydrogens_in_both_packages():
    """R15: 15 heavy atoms; AM1 refuses 69 valence electrons; both packages
    warn GasteigerFallbackWarning and take the same Gasteiger charges."""
    from timemachine_torch.ff import Forcefield as TF
    from timemachine_torch.ff.handlers import GasteigerFallbackWarning as TWarning
    from timemachine_torch.testsystems.ligands import get_biphenyl as t_biphenyl
    from timemachine_tpu.ff import Forcefield as JF
    from timemachine_tpu.ff.handlers import GasteigerFallbackWarning as JWarning
    from timemachine_tpu.testsystems.ligands import get_biphenyl as j_biphenyl

    (jm, jt), (tm, tt) = j_biphenyl(), t_biphenyl()
    assert jm.num_atoms == tm.num_atoms == 15
    assert [a.atomic_num for a in tm.atoms] == [a.atomic_num for a in jm.atoms]
    assert all(a.atomic_num != 1 for a in tm.atoms)
    np.testing.assert_array_equal(np.asarray(tt), np.asarray(jt))
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jff = JF.load_default()
        jq = np.asarray(jff.q_handle.parameterize(jm), np.float64)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tff = TF.load_default()
        tq = np.asarray(torch.as_tensor(tff.q_handle.parameterize(tm)).detach(), np.float64)
    assert any(issubclass(w.category, JWarning) and "69 electrons" in str(w.message) for w in jw)
    assert any(issubclass(w.category, TWarning) and "69 electrons" in str(w.message) for w in tw)
    np.testing.assert_allclose(tq, jq, rtol=1e-12, atol=0)
