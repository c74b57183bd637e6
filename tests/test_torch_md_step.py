"""The port's single-system MD step as the JAX package's default runs it
(timemachine_torch/md/context.py): the four tiers with one shared
contribution plan, and the sorted-state step.

The system is tests/test_torch_assembly.py's crop of DHFR (744 atoms, 27
waters first, then the protein's atoms within 1.2 nm of its centroid, in
DHFR's box): bonded tails past the leading waters and an exclusion tail,
so every tier is live. Its nonbonded term runs the rowscan sweep's plain
PyTorch version here, in the main path's form (preshift, no w) or, with 12
protein atoms left out of the term, the masked form (minimum image, w).

What is held:
- the canonical step's force against JAX's canonical step (SORTED_MD off in
  both) in float64 within 1e-10 of its largest |value|: with both nonbonded
  terms dense (exact erfc; JAX's a grad-tier term), and the residual alone
  (grad, fused and plan tiers) with JAX's term on its Pallas rowscan
  provider in interpret mode and the port's on rowscan;
- the sorted step against the canonical step, bitwise in x, v, box and the
  stored frames over 60 steps at friction 1/ps, in one call and chunked
  17 + 43, across two list rebuilds (steps 20 and 40) and two barostat
  moves (after steps 24 and 49), in float32 as on the card;
- the sorted step declined exactly where JAX's is: Verlet, local MD, a
  mover that moves atoms nonlocally (the water sampler), a provider
  without a sorted protocol (kernel="gather"), and SORTED_MD off.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_assembly import dhfr_crop_arrays, jax_bound_potentials  # noqa: E402
from timemachine_torch import potentials as tp  # noqa: E402
from timemachine_torch.fe.model_utils import apply_hmr  # noqa: E402
from timemachine_torch.fe.system import HostSystem  # noqa: E402
from timemachine_torch.integrators import LangevinIntegrator, VelocityVerletIntegrator  # noqa: E402
from timemachine_torch.md import context as tctx  # noqa: E402
from timemachine_torch.md.barostat import MonteCarloBarostat  # noqa: E402
from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove  # noqa: E402
from timemachine_torch.md.utils import get_group_indices, sample_velocities  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores

F32, F64 = torch.float32, torch.float64
TEMP, DT, FRICTION = 300.0, 2.5e-3, 1.0
N_STEPS, CHUNKS, FRAME_EVERY = 60, (17, 43), 20
BAROSTAT_INTERVAL = 25
N_MASKED_OUT = 12  # protein atoms left out of the masked form's term
TOL_JAX = 1e-10


@pytest.fixture(scope="module")
def crop():
    a = dhfr_crop_arrays()
    masses = apply_hmr(a["masses"], a["bond_idxs"])
    groups = get_group_indices([tuple(map(int, b)) for b in a["bond_idxs"]], len(masses))
    return a, masses, groups, sample_velocities(masses, TEMP, seed=2029)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _potentials(a, dtype, kernel="rowscan", masked=False):
    """The crop's port potentials configured as asked; `masked` swaps in a
    term over all but the last N_MASKED_OUT atoms."""
    hs = HostSystem.from_arrays(a, device="cpu", dtype=dtype)
    pots = hs.get_U_fns()
    n = a["conf"].shape[0]
    if masked:
        pots[4] = tp.Nonbonded(
            n, a["excl_idxs"], a["excl_scales"], float(a["beta"]), float(a["cutoff"]), a["nb_params"],
            atom_idxs=np.arange(n - N_MASKED_OUT), device="cpu", dtype=dtype,
        )
    pots[4].configure(_t(a["box"], dtype), _t(a["conf"], dtype), kernel=kernel, rowscan_has_w=masked)
    return pots


def _context(crop, pots, sorted_md, monkeypatch, dtype=F32, movers=None, integrator=None):
    a, masses, groups, v0 = crop
    monkeypatch.setattr(tctx, "SORTED_MD", sorted_md)
    if movers is None:
        movers = [MonteCarloBarostat(len(masses), 1.013, TEMP, groups, BAROSTAT_INTERVAL, seed=2030)]
    integrator = integrator or LangevinIntegrator(TEMP, DT, FRICTION, masses, seed=2028)
    return tctx.Context(_t(a["conf"], dtype), v0, _t(a["box"], dtype), integrator, pots, movers=movers, device="cpu")


def _jax_context(a, jbps, monkeypatch):
    from timemachine_tpu.integrators import LangevinIntegrator as JLangevin
    from timemachine_tpu.md.context import Context as JContext

    monkeypatch.setenv("TM_SORTED_MD", "0")
    ctx = JContext(a["conf"], np.zeros_like(a["conf"]), a["box"], JLangevin(TEMP, DT, FRICTION, a["masses"], 1), jbps)
    ctx._make_step_fn()
    assert ctx._sorted_machinery is None
    return ctx


def _close(port, ref, tol=TOL_JAX):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert np.abs(port - ref).max() <= tol * np.abs(ref).max(), (np.abs(port - ref).max(), np.abs(ref).max())


def test_canonical_step_force_matches_jax_dense(crop, monkeypatch):
    """The canonical step's force (the dense provider plus residual_force:
    the bonded waters' strided forces and the protein's bonded tails through
    the plan) against JAX's canonical step force, whose dense nonbonded term
    is a grad-tier term, within 1e-10."""
    a = crop[0]
    ctx = _context(crop, _potentials(a, F64, kernel="dense"), False, monkeypatch, dtype=F64)
    assert sorted(ctx._providers) == [4] and [i for i, _ in ctx._contrib_entries] == [0, 1, 2, 3]
    assert ctx._fused == [] and ctx._grad == [] and ctx._sorted_info is None
    ctx._ensure_lists()
    x, box = _t(a["conf"]), _t(a["box"])
    force = ctx._force(x, box, 1)
    jbps = jax_bound_potentials(a, impl="dense")
    jctx = _jax_context(a, jbps, monkeypatch)
    params = [jnp.asarray(bp.params) for bp in jbps]
    ref = jax.jit(lambda xx: jctx._residual_force(xx, jnp.asarray(a["box"]), params))(jnp.asarray(a["conf"]))
    _close(force, ref)


def test_residual_force_matches_jax_rowscan(crop, monkeypatch):
    """With the nonbonded term on its rowscan provider in both packages
    (JAX's Pallas kernel in interpret mode, never called here), the split
    puts the exclusion tail into the one plan in both: residual_force (the
    bonded tails, the waters' strided forces and the exclusion tail) within
    1e-10 of JAX's."""
    a = crop[0]
    ctx = _context(crop, _potentials(a, F64), False, monkeypatch, dtype=F64)
    assert [i for i, _ in ctx._contrib_entries] == [0, 1, 2, 3, 4] and ctx._sorted_info is None
    x, box = _t(a["conf"]), _t(a["box"])
    jbps = jax_bound_potentials(a)
    jbps[4].potential.configure_pallas(a["box"], a["conf"], interpret=True, rowscan_has_w=False)
    jctx = _jax_context(a, jbps, monkeypatch)
    params = [jnp.asarray(bp.params) for bp in jbps]
    ref = jax.jit(lambda xx: jctx._residual_force(xx, jnp.asarray(a["box"]), params))(jnp.asarray(a["conf"]))
    _close(ctx.residual_force(x, box), ref)


def _run(ctx, chunks):
    frames = [ctx.multiple_steps(n, store_x_interval=FRAME_EVERY)[0] for n in chunks]
    return np.concatenate(frames), ctx.get_x_t(), ctx.get_v_t(), ctx.get_box(), ctx.get_mover_states()[0]


@pytest.fixture(scope="module", params=["main", "masked"])
def runs(crop, request):
    """The canonical run, the sorted run in one call and chunked, of one form."""
    masked = request.param == "masked"
    pots = _potentials(crop[0], F32, masked=masked)
    assert pots[4].md_preshift != masked
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, sorted_md, chunks in (("canonical", False, (N_STEPS,)), ("sorted", True, (N_STEPS,)), ("chunked", True, CHUNKS)):
            ctx = _context(crop, pots, sorted_md, mp)
            assert (ctx._sorted_info is not None) == sorted_md
            out[name] = _run(ctx, chunks)
    return out


def test_sorted_step_is_bitwise_the_canonical_step(runs):
    """x, v and box after 60 steps, in one call and in two, bitwise the
    canonical run's; the barostat moved twice and accepted the same moves."""
    canonical = runs["canonical"]
    assert np.isfinite(canonical[1]).all() and np.isfinite(canonical[2]).all()
    for name in ("sorted", "chunked"):
        for k in (1, 2, 3):
            np.testing.assert_array_equal(runs[name][k], canonical[k])
        st, ref = runs[name][4], canonical[4]
        assert int(st.total_attempted) == int(ref.total_attempted) == N_STEPS // BAROSTAT_INTERVAL
        assert int(st.total_accepted) == int(ref.total_accepted)
    assert not np.array_equal(canonical[3], np.asarray(dhfr_crop_arrays()["box"], np.float32))  # a move was accepted


def test_sorted_frames_are_canonical(runs):
    """The stored frames are in canonical atom order, bitwise the canonical
    run's, and the last is get_x_t."""
    frames = runs["sorted"][0]
    assert frames.shape[0] == N_STEPS // FRAME_EVERY
    np.testing.assert_array_equal(frames, runs["canonical"][0])
    np.testing.assert_array_equal(frames[-1], runs["sorted"][1])


def test_sorted_step_is_declined_where_jax_declines(crop, monkeypatch):
    """No sorted step under Verlet, with a nonlocal mover (the water
    sampler), with kernel="gather" or with SORTED_MD off; local MD runs the
    canonical step (it never enters the sorted one)."""
    a, masses, groups, _ = crop
    pots = _potentials(a, F32)
    assert _context(crop, pots, True, monkeypatch)._sorted_info is not None
    assert _context(crop, pots, False, monkeypatch)._sorted_info is None
    verlet = VelocityVerletIntegrator(DT, masses)
    assert _context(crop, pots, True, monkeypatch, movers=[], integrator=verlet)._sorted_info is None
    n_w = int(a["num_water_atoms"])
    sampler = TIBDExchangeMove(
        len(masses), np.arange(n_w, n_w + 5), np.arange(n_w).reshape(-1, 3), a["nb_params"], TEMP,
        float(a["beta"]), float(a["cutoff"]), 0.7, seed=3,
    )
    assert _context(crop, pots, True, monkeypatch, movers=[sampler])._sorted_info is None
    assert _context(crop, _potentials(a, F32, kernel="gather"), True, monkeypatch)._sorted_info is None

    ctx = _context(crop, pots, True, monkeypatch, movers=[])

    def refuse(*args):
        raise AssertionError("local MD entered the sorted step")

    monkeypatch.setattr(ctx, "_sorted_step", refuse)
    ctx.multiple_steps_local(3, np.arange(n_w, len(masses)), seed=4)
    assert ctx._step == 3 and np.isfinite(ctx.get_x_t()).all()
