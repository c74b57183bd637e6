"""Local MD of the port (timemachine_torch/md/context.py
multiple_steps_local, multiple_steps_local_selection, local_restraint; the
local branch of fe/free_energy.py sample_with_context_iter and its
time-multiplexed HREX driver; integrators.py coefficients(free_mask);
potentials.py FlatBottomBond, LogFlatBottomBond) against timemachine_tpu.

The water box is the JAX package's build_water_system(2.5) (1,560 atoms),
relaxed by 50 of its FIRE steps, HMR masses, the host term in the dense form
(the CPU's), run in float32 on the CPU. The ports of tests/test_local_md.py
keep its checks at fewer steps (20 where it takes 50, 10 where it takes 25,
frames of 10 where it takes 20).

Tolerances (stated per test): the selection (reference index and free mask)
bitwise JAX's for the same float64 x and seed; the restraint's energy and
force against JAX's inline restraint (md/context.py u_restraint, its force
taken from JAX's own local runner) to 1e-12 relative in float64; the
flat-bottom terms to 1e-12 relative; the time-multiplexed driver's seeds
equal to JAX's, and its runs bitwise on repeat.
"""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_rbfe import small  # noqa: E402, F401  (the fixture)
from timemachine_torch import convert  # noqa: E402
from timemachine_torch import potentials as tp  # noqa: E402
from timemachine_torch.constants import BOLTZ  # noqa: E402
from timemachine_torch.fe import free_energy as tfe  # noqa: E402
from timemachine_torch.integrators import LangevinIntegrator  # noqa: E402
from timemachine_torch.md.context import Context  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores

F32, F64 = torch.float32, torch.float64
REL = 1e-12
LIGAND_LIKE = np.array([0, 1, 2], dtype=np.int32)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


@pytest.fixture(scope="module")
def water():
    """(x0 relaxed, box, HMR masses, the JAX HostConfig)."""
    jax = _jax()
    import jax.numpy as jnp

    from timemachine_tpu.fe.model_utils import apply_hmr
    from timemachine_tpu.md.builders import build_water_system
    from timemachine_tpu.md.fire import FireMinimizationConfig, fire_minimize_jax

    hc = build_water_system(2.5)
    bps = hc.host_system.get_U_fns()
    box = jnp.asarray(hc.box)
    force = jax.jit(lambda x: -jax.grad(lambda xx: sum(bp(xx, box) for bp in bps))(x))
    x0 = np.array(fire_minimize_jax(jnp.asarray(hc.conf), force, FireMinimizationConfig(50)))
    masses = np.asarray(apply_hmr(hc.masses, hc.host_system.bond.potential.idxs))
    return dict(x0=x0, box=np.asarray(hc.box), masses=masses, cfg=hc)


def _context(water, dtype=F32, kernel="dense", seed=4):
    cfg = convert.host_config_from_jax(water["cfg"], device="cpu", dtype=dtype)
    bps = cfg.host_system.get_U_fns()
    x0 = torch.as_tensor(water["x0"], dtype=dtype)
    box = torch.as_tensor(water["box"], dtype=dtype)
    for p in bps:
        if isinstance(p, tp.NonbondedAllPairs):
            p.configure(box, x0, kernel=kernel)
    intg = LangevinIntegrator(300.0, 2.5e-3, 1.0, water["masses"], seed)
    return Context(x0, np.zeros_like(water["x0"]), water["box"], intg, bps, device="cpu")


def _dist_from(x, box, i):
    diff = x - x[i]
    box_diag = np.diagonal(box)
    diff -= box_diag * np.floor(diff / box_diag + 0.5)
    return np.linalg.norm(diff, axis=1)


# -- ports of tests/test_local_md.py --------------------------------------------------


def test_local_md_freezes_far_atoms(water):
    """A local region moves, nothing beyond 1.5 nm of the reference moves, the
    reference (the seeded choice) is frozen, one frame back; 20 steps."""
    ctxt = _context(water)
    ctxt.setup_local_md(300.0, freeze_reference=True)
    x_before = ctxt.get_x_t()
    frames, boxes = ctxt.multiple_steps_local(20, LIGAND_LIKE, k=10_000.0, radius=0.5, seed=5)
    x_after = ctxt.get_x_t()
    assert frames.shape == (1, x_before.shape[0], 3) and boxes.shape == (1, 3, 3)
    moved = np.linalg.norm(x_after - x_before, axis=1)
    assert (moved > 0).sum() > 3
    assert (moved[_dist_from(x_before, water["box"], 0) > 1.5] == 0).all()
    ref = LIGAND_LIKE[np.random.default_rng(5).integers(3)]
    assert moved[ref] == 0.0


def test_local_md_deterministic(water):
    """Two fresh Contexts, the same seed: x, v bitwise equal after 10 local steps."""
    results = []
    for _ in range(2):
        ctxt = _context(water)
        ctxt.multiple_steps_local(10, LIGAND_LIKE, k=10_000.0, radius=0.5, seed=7)
        results.append((ctxt.get_x_t(), ctxt.get_v_t()))
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def test_local_md_selection_varies_with_seed(water):
    """Different seeds pick different references and regions; 10 steps each."""
    ctxt = _context(water)
    x0 = ctxt.get_x_t()
    ctxt.multiple_steps_local(10, np.arange(30, dtype=np.int32), k=10_000.0, radius=0.5, seed=1)
    x1 = ctxt.get_x_t()
    ctxt2 = _context(water)
    ctxt2.multiple_steps_local(10, np.arange(30, dtype=np.int32), k=10_000.0, radius=0.5, seed=2)
    assert not np.array_equal(x1, ctxt2.get_x_t())
    assert not np.array_equal(x0, x1)


def test_local_md_free_reference(water):
    """freeze_reference=False: the reference moves, tethered by the
    log-complement restraint on the frozen shell; everything finite in
    float32; nothing beyond 1.5 nm moves; 20 steps."""
    ctxt = _context(water)
    x_before = ctxt.get_x_t()
    ctxt.multiple_steps_local(20, LIGAND_LIKE, k=10_000.0, radius=0.5, seed=5, freeze_reference=False)
    x_after = ctxt.get_x_t()
    moved = np.linalg.norm(x_after - x_before, axis=1)
    ref = LIGAND_LIKE[np.random.default_rng(5).integers(3)]
    assert moved[ref] > 0.0
    assert np.isfinite(x_after).all() and np.isfinite(ctxt.get_v_t()).all()
    assert (moved[_dist_from(x_before, water["box"], ref) > 1.5] == 0).all()


def test_sample_with_local_md_params(water):
    """LocalMDParams through sample_with_context_iter: 3 finite frames of the
    box's atoms (frames of 10 steps, the last 5 local)."""
    ctxt = _context(water)
    md_params = tfe.MDParams(
        n_frames=3, n_eq_steps=0, steps_per_frame=10, seed=3,
        local_md_params=tfe.LocalMDParams(local_steps=5, k=10_000.0, min_radius=0.4, max_radius=0.6),
    )
    batches = list(tfe.sample_with_context_iter(ctxt, md_params, 300.0, LIGAND_LIKE, batch_size=3))
    coords = np.concatenate([b[0] for b in batches])
    assert coords.shape == (3, water["x0"].shape[0], 3) and np.isfinite(coords).all()
    assert ctxt._step == 30


def test_local_md_explicit_selection(water):
    """multiple_steps_local_selection: only the chosen atoms move, the
    reference and everything else bitwise unmoved, the free atoms within
    radius + 0.3 nm of the reference; 20 steps, a frame every 10."""
    ctxt = _context(water)
    x_before = ctxt.get_x_t()
    order = np.argsort(_dist_from(x_before, water["box"], 0))
    sel = np.array([i for i in order if i not in (0, 1, 2)][:6], dtype=np.int32)
    frames, _ = ctxt.multiple_steps_local_selection(20, 0, sel, store_x_interval=10, radius=0.5, k=10_000.0)
    assert frames.shape == (2, x_before.shape[0], 3)
    x_after = ctxt.get_x_t()
    moved = np.linalg.norm(x_after - x_before, axis=1)
    assert (moved[sel] > 0).all()
    assert (moved[np.setdiff1d(np.arange(x_before.shape[0]), sel)] == 0).all()
    assert moved[0] == 0.0
    diff_a = x_after[sel] - x_before[0]
    box_diag = np.diagonal(water["box"])
    diff_a -= box_diag * np.floor(diff_a / box_diag + 0.5)
    assert (np.linalg.norm(diff_a, axis=1) < 0.5 + 0.3).all()


def test_local_md_selection_validation(water):
    ctxt = _context(water)
    with pytest.raises(ValueError, match="reference_idx"):
        ctxt.multiple_steps_local_selection(10, 0, np.array([0, 4, 5]))
    with pytest.raises(ValueError, match="out of range"):
        ctxt.multiple_steps_local_selection(10, 0, np.array([10**6]))


# -- the port against JAX -----------------------------------------------------------------


@pytest.mark.parametrize("freeze_reference", [True, False])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_selection_is_bitwise_jax(water, seed, freeze_reference):
    """The reference index and the free mask of multiple_steps_local equal
    JAX's (its _run_local's arguments, captured) for the same float64 x,
    box and seed, at radius 0.5 and 0.8 nm and a temperature argument of
    None and 350 K."""
    from timemachine_tpu.integrators import LangevinIntegrator as JL
    from timemachine_tpu.md.context import Context as JContext

    x, box = water["x0"], water["box"]
    jctx = JContext(x, np.zeros_like(x), box, JL(300.0, 2.5e-3, 1.0, water["masses"], 4), [])
    captured = []
    jctx._run_local = lambda n, ref, free, *args: captured.append((ref, np.asarray(free)))
    ctxt = Context(x, np.zeros_like(x), box, LangevinIntegrator(300.0, 2.5e-3, 1.0, water["masses"], 4), [], device="cpu")
    idxs = np.arange(40, dtype=np.int32)
    for radius, temperature in ((0.5, None), (0.8, 350.0)):
        jctx.multiple_steps_local(10, idxs, k=10_000.0, radius=radius, seed=seed, temperature=temperature,
                                  freeze_reference=freeze_reference)
        ref, free = ctxt.local_selection(idxs, 10_000.0, radius, seed, temperature, freeze_reference)
        j_ref, j_free = captured[-1]
        assert ref == j_ref
        np.testing.assert_array_equal(free.astype(np.float64), j_free)
        assert 3 < free.sum() < len(free)


def _jax_restraint(x, box, ref, free, k, radius, freeze_reference, temperature):
    """(u, force) of JAX's local restraint in float64: the energy by the
    inline u_restraint of timemachine_tpu/md/context.py, transcribed; the
    force from JAX's own local runner (its total_force over no potentials)."""
    jax = _jax()
    import jax.numpy as jnp

    from timemachine_tpu.integrators import LangevinIntegrator as JL
    from timemachine_tpu.md.context import Context as JContext
    from timemachine_tpu.ops.pbc import lifted_distance_on_pairs

    n = x.shape[0]
    jctx = JContext(x, np.zeros_like(x), box, JL(temperature, 2.5e-3, 1.0, np.full(n, 12.0), 1), [])
    jctx.setup_local_md(temperature, freeze_reference)
    run = jctx._get_local_runner(1, 1, freeze_reference)
    step_fn = inspect.getclosurevars(run.__wrapped__).nonlocals["step_fn"]
    total_force = inspect.getclosurevars(step_fn).nonlocals["total_force"]
    free = jnp.asarray(free, dtype=jnp.float64)
    force = np.asarray(total_force(jnp.asarray(x), jnp.asarray(box), [], ref, free, k, radius))
    inv_kT = 1.0 / (BOLTZ * temperature)

    def u_restraint(xx):
        d = lifted_distance_on_pairs(xx[ref][None, :].repeat(xx.shape[0], 0), xx, jnp.asarray(box))
        over = jnp.maximum(d - radius, 0.0)
        u_fb = (k / 4.0) * over**4
        u = jnp.sum(free * u_fb)
        if not freeze_reference:
            is_self = jnp.arange(xx.shape[0]) == ref
            frozen = (1.0 - free) * (1.0 - is_self.astype(xx.dtype))
            log_term = -jnp.log1p(-jnp.exp(-inv_kT * u_fb) * (1.0 - 1e-12))
            u = u + jnp.sum(frozen * log_term) / inv_kT
        return u

    u, g = jax.value_and_grad(u_restraint)(jnp.asarray(x))
    assert np.abs(-np.asarray(g) - force).max() <= REL * np.abs(force).max()  # the transcription is JAX's runner's
    return float(u), force


@pytest.mark.parametrize("freeze_reference", [True, False])
def test_restraint_matches_jax(water, freeze_reference):
    """local_restraint against JAX's at a selection of the relaxed box
    (radius 0.5 nm, k 1e4, 300 K) with the region's atoms moved 0.1-0.3 nm
    out: energy and force to 1e-12 relative in float64. In float32 the
    port's are finite and equal the float64 ones at the rounded x to 1e-12
    (the restraint runs in float64); JAX's expression in float32 is +inf
    there (1 - 1e-12 rounds to 1) in the free-reference mode."""
    x, box = water["x0"].copy(), water["box"]
    ctxt = Context(x, np.zeros_like(x), box, LangevinIntegrator(300.0, 2.5e-3, 1.0, water["masses"], 4), [], device="cpu")
    ctxt.setup_local_md(300.0, freeze_reference)
    ref, free = ctxt.local_selection(np.arange(20, dtype=np.int32), 10_000.0, 0.5, 3, None, freeze_reference)
    rng = np.random.default_rng(8)
    near = np.flatnonzero(_dist_from(x, box, ref) < 0.8)
    x[near] += rng.uniform(-0.3, 0.3, (len(near), 3))  # some free atoms past the radius, some frozen ones inside it
    u_j, f_j = _jax_restraint(x, box, ref, free, 10_000.0, 0.5, freeze_reference, 300.0)
    u, f = ctxt.local_restraint(torch.as_tensor(x), torch.as_tensor(box), ref, torch.as_tensor(free), 10_000.0, 0.5,
                                freeze_reference)
    assert abs(float(u) - u_j) <= REL * abs(u_j) and u_j > 0
    assert np.abs(f.numpy() - f_j).max() <= REL * np.abs(f_j).max()
    x32, box32 = torch.as_tensor(x, dtype=F32), torch.as_tensor(box, dtype=F32)
    u32, f32 = ctxt.local_restraint(x32, box32, ref, torch.as_tensor(free), 10_000.0, 0.5, freeze_reference)
    u64, f64 = ctxt.local_restraint(x32.to(F64), box32.to(F64), ref, torch.as_tensor(free), 10_000.0, 0.5, freeze_reference)
    assert torch.isfinite(f32).all() and np.isfinite(float(u32))
    assert float(u32) == float(u64) and torch.equal(f32, f64)
    if not freeze_reference:
        import jax.numpy as jnp

        inside = jnp.float32(0.0)
        assert np.isposinf(float(-jnp.log1p(-jnp.exp(-inside) * jnp.float32(1.0 - 1e-12))))


def test_local_segment_rebuilds_lists_and_drops_them(water):
    """With the host term in the rowscan form (the card's), a local segment of
    25 steps from step 10 rebuilds the lists at step 20, inside it (the
    provider's schedule on the Context's running step count), the step count
    advances by 25, no mover fires, and the lists are dropped afterwards so
    that the next multiple_steps builds afresh."""
    ctxt = _context(water, kernel="rowscan")
    ctxt.multiple_steps(10)
    i = next(iter(ctxt._providers))
    init, apply, *rest = ctxt._providers[i]
    builds, calls = [], []

    def counting_init(x, box):
        builds.append(ctxt._step)
        return init(x, box)

    def counting_apply(state, x, box, t):
        f, new = apply(state, x, box, t)
        calls.append((t, new is not state))
        return f, new

    ctxt._providers[i] = (counting_init, counting_apply, *rest)
    ctxt.multiple_steps_local(25, LIGAND_LIKE, k=10_000.0, radius=0.5, seed=2)
    assert ctxt._step == 35 and ctxt._prov_states is None
    assert [t for t, _ in calls] == list(range(10, 35))
    assert [t for t, rebuilt in calls if rebuilt] == [20]  # REBUILD_INTERVAL 20
    assert builds == []  # local MD continues the lists multiple_steps kept
    ctxt.multiple_steps(1)
    assert builds == [35]


def test_coefficients_free_mask_matches_jax():
    """LangevinIntegrator.coefficients(free_mask) equals JAX's, bitwise."""
    from timemachine_tpu.integrators import LangevinIntegrator as JL

    masses = np.random.default_rng(1).uniform(1.0, 16.0, 9)
    free = np.array([1, 0, 1, 1, 0, 0, 1, 1, 0], dtype=np.float64)
    for mask in (None, free):
        for a, b in zip(LangevinIntegrator(300.0, 2.5e-3, 1.0, masses, 0).coefficients(mask),
                        JL(300.0, 2.5e-3, 1.0, masses, 0).coefficients(mask)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("cls", ["FlatBottomBond", "LogFlatBottomBond"])
def test_flat_bottom_terms_match_jax(cls):
    """FlatBottomBond and LogFlatBottomBond on 12 pairs of numpy-made points
    in a 2 nm box (some across its faces, some below r_min, some beyond
    r_max; the log term only where U_fb > 0, as it is +inf at 0): energy and
    force against the JAX terms to 1e-12 relative in float64; neither is
    flagged rigid-invariant."""
    jax = _jax()
    import jax.numpy as jnp

    from timemachine_tpu import potentials as jp

    rng = np.random.default_rng(3)
    x = rng.uniform(0, 2.0, (16, 3))
    idxs = np.array([rng.choice(16, 2, replace=False) for _ in range(12)])
    box = np.eye(3) * 2.0
    d = x[idxs[:, 0]] - x[idxs[:, 1]]
    d -= 2.0 * np.floor(d / 2.0 + 0.5)
    r = np.linalg.norm(d, axis=1)
    lo = np.where(np.arange(12) % 2 == 0, r + 0.05, 0.0)  # even pairs below r_min
    hi = np.where(np.arange(12) % 2 == 0, r + 0.3, r - 0.05)  # odd pairs beyond r_max
    params = np.stack([rng.uniform(100.0, 1000.0, 12), lo, hi], 1)
    beta = 1.0 / (BOLTZ * 300.0)
    if cls == "FlatBottomBond":
        pot, jpot = tp.FlatBottomBond(idxs, params, 16, device="cpu"), jp.FlatBottomBond(idxs)
    else:
        pot, jpot = tp.LogFlatBottomBond(idxs, params, beta, 16, device="cpu"), jp.LogFlatBottomBond(idxs, beta)
    assert not pot.rigid_group_invariant and not getattr(jpot, "rigid_group_invariant", False)
    u_j, g_j = jax.value_and_grad(lambda xx: jpot(xx, jnp.asarray(params), jnp.asarray(box)))(jnp.asarray(x))
    u, f = pot.energy_force(torch.as_tensor(x), torch.as_tensor(box))
    assert abs(float(u) - float(u_j)) <= REL * abs(float(u_j))
    assert float(pot.u(torch.as_tensor(x), pot.params, torch.as_tensor(box))) == pytest.approx(float(u_j), rel=REL)
    assert np.abs(f.numpy() + np.asarray(g_j)).max() <= REL * np.abs(np.asarray(g_j)).max()


class _RecordingContext:
    """Stands in for a Context: records the calls sample_with_context_iter makes."""

    def __init__(self, n_atoms):
        self.calls, self.x = [], np.zeros((n_atoms, 3))

    def set_barostat_interval(self, interval):
        self.calls.append(("set_barostat_interval", interval))
        return None

    def multiple_steps(self, n_steps, store_x_interval=0):
        self.calls.append(("multiple_steps", n_steps, store_x_interval))
        n = n_steps // store_x_interval if store_x_interval else 1
        return np.zeros((n, *self.x.shape)), np.zeros((n, 3, 3))

    def multiple_steps_local(self, n_steps, idxs, **kwargs):
        self.calls.append(("multiple_steps_local", n_steps, tuple(np.asarray(idxs).tolist()), tuple(sorted(kwargs.items()))))
        return np.zeros((1, *self.x.shape)), np.zeros((1, 3, 3))

    def get_x_t(self):
        return self.x

    def get_v_t(self):
        return self.x


@pytest.mark.parametrize("freeze_reference", [True, False])
def test_sample_with_context_iter_local_calls_match_jax(freeze_reference):
    """sample_with_context_iter with local MD makes JAX's calls: the global
    steps of each frame, then multiple_steps_local with the same radius and
    seed (drawn from default_rng(md_params.seed)), k, temperature and mode, in
    batches of 2 frames out of 5."""
    from timemachine_tpu.fe import free_energy as jfe

    local = dict(local_steps=7, k=2_000.0, min_radius=0.4, max_radius=1.3, freeze_reference=freeze_reference)
    md = dict(n_frames=5, n_eq_steps=30, steps_per_frame=20, seed=2029)
    t_md = tfe.MDParams(**md, local_md_params=tfe.LocalMDParams(**local))
    j_md = jfe.MDParams(**md, local_md_params=jfe.LocalMDParams(**local))
    lig = np.array([3, 4, 5])
    ctx_t, ctx_j = _RecordingContext(6), _RecordingContext(6)
    out_t = list(tfe.sample_with_context_iter(ctx_t, t_md, 310.0, lig, 2))
    out_j = list(jfe.sample_with_context_iter(ctx_j, j_md, 310.0, lig, 2))
    assert ctx_t.calls == ctx_j.calls
    assert [len(b[0]) for b in out_t] == [len(b[0]) for b in out_j] == [2, 2, 1]
    assert sum(c[0] == "multiple_steps_local" for c in ctx_t.calls) == 5


def test_md_params_local_assert():
    """MDParams refuses local_steps beyond steps_per_frame, LocalMDParams JAX's bounds."""
    with pytest.raises(AssertionError):
        tfe.MDParams(n_frames=1, n_eq_steps=0, steps_per_frame=5, seed=1, local_md_params=tfe.LocalMDParams(6))
    for kw in (dict(min_radius=0.05), dict(min_radius=2.0, max_radius=1.0), dict(k=0.5), dict(local_steps=0)):
        with pytest.raises(AssertionError):
            tfe.LocalMDParams(**{"local_steps": 5, **kw})


# -- HREX with local MD: the time-multiplexed driver --------------------------------------------------


def _harmonic_states(lamb_pkg):
    """JAX's tests/test_free_energy.py make_harmonic_state (two bonded atoms,
    λ scales the force constant) in both packages."""
    from timemachine_tpu.fe import free_energy as jfe
    from timemachine_tpu.integrators import LangevinIntegrator as JL
    from timemachine_tpu.potentials import BoundPotential, HarmonicBond

    x0 = np.array([[0.0, 0, 0], [0.12, 0, 0]])
    out = {"jax": [], "port": []}
    for lamb in lamb_pkg:
        params = np.array([[20000.0 * (1.0 + lamb), 0.11]])
        idxs = np.array([[0, 1]], dtype=np.int32)
        common = (x0, np.zeros_like(x0), np.eye(3) * 10.0, lamb, np.array([0], dtype=np.int32), np.array([], dtype=np.int32))
        out["jax"].append(jfe.InitialState([BoundPotential(HarmonicBond(idxs), params)],
                                           JL(300.0, 1.5e-3, 1.0, np.array([12.0, 12.0]), 5), None, *common))
        out["port"].append(tfe.InitialState([tp.HarmonicBond(idxs, params, 2, device="cpu")],
                                            LangevinIntegrator(300.0, 1.5e-3, 1.0, np.array([12.0, 12.0]), 5), None, *common))
    return out


@pytest.mark.parametrize("n_states", [2, 3])
def test_time_multiplexed_seeds_match_jax(n_states, monkeypatch):
    """run_sims_hrex with local MD on JAX's two-atom harmonic states (its
    test_run_sims_hrex_local_md_fallback, and a third state): each replica
    segment's MDParams seed (seed + state * n_frames + frame), n_eq_steps
    (at frame 0 only), the swap batches' seeds (seed + frame + 1) and neighbour
    pairs (the identity pair added at K = 2) equal JAX's; full trajectories and
    diagnostics with the identity pair stripped."""
    from timemachine_tpu.fe import free_energy as jfe
    from timemachine_tpu.md import hrex as jh
    from timemachine_torch.md import hrex as th

    states = _harmonic_states((0.0, 1.0) if n_states == 2 else (0.0, 0.5, 1.0))
    seen = {"jax": [], "port": []}

    def spy_iter(pkg, fn):
        def wrapper(ctxt, md_params, *args, **kwargs):
            seen[pkg].append(("segment", md_params.seed, md_params.n_eq_steps, md_params.n_frames))
            return fn(ctxt, md_params, *args, **kwargs)

        return wrapper

    def spy_swaps(pkg, fn):
        def wrapper(self, neighbor_pairs, log_q_kl, n_swap_attempts, seed):
            seen[pkg].append(("swaps", seed, n_swap_attempts, [tuple(p) for p in neighbor_pairs]))
            return fn(self, neighbor_pairs, log_q_kl, n_swap_attempts, seed)

        return wrapper

    monkeypatch.setattr(jfe, "sample_with_context_iter", spy_iter("jax", jfe.sample_with_context_iter))
    monkeypatch.setattr(tfe, "sample_with_context_iter", spy_iter("port", tfe.sample_with_context_iter))
    monkeypatch.setattr(jh.HREX, "attempt_neighbor_swaps_fast", spy_swaps("jax", jh.HREX.attempt_neighbor_swaps_fast))
    monkeypatch.setattr(th.HREX, "attempt_neighbor_swaps_fast", spy_swaps("port", th.HREX.attempt_neighbor_swaps_fast))
    md = dict(n_frames=4, n_eq_steps=20, steps_per_frame=10, seed=8)
    local = dict(local_steps=5, k=10_000.0, min_radius=0.3, max_radius=0.5)
    j_md = jfe.MDParams(**md, hrex_params=jfe.HREXParams(n_frames_bisection=2), local_md_params=jfe.LocalMDParams(**local))
    t_md = tfe.MDParams(**md, hrex_params=tfe.HREXParams(n_frames_bisection=2), local_md_params=tfe.LocalMDParams(**local))
    jfe.run_sims_hrex(states["jax"], j_md, print_diagnostics_interval=None)
    pair_bar, trajs, diag, water = tfe.run_sims_hrex(states["port"], t_md, print_diagnostics_interval=None)
    assert seen["port"] == seen["jax"]
    assert len([s for s in seen["port"] if s[0] == "segment"]) == 4 * n_states
    assert water is None and len(trajs) == n_states and all(len(t.frames) == 4 for t in trajs)
    assert np.isfinite(np.array([t.frames[-1] for t in trajs])).all()
    assert all(sorted(perm) == list(range(n_states)) for perm in diag.replica_idx_by_state_by_iter)
    assert np.asarray(diag.fraction_accepted_by_pair_by_iter).shape == (4, n_states - 1, 2)
    assert len(pair_bar.bar_results) == n_states - 1


@pytest.fixture(scope="module")
def multiplexed_runs(small):
    """Two runs of run_sims_hrex with local MD over small windows 0 and 2 in
    float32 (4 equilibration steps, 3 frames of 4 steps, the last 2 local
    around the ligand, radius 0.4-0.6 nm)."""
    states = small["port32"][::2]
    md = tfe.MDParams(
        n_frames=3, n_eq_steps=4, steps_per_frame=4, seed=2023, hrex_params=tfe.HREXParams(),
        local_md_params=tfe.LocalMDParams(local_steps=2, k=10_000.0, min_radius=0.4, max_radius=0.6),
    )
    return states, [tfe.run_sims_hrex(states, md, print_diagnostics_interval=1) for _ in range(2)]


def test_time_multiplexed_hrex_on_small_windows(multiplexed_runs):
    """JAX's test_run_sims_hrex_local_md_fallback on two small RBFE windows:
    two trajectories of 3 finite frames, permutations of the two replicas,
    one finite BAR pair, the identity pair stripped (one pair reported); a
    second run bitwise equal."""
    states, ((res, trajs, diag, water), (res2, trajs2, diag2, _)) = multiplexed_runs
    assert water is None and len(trajs) == 2 and all(len(t.frames) == 3 for t in trajs)
    assert np.isfinite(np.array([t.frames[-1] for t in trajs])).all()
    assert all(t.final_velocities is not None and t.final_barostat_volume_scale_factor is not None for t in trajs)
    assert all(sorted(perm) == [0, 1] for perm in diag.replica_idx_by_state_by_iter)
    assert np.asarray(diag.fraction_accepted_by_pair_by_iter).shape == (3, 1, 2)
    assert len(res.bar_results) == 1 and np.isfinite(res.dGs).all()
    assert diag.replica_idx_by_state_by_iter == diag2.replica_idx_by_state_by_iter
    for t, t2 in zip(trajs, trajs2):
        assert all(np.array_equal(a, b) for a, b in zip(list(t.frames) + t.boxes, list(t2.frames) + t2.boxes))
    assert np.array_equal(res.u_kln_by_component_by_lambda, res2.u_kln_by_component_by_lambda)
