"""timemachine_torch forcefield-parameter gradients against timemachine_tpu:
du/dp of every U_fn of the host system through `u(x, params, box)`, the
reweighting estimators and losses, and the slice as a whole (a charge-scale
training loss and its gradient on a small water box).

JAX runs the Pallas kernels in interpret mode (configure_pallas(interpret=
True)); both sides are f32 there, so nonbonded tolerances are stated as
relative norms with their measured values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch import constants as tconst
from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.fe import loss as tloss
from timemachine_torch.fe import reweighting as trw
from timemachine_torch.ops import nonbonded_kernel as nbk
from timemachine_torch.ops import rowscan_kernel as rs
from timemachine_torch.potentials import NonbondedAllPairs
from timemachine_torch.testsystems.dhfr import setup_dhfr
from timemachine_tpu import constants as jconst
from timemachine_tpu import potentials as jpot
from timemachine_tpu.fe import loss as jloss
from timemachine_tpu.fe import reweighting as jrw
from timemachine_tpu.md.builders import build_water_system

torch.set_num_threads(1)  # the suite's workers share the host's cores

BETA, CUTOFF = 2.0, 1.2
KT = tconst.BOLTZ * 300.0
F32 = torch.float32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("term,cls", [
    ("bond", jpot.HarmonicBond), ("angle", jpot.HarmonicAngle),
    ("proper", jpot.PeriodicTorsion), ("improper", jpot.PeriodicTorsion),
])
def test_bonded_du_dp_matches_jax(term, cls):
    """f64 on the DHFR arrays: autograd of the port's energy against
    jax.grad(pot, argnums=1), to 1e-10 relative norm."""
    cfg = setup_dhfr(device="cpu")
    pot = getattr(cfg.host_system, term)
    p = pot.params.clone().requires_grad_(True)
    x, box = torch.as_tensor(cfg.conf), torch.as_tensor(cfg.box)
    pot.u(x, p, box).backward()
    ref = jax.grad(cls(pot.idxs.numpy()), argnums=1)(jnp.asarray(cfg.conf), jnp.asarray(pot.params.numpy()), jnp.asarray(cfg.box))
    assert _rel(p.grad.numpy(), ref) < 1e-10


@pytest.fixture(scope="module")
def water_pair():
    """The 2.4 nm water box: JAX potentials configured as the Pallas path
    (interpret mode) and the port's, in f32, for each kernel; "quad" falls
    back to rowscan in both at this box (the constant-shift gate)."""
    out = {}
    for kernel in ("rowscan", "v1", "gather", "quad"):
        jcfg = build_water_system(2.4)
        jcfg.host_system.nonbonded_all_pairs.potential.configure_pallas(jcfg.box, jcfg.conf, interpret=True, kernel=kernel)
        cfg = host_config_from_jax(jcfg, device="cpu", dtype=F32)
        x = torch.as_tensor(cfg.conf, dtype=F32)
        box = torch.as_tensor(cfg.box, dtype=F32)
        cfg.host_system.nonbonded_all_pairs.configure(box, x, kernel=kernel)
        out[kernel] = (jcfg, cfg, x, box)
    return out


@pytest.mark.parametrize("kernel", ["rowscan", "v1", "gather", "quad"])
def test_nonbonded_du_dp_matches_jax(water_pair, kernel):
    """Nonbonded du/dp (all pairs through the DP pass minus the exclusions
    through autograd) against jax.grad(pot, argnums=1), per parameter
    column: 1e-5 relative norm (measured 1.5e-6 for q, 4.4e-7 for sig,
    7.8e-7 for eps; w has no gradient at w = 0 in either). du/dx through
    the same u is the energy/force path's -force, to 1e-6 of the all-pairs
    force norm (the exclusions' x-gradient comes from autograd there)."""
    jcfg, cfg, x, box = water_pair[kernel]
    jbp = jcfg.host_system.nonbonded_all_pairs
    assert cfg.host_system.nonbonded_all_pairs.kernel == jbp.potential._all_pairs.pallas_kernel
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = np.asarray(jax.grad(jbp.potential, argnums=1)(f32(jcfg.conf), f32(jbp.params), f32(jcfg.box)))
    nb = cfg.host_system.nonbonded_all_pairs
    p = nb.params.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    nb.u(xg, p, box).backward()
    for col in range(3):
        assert _rel(p.grad[:, col].numpy(), ref[:, col]) < 1e-5, col
    np.testing.assert_array_equal(p.grad[:, 3].numpy(), ref[:, 3])
    f_scale = torch.linalg.vector_norm(NonbondedAllPairs.energy_force(nb, x, box)[1])
    assert float(torch.linalg.vector_norm(xg.grad + nb.energy_force(x, box)[1]) / f_scale) < 1e-6


def test_grad_contract(water_pair):
    """The box gets no gradient, the DP pass runs only when params needs a
    gradient, and asking for a differentiable gradient (create_graph)
    raises: the kernel's DP pass has no backward."""
    _, cfg, x, box = water_pair["rowscan"]
    nb = cfg.host_system.nonbonded_all_pairs
    b = box.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    calls = nbk.nb_tiles_plain.calls
    u = NonbondedAllPairs.u(nb, xg, nb.params, b)  # the all-pairs term alone
    gx, gb = torch.autograd.grad(u, [xg, b], allow_unused=True)
    assert gb is None and nbk.nb_tiles_plain.calls == calls
    p = nb.params.clone().requires_grad_(True)
    torch.autograd.grad(nb.u(x, p, box), [p])
    assert nbk.nb_tiles_plain.calls == calls + 1
    with pytest.raises(RuntimeError, match="twice"):
        torch.autograd.grad(nb.u(x, p, box), [p], create_graph=True)


def test_dp_pass_runs_triangular_lists():
    """run_dp sweeps Newton-triangular lists (sized by suggest_max_tiles(...,
    triangular=True)), each pair once with its four dU/dp terms on both
    atoms. On the 2.4 nm water box with w offsets lifted, so that dU/dw is
    not zero, it equals the symmetric DP sweep of the same sort per column,
    f32, to 1e-5 relative norm (different summation orders)."""
    cfg = build_water_system(2.4)
    x = torch.as_tensor(np.asarray(cfg.conf, np.float32))
    box = torch.as_tensor(np.asarray(cfg.box, np.float32))
    params = np.array(cfg.host_system.nonbonded_all_pairs.params, np.float32)
    params[:, 3] = np.random.default_rng(6).uniform(0.0, 0.1, len(params))
    params = torch.as_tensor(params)
    dp = nbk.run_dp(x, params, box, BETA, CUTOFF, nbk.suggest_max_tiles(x, box, CUTOFF, cb=2, triangular=True), cb=2)
    assert not bool(torch.isnan(dp).any())
    sym = nbk.build_block_tiles(x, params, box, CUTOFF, nbk.suggest_max_tiles(x, box, CUTOFF, cb=2), 2)
    ref = nbk.nb_tiles_plain(sym.atoms, sym.row_start, sym.row_count, sym.col_ids, nbk.tile_scalars(box, BETA, CUTOFF), nbk.DP, 2)
    ref = ref[torch.argsort(sym.pad_order[: x.shape[0]])]
    for col in range(4):
        assert _rel(dp[:, col].numpy(), ref[:, col].numpy()) < 1e-5, col


def test_r2_dp_charge_gradient_vs_polynomial_energy():
    """R2: the DP pass differentiates the exact (A&S erfc) electrostatics,
    as the JAX backward does, while the rowscan energy is the degree-10
    polynomial. In f64 the gap between DP dU/dq and the autograd gradient
    of the port's own polynomial energy is 1.37e-5 in relative norm on the
    2.4 nm water box (bound 5e-5); LJ columns agree to 1e-12."""
    jcfg = build_water_system(2.4)
    cfg = host_config_from_jax(jcfg, device="cpu")
    x, box = torch.as_tensor(cfg.conf), torch.as_tensor(cfg.box)
    params = cfg.host_system.nonbonded_all_pairs.params
    p = params.clone().requires_grad_(True)
    ef = rs.make_nonbonded_rowscan_energy_force(BETA, CUTOFF, max_pairs=10**4)
    ef(x, p, box, rs.ENERGY)[0].backward()
    dp = nbk.run_dp(x, params, box, BETA, CUTOFF, max_tiles=10**4, cb=2)
    gap = _rel(dp[:, 0].numpy(), p.grad[:, 0].numpy())
    assert 0 < gap < 5e-5
    assert _rel(dp[:, 1:3].numpy(), p.grad[:, 1:3].numpy()) < 1e-12


RW_CASES = ["log_mean", "one_sided_exp", "mixture_potential", "endpoint", "mixture"]


@pytest.mark.parametrize("case", RW_CASES)
def test_reweighting_matches_jax(case):
    """f64 values and gradients equal the JAX estimators to 1e-12."""
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(6, 3))
    u_kn = rng.normal(size=(3, 6)) * 2.0
    f_k = rng.normal(size=3)
    theta = np.array([0.3, -0.2])

    def batched(shift):
        return lambda samples, th: (samples ** 2).sum(1) * th[0] + samples[:, 0] * th[1] + shift

    def run(rw, arr, grad):
        th = arr(theta)
        if case == "log_mean":
            fn = lambda t: rw.log_mean(arr(xs[:, 0]) * t[0] + t[1])  # noqa: E731
        elif case == "one_sided_exp":
            fn = lambda t: rw.one_sided_exp(arr(xs[:, 1]) * t[0] - t[1])  # noqa: E731
        elif case == "mixture_potential":
            fn = lambda t: rw.interpret_as_mixture_potential(  # noqa: E731
                arr(u_kn) * t[0], arr(f_k) + t[1], [2, 3, 1]
            ).sum()
        elif case == "endpoint":
            fn = rw.construct_endpoint_reweighting_estimator(
                arr(xs[:3]), arr(xs[3:]), batched(0.1), batched(-0.4), arr(theta * 1.1), 0.7
            )
        else:
            fn = rw.construct_mixture_reweighting_estimator(arr(xs), arr(u_kn[0]), batched(0.1), batched(-0.4))
        return grad(fn, th)

    def torch_grad(fn, th):
        th = th.clone().requires_grad_(True)
        v = fn(th)
        v.backward()
        return float(v.detach()), th.grad.numpy()

    v_j, g_j = run(jrw, jnp.asarray, lambda fn, th: (float(fn(th)), np.asarray(jax.grad(fn)(th))))
    v_t, g_t = run(trw, lambda a: torch.as_tensor(np.asarray(a, np.float64)), torch_grad)
    assert v_t == pytest.approx(v_j, rel=1e-12)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("fn", ["truncated_residuals", "l1_loss", "pseudo_huber_loss", "flat_bottom_loss"])
def test_loss_matches_jax(fn):
    """f64 values and gradients equal the JAX losses to 1e-12."""
    r = np.array([-30.0, -4.0, -0.5, 0.01, 0.3, 4.3, 9.0])  # off the kinks, where the two differ by convention
    labels = np.array([0.5, -6.0, 3.0, -7.0, 0.0, 2.0, 0.5])
    if fn == "truncated_residuals":
        jfn = lambda a: jloss.truncated_residuals(a, jnp.asarray(labels), (-5.0, 1.0)).sum()  # noqa: E731
        tfn = lambda a: tloss.truncated_residuals(a, torch.as_tensor(labels), (-5.0, 1.0)).sum()  # noqa: E731
    else:
        jfn = lambda a: getattr(jloss, fn)(a).sum()  # noqa: E731
        tfn = lambda a: getattr(tloss, fn)(a).sum()  # noqa: E731
    v_j, g_j = jax.value_and_grad(jfn)(jnp.asarray(r))
    t = torch.tensor(r, requires_grad=True)
    v_t = tfn(t)
    v_t.backward()
    assert float(v_t) == pytest.approx(float(v_j), rel=1e-12)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_j), rtol=1e-12, atol=0)
    assert tconst.KCAL_TO_KJ == jconst.KCAL_TO_KJ


S0 = 1.1


def test_charge_scale_training_matches_jax(water_pair):
    """The slice as a whole, as chip_smoke.py runs it at DHFR: theta = a
    charge scale s, Delta f(s) by construct_mixture_reweighting_estimator
    over three frames with u_ref at s = 1, loss pseudo_huber(kT Delta f(s)),
    gradient by autograd through the rowscan energy and the DP pass. Against
    the same composition in JAX at s = S0: loss and dL/ds to 1e-4 relative
    (measured 0 and 4.8e-6). The f32 energies of the two sides differ by
    about 0.06 kJ/mol per frame (the all-pairs sum, ~1e6 kJ/mol before the
    exclusions cancel it, rounds at that step), so S0 = 1.1 keeps the
    energy differences (30-100 kJ/mol) far above that; at 1.01 they are
    3-10 kJ/mol and the two sides differ by 0.7%."""
    jcfg, cfg, x, box = water_pair["rowscan"]
    rng = np.random.default_rng(4)
    frames = [cfg.conf + rng.normal(0, 0.005, cfg.conf.shape) for _ in range(3)]
    nb = cfg.host_system.nonbonded_all_pairs
    jbp = jcfg.host_system.nonbonded_all_pairs

    def torch_loss(s):
        q = nb.params[:, :1] * s
        p = torch.cat([q, nb.params[:, 1:]], dim=1)
        return torch.stack([nb.u(torch.as_tensor(f, dtype=F32), p, box) for f in frames]) / KT

    with torch.no_grad():
        u_ref_t = torch_loss(torch.tensor(1.0))
    est_t = trw.construct_mixture_reweighting_estimator(frames, u_ref_t, lambda xs, s: u_ref_t, lambda xs, s: torch_loss(s))
    s_t = torch.tensor(S0, requires_grad=True)
    loss_t = tloss.pseudo_huber_loss(KT * est_t(s_t) - 0.0)
    loss_t.backward()

    def jax_u(s):
        p = jnp.asarray(jbp.params, jnp.float32)
        p = p.at[:, 0].multiply(s)
        return jnp.stack([jbp.potential(jnp.asarray(f, jnp.float32), p, jnp.asarray(jcfg.box, jnp.float32)) for f in frames]) / KT

    u_ref_j = jax_u(1.0)
    est_j = jrw.construct_mixture_reweighting_estimator(frames, u_ref_j, lambda xs, s: u_ref_j, lambda xs, s: jax_u(s))
    loss_j, grad_j = jax.value_and_grad(lambda s: jloss.pseudo_huber_loss(KT * est_j(s) - 0.0))(S0)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    assert float(s_t.grad) == pytest.approx(float(grad_j), rel=1e-4)
    assert float(loss_t) > 1.0 and float(s_t.grad) > 0  # s = 1 is the minimum: the gradient points back to it
