"""The port's minimizer (timemachine_torch/md/minimizer.py, md/fire.py)
against timemachine_tpu/md/minimizer.py and md/fire.py.

Tolerances, each measured on an x86-64 CPU in float64:
- the minimizer's logic under a shared numpy energy: scipy's methods get
  bitwise the same inputs without a restraint and give bitwise JAX's result;
  under FIRE (the same update rule, torch against jnp arithmetic) LOGIC_TOL
  nm (measured 2.8e-17 and 1.7e-18; fire_minimize alone 1.9e-16); with the
  positional restraint, whose minimum image JAX's jit may contract into an
  FMA, scipy's paths part after an ulp: RESTRAINED_TOL nm (measured 1.3e-13
  under BFGS, 5.0e-9 under L-BFGS-B);
- the port's FIRE descent against JAX's jitted fire_minimize_jax on the same
  energy written in each package: FIRE_TOL nm (measured 1.1e-16);
- the positional restraint's value and gradient: 1e-12;
- make_host_du_dx_fxn on a build_water_system(2.5) host around ethanol:
  both packages' host term is the dense exact-erfc form here (below 4,096
  atoms), so dU/dx agrees within HOST_FORCE_REL of its norm (measured
  5.2e-16 at λ 0, 2.0e-15 at λ 0.1; 8.8e-6 and 1.9e-4 while the port ran
  the rowscan polynomial, ROADMAP P11);
- replace_conformer_with_minimized (vacuum BFGS on ethanol; both packages
  exact erfc): VACUUM_TOL nm (measured 9.1e-11).
fire_minimize_host and pre_equilibrate_host run at a few steps on the CPU:
finite host coordinates of the input's shape, the force-norm checks passed,
the ligand bitwise unmoved through the NPT run, and the box volume within
JAX's own test's bounds (tests/test_builders_minimizer.py).
"""

import numpy as np
import pytest
import torch

from timemachine_torch.chem import mol_from_smiles as t_mol_from_smiles
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.md import builders as tb
from timemachine_torch.md import minimizer as tm
from timemachine_torch.md.fire import FireMinimizationConfig as TFire
from timemachine_torch.md.fire import fire_minimize as t_fire_descent
from timemachine_torch.testsystems import rbfe_solvent

torch.set_num_threads(1)  # the suite's workers share the host's cores

LOGIC_TOL = 1e-12
RESTRAINED_TOL = 1e-7
FIRE_TOL = 1e-12
HOST_FORCE_REL = 1e-10
VACUUM_TOL = 1e-8
N_ATOMS = 8


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _shared_val_and_grad():
    """A numpy energy of N_ATOMS points (harmonic springs between chain
    neighbours, a soft repulsion between all pairs, a weak quartic tether),
    with its exact gradient; np.asarray on entry makes JAX's minimizer take
    its eager path, as it does for any numpy energy."""
    rng = np.random.default_rng(2024)
    r0 = rng.uniform(0.12, 0.18, N_ATOMS - 1)
    iu = np.triu_indices(N_ATOMS, 1)

    def val_and_grad(x):
        x = np.asarray(x, dtype=np.float64)
        d = x[1:] - x[:-1]
        r = np.linalg.norm(d, axis=1)
        u = np.sum(0.5 * 500.0 * (r - r0) ** 2)
        g = np.zeros_like(x)
        gb = (500.0 * (r - r0) / r)[:, None] * d
        g[1:] += gb
        g[:-1] -= gb
        dp = x[iu[0]] - x[iu[1]]
        r2 = np.sum(dp * dp, axis=1)
        u += np.sum(0.01 / r2)
        gp = (-0.02 / r2**2)[:, None] * dp
        np.add.at(g, iu[0], gp)
        np.add.at(g, iu[1], -gp)
        u += np.sum(x**4)
        g += 4 * x**3
        return float(u), g

    return val_and_grad


def _x0():
    return np.random.default_rng(7).normal(0.0, 0.3, (N_ATOMS, 3))


def test_fire_minimize_matches_jax_on_a_shared_numpy_gradient():
    _jax()
    from timemachine_tpu.md import minimizer as jm
    from timemachine_tpu.md.fire import FireMinimizationConfig

    vg = _shared_val_and_grad()
    x0 = _x0()
    j = jm.fire_minimize(x0, lambda x: vg(x)[1], FireMinimizationConfig(300))
    t = tm.fire_minimize(torch.as_tensor(x0), lambda x: torch.as_tensor(vg(x.numpy())[1]), TFire(300))
    assert vg(t)[0] < vg(x0)[0]
    np.testing.assert_allclose(t, j, rtol=0, atol=LOGIC_TOL)


def test_fire_descent_matches_fire_minimize_jax():
    """md/fire.py's descent against JAX's one jitted scan, each on the same
    springs written in its own package."""
    jax = _jax()
    import jax.numpy as jnp

    from timemachine_tpu.md.fire import FireMinimizationConfig, fire_minimize_jax

    x0 = _x0()
    r0 = 0.15

    def j_force(x):
        return -jax.grad(lambda y: jnp.sum(0.5 * 500.0 * (jnp.linalg.norm(y[1:] - y[:-1], axis=1) - r0) ** 2) + jnp.sum(y**4))(x)

    def t_force(x):
        with torch.enable_grad():
            y = x.detach().requires_grad_(True)
            u = torch.sum(0.5 * 500.0 * (torch.linalg.vector_norm(y[1:] - y[:-1], dim=1) - r0) ** 2) + torch.sum(y**4)
            return -torch.autograd.grad(u, y)[0]

    j = np.asarray(fire_minimize_jax(jnp.asarray(x0), j_force, FireMinimizationConfig(400, dt_max=2e-3)))
    t = t_fire_descent(torch.as_tensor(x0), t_force, TFire(400, dt_max=2e-3)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=FIRE_TOL)


CONFIGS = {
    "FIRE": (lambda m: m.FireMinimizationConfig(200)),
    "BFGS": (lambda m: m.ScipyMinimizationConfig(method="BFGS")),
    "L-BFGS-B": (lambda m: m.ScipyMinimizationConfig(method="L-BFGS-B")),
}


@pytest.mark.parametrize("restrained", [False, True])
@pytest.mark.parametrize("method", sorted(CONFIGS))
def test_local_minimize_matches_jax(method, restrained):
    """The same numpy energy, free atoms and restraint in both packages;
    bitwise where scipy gets bitwise the same inputs."""
    _jax()
    from timemachine_tpu.md import fire as jfire
    from timemachine_tpu.md import minimizer as jm
    from timemachine_torch.md import fire as tfire

    vg = _shared_val_and_grad()
    x0 = _x0()
    box = np.eye(3) * 1.5
    free = np.array([1, 2, 4, 5, 7])
    kw = dict(verbose=False, restraint_k=4000.0 if restrained else 0.0, restrained_idxs=free[:3] if restrained else None)
    j = jm.local_minimize(x0, box, vg, free, CONFIGS[method](jfire), **kw)
    t = tm.local_minimize(x0, box, vg, free, CONFIGS[method](tfire), **kw)
    frozen = np.setdiff1d(np.arange(N_ATOMS), free)
    np.testing.assert_array_equal(t[frozen], x0[frozen])
    assert vg(t)[0] < vg(x0)[0] or restrained
    if method == "FIRE":
        np.testing.assert_allclose(t, j, rtol=0, atol=LOGIC_TOL)
    elif restrained:
        np.testing.assert_allclose(t, j, rtol=0, atol=RESTRAINED_TOL)
    else:
        np.testing.assert_array_equal(t, j)


def test_positional_restraint_matches_jax():
    _jax()
    from timemachine_tpu.md import minimizer as jm

    rng = np.random.default_rng(11)
    box = np.diag([1.3, 1.1, 1.7])
    x0 = rng.uniform(0.0, 1.0, (10, 3))
    x = x0 + rng.normal(0.0, 0.4, (10, 3))  # some displacements cross half the box
    idx = np.array([0, 3, 4, 8, 9])

    def zero(y):
        return 0.0, np.zeros_like(np.asarray(y))

    uj, gj = jm.wrap_val_and_grad_with_positional_restraint(zero, x0, box, idx, 4000.0)(x)
    ut, gt = tm.wrap_val_and_grad_with_positional_restraint(zero, x0, box, idx, 4000.0)(x)
    assert abs(ut - uj) <= 1e-12 * abs(uj)
    np.testing.assert_allclose(gt, np.asarray(gj), rtol=0, atol=1e-12 * np.abs(gj).max())
    assert not gt[np.setdiff1d(np.arange(10), idx)].any()


@pytest.mark.parametrize(
    "forces, raises",
    [(np.ones((4, 3)), False), (np.full((4, 3), 2e4), True), (np.array([[0.0, 0.0, np.nan]]), True),
     (np.array([[np.inf, 0.0, 0.0]]), True), (np.zeros((0, 3)), False)],
)
def test_check_force_norm_accepts_and_raises_as_jax(forces, raises):
    _jax()
    from timemachine_tpu.md import minimizer as jm

    for check, err in ((tm.check_force_norm, tm.MinimizationError), (jm.check_force_norm, jm.MinimizationError)):
        if raises:
            with pytest.raises(err):
                check(forces)
        else:
            check(forces)


@pytest.fixture(scope="module")
def ethanol_host():
    """Ethanol (the RBFE cache's conformer) in build_water_system(2.5) of
    both packages."""
    _jax()
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.ff import Forcefield as JF
    from timemachine_tpu.md.builders import build_water_system

    conf = rbfe_solvent.metadata(rbfe_solvent.load_arrays())["conf_a"]
    j_mol, t_mol = j_mol_from_smiles("CCO", add_hs=True, name="ethanol"), t_mol_from_smiles("CCO", add_hs=True, name="ethanol")
    for m in (j_mol, t_mol):
        m.set_conf(np.asarray(conf))
    jff, tff = JF.load_default(), TF.load_default()
    return dict(
        j_mol=j_mol, t_mol=t_mol, jff=jff, tff=tff,
        j_host=build_water_system(2.5, jff.water_ff, mols=[j_mol]), t_host=tb.build_water_system(2.5, tff.water_ff, mols=[t_mol]),
    )


@pytest.mark.parametrize("lamb", [0.0, 0.1])
def test_make_host_du_dx_fxn_matches_jax(ethanol_host, lamb):
    from timemachine_tpu.md import minimizer as jm

    e = ethanol_host
    np.testing.assert_array_equal(e["t_host"].conf, e["j_host"].conf)
    gj = jm.make_host_du_dx_fxn([e["j_mol"]], e["j_host"], e["jff"], lamb=lamb)(e["j_host"].conf)
    gt = tm.make_host_du_dx_fxn([e["t_mol"]], e["t_host"], e["tff"], lamb=lamb, device="cpu")(torch.as_tensor(e["t_host"].conf))
    assert gt.shape == e["t_host"].conf.shape
    rel = np.linalg.norm(gt.numpy() - gj) / np.linalg.norm(gj)
    assert rel <= HOST_FORCE_REL, rel


def test_pre_equilibrate_host_freezes_the_ligand(ethanol_host):
    """40 FIRE steps a window over 2 windows, then 20 NPT steps with the
    barostat every 5: the host finite and of the input's shape, both
    force-norm checks passed (they raise), the ligand bitwise unmoved (the
    function asserts it; checked again here through its Context's run),
    the box volume within (0.7, 1.3) of 2.5^3."""
    e = ethanol_host
    cfg, mol = e["t_host"], e["t_mol"]
    x_fire = tm.fire_minimize_host([mol], cfg, e["tff"], n_steps_per_window=40, device="cpu")
    assert x_fire.shape == cfg.conf.shape and np.isfinite(x_fire).all()
    assert not np.array_equal(x_fire, cfg.conf)
    x_host, box = tm.pre_equilibrate_host(
        [mol], cfg, e["tff"], minimizer_steps_per_window=40, equilibration_steps=20, device="cpu"
    )
    assert x_host.shape == cfg.conf.shape and np.isfinite(x_host).all()
    vol = float(np.prod(np.diagonal(box)))
    assert 0.7 * 2.5**3 < vol < 1.3 * 2.5**3


def test_pre_equilibrate_host_context_keeps_frozen_atoms_bitwise(ethanol_host, monkeypatch):
    """The NPT Context of pre_equilibrate_host, caught as it is made: after
    its run every ligand coordinate is bitwise its input, while the host
    and the box moved."""
    e = ethanol_host
    made = []
    real_context = tm.Context

    def catching(*args, **kwargs):
        made.append(real_context(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tm, "Context", catching)
    cfg, mol = e["t_host"], e["t_mol"]
    x_host, box = tm.pre_equilibrate_host(
        [mol], cfg, e["tff"], minimizer_steps_per_window=40, equilibration_steps=10, barostat_interval=2, device="cpu"
    )
    (ctxt,) = made
    n_host = cfg.conf.shape[0]
    x = ctxt.get_x_t()
    np.testing.assert_array_equal(x[n_host:], mol.get_conf())
    assert not np.array_equal(box, cfg.box)
    assert ctxt.get_barostat()[1].total_attempted.item() == 5


def test_val_and_grad_is_the_energy_gradient(ethanol_host):
    """get_val_and_grad_fn over host_guest_modules: dU/dx equals the
    central difference of U (float64 sums) at a few coordinates, and two
    calls at one point are bitwise equal."""
    e = ethanol_host
    cfg = e["t_host"]
    modules, _ = tm.host_guest_modules([e["t_mol"]], cfg, e["tff"], 0.0, device="cpu")
    x = np.concatenate([cfg.conf, e["t_mol"].get_conf()])
    vg = tm.get_val_and_grad_fn(modules, cfg.box)
    u, g = vg(x)
    u2, g2 = vg(x)
    assert u == u2 and np.array_equal(g, g2) and vg.calls == 2
    h = 1e-6
    for atom in (0, 5, x.shape[0] - 1):
        for dim in range(3):
            xp, xm = x.copy(), x.copy()
            xp[atom, dim] += h
            xm[atom, dim] -= h
            fd = (vg(xp)[0] - vg(xm)[0]) / (2 * h)
            assert abs(fd - g[atom, dim]) <= 1e-5 * max(1.0, abs(g[atom, dim])), (atom, dim, fd, g[atom, dim])


def test_replace_conformer_with_minimized_matches_jax(ethanol_host):
    from timemachine_tpu.md import minimizer as jm

    e = ethanol_host
    j_mol, t_mol = e["j_mol"].copy(), e["t_mol"].copy()
    jm.replace_conformer_with_minimized(j_mol, e["jff"])
    tm.replace_conformer_with_minimized(t_mol, e["tff"], device="cpu")
    assert not np.array_equal(t_mol.get_conf(), e["t_mol"].get_conf())
    np.testing.assert_allclose(t_mol.get_conf(), j_mol.get_conf(), rtol=0, atol=VACUUM_TOL)


def test_equilibrate_host_barker_waits_on_barker(ethanol_host):
    """equilibrate_host_barker runs md/barker.py's chain (held to JAX in
    tests/test_torch_barker.py): it refuses a proposal stddev over 1e-4 nm,
    and two steps from the raw 2.5 nm box leave its clashes, which the
    final force check reports."""
    e = ethanol_host
    with pytest.raises(ValueError, match="proposal_stddev"):
        tm.equilibrate_host_barker([e["t_mol"]], e["t_host"], e["tff"], proposal_stddev=1e-3, device="cpu")
    with pytest.raises(tm.MinimizationError):
        tm.equilibrate_host_barker([e["t_mol"]], e["t_host"], e["tff"], n_steps=2, seed=1, device="cpu")
