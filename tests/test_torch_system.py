"""timemachine_torch systems against timemachine_tpu: the DHFR loader, the
converter from JAX objects, the numpy helpers the port copies, the bonded
terms on the full DHFR arrays, and the rule that the port never imports JAX.
"""

import ast
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.fe.model_utils import apply_hmr
from timemachine_torch.md import utils as tutils
from timemachine_torch.testsystems.dhfr import setup_dhfr, setup_dhfr_native as torch_setup_dhfr_native
from timemachine_tpu.fe import model_utils as jmodel_utils
from timemachine_tpu.md import utils as jutils
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.testsystems.dhfr import setup_dhfr_native

torch.set_num_threads(1)  # the suite's workers share the host's cores


@pytest.fixture(scope="module")
def dhfr():
    return setup_dhfr_native(waters_first=True), torch_setup_dhfr_native(waters_first=True, device="cpu")


def test_dhfr_loader_matches_jax(dhfr):
    """Same atoms, order, terms, parameters and molecule groups as
    setup_dhfr_native(waters_first=True): bitwise."""
    jcfg, cfg = dhfr
    assert cfg.conf.shape == (23_558, 3) and cfg.num_water_atoms == 21_069
    np.testing.assert_array_equal(cfg.conf, jcfg.conf)
    np.testing.assert_array_equal(cfg.box, jcfg.box)
    np.testing.assert_array_equal(cfg.masses, jcfg.masses)
    for term in ("bond", "angle", "proper", "improper"):
        jbp, pot = getattr(jcfg.host_system, term), getattr(cfg.host_system, term)
        np.testing.assert_array_equal(pot.idxs.numpy(), np.asarray(jbp.potential.idxs))
        np.testing.assert_array_equal(pot.params.numpy(), np.asarray(jbp.params, np.float64))
    jnb, nb = jcfg.host_system.nonbonded_all_pairs, cfg.host_system.nonbonded_all_pairs
    np.testing.assert_array_equal(nb.params.numpy(), np.asarray(jnb.params, np.float64))
    assert (nb.beta, nb.cutoff) == (jnb.potential.beta, jnb.potential.cutoff)
    assert nb.num_waters == 7_023
    np.testing.assert_array_equal(nb.tail_idxs.numpy(), np.asarray(jnb.potential.exclusion_idxs)[3 * 7_023 :])
    assert len(cfg.group_idxs) == len(jcfg.host_topology.group_idxs)
    for g, jg in zip(cfg.group_idxs, jcfg.host_topology.group_idxs):
        np.testing.assert_array_equal(g, jg)


def test_convert_carries_a_jax_host_config():
    jcfg = build_water_system(3.0)
    cfg = host_config_from_jax(jcfg, device="cpu", dtype=torch.float32)
    hs = cfg.host_system
    assert [type(p).__name__ for p in hs.get_U_fns()] == [
        "HarmonicBond", "HarmonicAngle", "PeriodicTorsion", "PeriodicTorsion", "Nonbonded",
    ]
    np.testing.assert_array_equal(hs.bond.idxs.numpy(), np.asarray(jcfg.host_system.bond.potential.idxs))
    np.testing.assert_array_equal(hs.nonbonded_all_pairs.params.numpy(), np.asarray(jcfg.host_system.nonbonded_all_pairs.params, np.float32))
    assert hs.nonbonded_all_pairs.params.dtype == torch.float32
    assert len(cfg.group_idxs) == len(jcfg.host_topology.group_idxs) == cfg.conf.shape[0] // 3


def test_numpy_helpers_equal_jax_package(dhfr):
    """apply_hmr, sample_velocities and get_group_indices are copies: equal
    results on DHFR."""
    jcfg, cfg = dhfr
    bonds = np.asarray(jcfg.host_system.bond.potential.idxs)
    np.testing.assert_array_equal(apply_hmr(cfg.masses, bonds), jmodel_utils.apply_hmr(jcfg.masses, bonds))
    np.testing.assert_array_equal(tutils.sample_velocities(cfg.masses, 300.0, 3), jutils.sample_velocities(jcfg.masses, 300.0, 3))
    bond_list = [tuple(map(int, b)) for b in bonds[:500]]
    for g, jg in zip(tutils.get_group_indices(bond_list, 900), jutils.get_group_indices(bond_list, 900)):
        np.testing.assert_array_equal(g, jg)


@pytest.mark.parametrize("term", ["bond", "angle", "proper", "improper"])
def test_bonded_matches_jax_on_dhfr(dhfr, term):
    """Energy (both forms) and closed-form force of each bonded term on the
    full DHFR arrays, f64, against the JAX energy and its autodiff gradient:
    1e-10 relative (same formulas, different summation order)."""
    jcfg, cfg = dhfr
    jbp, pot = getattr(jcfg.host_system, term), getattr(cfg.host_system, term)
    conf, box = np.asarray(jcfg.conf, np.float64), np.asarray(jcfg.box, np.float64)
    u_ref, g_ref = jax.value_and_grad(lambda c: jbp.potential(c, jnp.asarray(jbp.params, jnp.float64), jnp.asarray(box)))(
        jnp.asarray(conf)
    )
    x, b = torch.as_tensor(conf), torch.as_tensor(box)
    u, f = pot.energy_force(x, b)
    assert float(u) == pytest.approx(float(u_ref), rel=1e-10)
    assert float(pot.energy(x, b)) == pytest.approx(float(u_ref), rel=1e-10)
    g_ref = np.asarray(g_ref)
    assert np.linalg.norm(f.numpy() + g_ref) / np.linalg.norm(g_ref) < 1e-10


def test_port_never_imports_jax():
    """Importing every module of the port (in a fresh interpreter) loads
    neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys, timemachine_torch\n"
        "for m in pkgutil.walk_packages(timemachine_torch.__path__, 'timemachine_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'timemachine_tpu'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)


def test_no_import_of_jax_anywhere_in_the_port_or_chip_smoke():
    """Every import statement of the port's modules and of chip_smoke.py,
    those inside functions included (kernels and probes import lazily),
    names neither jax nor the JAX package, nor networkx, which the card's
    machine does not have (the state builder runs on graph_utils)."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "timemachine_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {m}" for m in names if m.split(".")[0] in ("jax", "jaxlib", "timemachine_tpu", "networkx")]
    assert len(files) > 30 and not bad, bad


_FACTORIES = ("as_tensor", "tensor", "arange", "zeros", "ones", "full", "empty", "eye", "rand", "randn")


def _factory_tensors(run):
    """The tensors that torch's factory functions make while `run` runs:
    where an entry point returns numpy, these are where it chose a device."""
    from torch.overrides import TorchFunctionMode

    made = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if getattr(func, "__name__", None) in _FACTORIES and isinstance(out, torch.Tensor):
                made.append(out)
            return out

    with Record():
        run()
    return made


def _default_device_constructions():
    """Entry points called with no device argument, each returning the
    tensors it made."""
    from timemachine_torch.fe.free_energy import get_context
    from timemachine_torch.fe.system import HostGuestSystem
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md.barostat import MonteCarloBarostat
    from timemachine_torch.md.context import Context
    from timemachine_torch.ops.segment import SegmentSum
    from timemachine_torch.testsystems import rbfe_solvent

    from timemachine_torch.examples import water_sampling_mc as water_mc
    from timemachine_torch.fe import system as fe_system

    x = np.zeros((3, 3))

    def biphenyl_state():
        from timemachine_torch.chem import mol_from_smiles
        from timemachine_torch.examples.biphenyl_torsion_sampling_hrex import make_state
        from timemachine_torch.ff import Forcefield

        mol = mol_from_smiles("Fc1cccc(F)c1-c1ccccc1F")
        mol.set_conf(np.random.default_rng(0).uniform(0.0, 0.5, (mol.num_atoms, 3)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            state = make_state(mol, Forcefield.load_default(), 0.0, 10.0, 1)
        return [b for p in state.potentials for b in p.buffers()]

    def barostat_move():
        baro = MonteCarloBarostat(3, 1.0, 300.0, [[0, 1, 2]], 25)
        move = baro.make_move_fn(lambda x, box: x.sum())
        cuda = dict(device="cuda", dtype=torch.float64)
        xt = torch.zeros((3, 3), **cuda)
        return list(move(baro.init_state("cuda", torch.float64), xt, xt, 3.0 * torch.eye(3, **cuda))[1:])

    def context_step():
        # the Context follows the state's potentials, loaded with no device argument
        ctxt = get_context(rbfe_solvent.load_rbfe_solvent(windows=[0])[0])
        ctxt.step()
        return [ctxt._x, ctxt._v, ctxt._box, *(b for p in ctxt.potentials for b in p.buffers())]

    def local_md():
        # a local segment on the card's Context, around the ligand of the window loaded with no device argument
        state = rbfe_solvent.load_rbfe_solvent(windows=[0])[0]
        ctxt = get_context(state)
        ctxt.multiple_steps_local(2, state.ligand_idxs, radius=1.0, seed=1)
        return [ctxt._x, ctxt._v, ctxt._box]

    def build_rest():
        from timemachine_torch.fe.free_energy import RESTParams

        states = rbfe_solvent.build_rbfe_solvent(windows=[5], rest_params=RESTParams(3.0))
        return [b for p in states[0].potentials for b in p.buffers()]

    def vacuum_state():
        from timemachine_torch.chem import mol_from_smiles
        from timemachine_torch.ff import Forcefield
        from timemachine_torch.md.enhanced import VacuumState

        mol = mol_from_smiles("CCO", add_hs=True)
        mol.set_conf(rbfe_solvent.metadata(rbfe_solvent.load_arrays())["conf_a"])
        state = VacuumState(mol, Forcefield.load_default())
        return [state.U_full(mol.get_conf()), *(b for m in state._modules for b in m.buffers())]

    def ethanol():
        from timemachine_torch.chem import mol_from_smiles

        mol = mol_from_smiles("CCO", add_hs=True)
        mol.set_conf(rbfe_solvent.metadata(rbfe_solvent.load_arrays())["conf_a"])
        return mol

    def barker():
        # the chain's start and end, from a 1.5 nm water box around ethanol; two
        # steps leave the raw box's clashes, which the final force check reports
        from unittest import mock

        from timemachine_torch.ff import Forcefield
        from timemachine_torch.md import minimizer
        from timemachine_torch.md.builders import build_water_system

        mol, ff = ethanol(), Forcefield.load_default()
        host = build_water_system(1.5, ff.water_ff, mols=[mol])
        seen = []

        def chain(gen, x0, grad_log_q_fn, sigma, n_steps):
            seen.append(x0)
            seen.append(barker_chain(gen, x0, grad_log_q_fn, sigma, n_steps))
            return seen[-1]

        from timemachine_torch.md.barker import barker_chain

        with mock.patch.object(minimizer, "barker_chain", chain):
            try:
                minimizer.equilibrate_host_barker([mol], host, ff, n_steps=2, seed=1)
            except minimizer.MinimizationError:
                pass
        return seen

    def demo_energies():
        from timemachine_torch.ff import Forcefield
        from timemachine_torch.optimize.training_demo import DemoEnergies

        e = DemoEnergies(ethanol(), Forcefield.load_default())
        x = torch.as_tensor(e.x0, device=e.device, dtype=e.dtype)
        return [e.box, e.u_total(x, 1.25), *(b for m in (*e.valence, e.pair_list) for b in m.buffers())]

    def terminal_bond_map():
        from timemachine_torch.maps.terminal_bonds import TerminalBondMap, TerminalMappableState

        bonds = np.array([[0, 1], [1, 2]])
        src = TerminalMappableState.from_harmonic_bond_params(bonds, np.array([[1e6, 0.10], [1e6, 0.11]]))
        dst = TerminalMappableState.from_harmonic_bond_params(bonds, np.array([[2e6, 0.12], [1e6, 0.11]]))
        return list(TerminalBondMap.from_states(src, dst)(np.array([[[0.0, 0, 0], [0.1, 0, 0], [0.1, 0.11, 0]]])))

    def forces_seen(run):
        # the tensors the entry point hands the caller's force or energy function
        seen = []

        def force(x):
            seen.append(x)
            return -x

        def energy(x):
            seen.append(x)
            return (x * x).sum()

        run(force, energy)
        return seen

    from timemachine_torch import integrator, lib
    from timemachine_torch.md.local_resampling import local_resampling_move
    from timemachine_torch.potentials import CentroidRestraint, FanoutSummedPotential

    m3, box = np.ones(3), 3.0 * np.eye(3)
    restraint = lambda: CentroidRestraint([0], [1, 2], 10.0, 0.1, np.zeros(0), 3)  # noqa: E731
    return {
        "integrator.LangevinIntegrator": lambda: forces_seen(
            lambda f, u: integrator.LangevinIntegrator(f, m3, 300.0, 1.5e-3, 1.0).multiple_steps(x, x, 2)),
        "integrator.VelocityVerletIntegrator": lambda: forces_seen(
            lambda f, u: integrator.VelocityVerletIntegrator(f, m3, 1.5e-3).multiple_steps(x, x, 2)),
        "simulate": lambda: forces_seen(lambda f, u: integrator.simulate(x + np.eye(3), u, 300.0, m3, 2, 1, 2, seed=1)),
        "local_resampling_move": lambda: forces_seen(lambda f, u: local_resampling_move(
            x, lambda y: u(y), lambda y: torch.full((3,), -0.1, dtype=y.dtype, device=y.device),
            lambda y, logpdf: (f(y), logpdf(y)), rng=np.random.default_rng(0))),
        "TerminalBondMap": terminal_bond_map,
        "equilibrate_host_barker": barker,
        "DemoEnergies": demo_energies,
        "HilbertSort": lambda: _factory_tensors(lambda: lib.HilbertSort(3).sort(x, box)),
        "Neighborlist": lambda: _factory_tensors(lambda: lib.Neighborlist(3).get_nblist(x, box, 1.0)),
        "SegmentedSumExp": lambda: _factory_tensors(lambda: lib.SegmentedSumExp(3, 1).logsumexp([[0.0, 1.0]])),
        "SegmentedWeightedRandomSampler": lambda: _factory_tensors(
            lambda: lib.SegmentedWeightedRandomSampler(3, 1, seed=0).sample([[1.0, 2.0]])),
        "NonbondedMolEnergy": lambda: _factory_tensors(
            lambda: lib.NonbondedMolEnergy(3, [[0], [1]], 2.0, 1.2).execute(x + np.eye(3), np.ones((3, 4)), box)),
        "CentroidRestraint": lambda: list(restraint().buffers()),
        "FanoutSummedPotential": lambda: list(FanoutSummedPotential([restraint()], np.zeros(0)).buffers()),
        "VacuumState": vacuum_state,
        "multiple_steps_local": local_md,
        "build_rbfe_solvent(rest_params=)": build_rest,
        "setup_dhfr": lambda: [b for p in setup_dhfr()[0] for b in p.buffers()],
        "setup_dhfr_native": lambda: [b for p in torch_setup_dhfr_native().host_system.get_U_fns() for b in p.buffers()],
        "minimize_scipy": lambda: _factory_tensors(lambda: fe_system.minimize_scipy(lambda y: (y * y).sum(), x + 1.0)),
        "simulate_system": lambda: _factory_tensors(lambda: fe_system.simulate_system(
            lambda y: (y * y).sum(), x, num_samples=1, steps_per_batch=1, num_workers=1, minimize=False)),
        "examples.biphenyl_torsion_sampling_hrex.make_state": biphenyl_state,
        "examples.water_sampling_mc": lambda: [t for t in (lambda c: [c._x, c._v])(water_mc.main(
            ["--box_width", "2.5", "--n_iterations", "0"])[0])],
        "Context": lambda: [Context(x, x, 3.0 * np.eye(3), LangevinIntegrator(300.0, 1e-3, 1.0, np.ones(3), 0), [])._x],
        "SegmentSum": lambda: list(SegmentSum([0, 1, 1], 2).buffers()),
        "MonteCarloBarostat": barostat_move,
        "HostGuestSystem.from_arrays": lambda: [
            b for p in HostGuestSystem.from_arrays(rbfe_solvent.window_arrays(rbfe_solvent.load_arrays(), 0)).get_U_fns()
            for b in p.buffers()
        ],
        "load_rbfe_solvent": lambda: [
            b for p in rbfe_solvent.load_rbfe_solvent(windows=[0])[0].potentials for b in p.buffers()
        ],
        "get_context": context_step,
        "build_rbfe_solvent": lambda: [
            b for p in rbfe_solvent.build_rbfe_solvent(windows=[0])[0].potentials for b in p.buffers()
        ],
    }


@pytest.mark.parametrize(
    "entry",
    [
        "setup_dhfr", "Context", "SegmentSum", "MonteCarloBarostat", "HostGuestSystem.from_arrays", "load_rbfe_solvent",
        "get_context", "build_rbfe_solvent", "multiple_steps_local", "build_rbfe_solvent(rest_params=)", "VacuumState",
        "integrator.LangevinIntegrator", "integrator.VelocityVerletIntegrator", "simulate", "local_resampling_move",
        "TerminalBondMap", "equilibrate_host_barker", "DemoEnergies", "HilbertSort", "Neighborlist", "SegmentedSumExp",
        "SegmentedWeightedRandomSampler", "NonbondedMolEnergy", "CentroidRestraint", "FanoutSummedPotential",
        "setup_dhfr_native", "minimize_scipy", "simulate_system", "examples.biphenyl_torsion_sampling_hrex.make_state",
        "examples.water_sampling_mc",
    ],
)
def test_default_device_is_the_card(entry):
    """With no device argument the port builds on the card: where there is
    one, every tensor comes out on cuda; where there is none, construction
    raises as torch raises for a CUDA tensor and never falls back to the
    CPU."""
    make = _default_device_constructions()[entry]
    if torch.cuda.is_available():
        tensors = make()
        assert tensors and all(t.device.type == "cuda" for t in tensors)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()
