"""timemachine_torch systems against timemachine_tpu: the DHFR loader, the
converter from JAX objects, the numpy helpers the port copies, the bonded
terms on the full DHFR arrays, and the rule that the port never imports JAX.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.fe.model_utils import apply_hmr
from timemachine_torch.md import utils as tutils
from timemachine_torch.testsystems.dhfr import setup_dhfr
from timemachine_tpu.fe import model_utils as jmodel_utils
from timemachine_tpu.md import utils as jutils
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.testsystems.dhfr import setup_dhfr_native

torch.set_num_threads(1)  # the suite's workers share the host's cores


@pytest.fixture(scope="module")
def dhfr():
    return setup_dhfr_native(waters_first=True), setup_dhfr(waters_first=True, device="cpu")


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

    x = np.zeros((3, 3))

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

    return {
        "setup_dhfr": lambda: [b for p in setup_dhfr().host_system.get_U_fns() for b in p.buffers()],
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
        "get_context", "build_rbfe_solvent",
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
