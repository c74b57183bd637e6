"""The complex leg of timemachine_torch/fe/rbfe.py against the JAX package's
on a small host: the capped helix ACE-(ALA)3-NME of
timemachine_torch/testsystems/peptide.py solvated natively, ethanol and
propane (the RBFE cache's conformers) posed beside it. setup_initial_state
at λ 0, 0.5 and 1 in both packages (coordinates, box, masses, velocities,
barostat groups with the protein as one group, every potential's parameters
within 1e-10 of its column's largest value); run_complex of the port alone
at the JAX nightly test's depth, cut further to run here in about a minute;
and environment BCC (ff/envbcc.py) on the helix's host topology against
JAX's EnvironmentBCCHandler, and through combine_with_host.

JAX's EnvironmentBCCHandler cannot read the record JAX's own builder writes
(pair bonds, no charges: ROADMAP R14); its side of the comparison gets the
same residues with (i, j, order) bonds and the charges set.
"""

import functools
import warnings
from dataclasses import replace

import numpy as np
import pytest
import torch

from tests.test_torch_chem import EDGE, mol_pair
from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
from timemachine_torch.fe import rbfe as trbfe
from timemachine_torch.md import builders as tb
from timemachine_torch.testsystems.peptide import capped_helix_pdb, pocket_offset
from timemachine_tpu.fe import rbfe as jrbfe
from timemachine_tpu.md import builders as jb

torch.set_num_threads(1)  # the suite's workers share the host's cores

TOL_REL = 1e-10
TOL_BCC = 1e-12
TEMP = 300.0
N_ALA = 3
BCC_SMIRKS = ["[#6X4:1]-[#1:2]", "[#6X3:1]=[#8X1:2]"]
BCC_PARAMS = [0.013, -0.021]


@pytest.fixture(scope="module")
def complex_edge():
    """Both packages' mols, core, SingleTopology and protein host."""
    from timemachine_torch.fe.single_topology import SingleTopology as TST
    from timemachine_torch.ff import Forcefield as TF
    from timemachine_tpu.fe.atom_mapping import get_cores
    from timemachine_tpu.fe.single_topology import SingleTopology as JST
    from timemachine_tpu.ff import Forcefield as JF

    pdb = capped_helix_pdb(N_ALA)
    (ja, ta), (jb_, tb_) = mol_pair(EDGE[0], "a"), mol_pair(EDGE[1], "b")
    offset = pocket_offset(pdb, [ta.get_conf(), tb_.get_conf()])
    for m in (ja, ta, jb_, tb_):
        m.set_conf(m.get_conf() + offset)
    core = get_cores(ja, jb_, **DEFAULT_ATOM_MAPPING_KWARGS)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_cfg = jb.build_protein_system(pdb, "amber99sbildn", "tip3p", mols=[ja, jb_])
        t_cfg = tb.build_protein_system(pdb, "amber99sbildn", "tip3p", mols=[ta, tb_])
    return dict(
        pdb=pdb, jmols=(ja, jb_), tmols=(ta, tb_), core=np.asarray(core),
        jst=JST(ja, jb_, core, JF.load_default()), tst=TST(ta, tb_, np.asarray(core), TF.load_default()),
        jcfg=j_cfg, tcfg=t_cfg,
    )


def _assert_rel(got, ref, tol=TOL_REL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if ref.size:
        scale = np.maximum(np.abs(ref).reshape(len(ref), -1).max(0), np.finfo(np.float64).tiny)
        assert (np.abs(got - ref).reshape(len(ref), -1) / scale).max() <= tol


@pytest.mark.parametrize("lamb", (0.0, 0.5, 1.0))
def test_setup_initial_state_complex_matches_jax(complex_edge, lamb):
    j, t = complex_edge["jcfg"], complex_edge["tcfg"]
    jhost = jrbfe.Host(j.host_system, j.masses, j.conf, j.box, j.num_water_atoms, j.host_topology)
    thost = trbfe.Host(t.host_system, t.masses, t.conf, t.box, t.num_water_atoms, t.host_topology)
    js = jrbfe.setup_initial_state(complex_edge["jst"], lamb, jhost, TEMP, 2023)
    ts = trbfe.setup_initial_state(complex_edge["tst"], lamb, thost, TEMP, 2023, device="cpu")
    for k in ("x0", "v0", "box0", "ligand_idxs", "protein_idxs", "interacting_atoms"):
        np.testing.assert_array_equal(getattr(ts, k), np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_array_equal(ts.integrator.masses, np.asarray(js.integrator.masses))
    n_p = t.conf.shape[0] - t.num_water_atoms
    np.testing.assert_array_equal(ts.protein_idxs, np.arange(n_p))
    assert len(ts.barostat.group_idxs) == len(js.barostat.group_idxs)
    for g, h in zip(ts.barostat.group_idxs, js.barostat.group_idxs):
        np.testing.assert_array_equal(g, np.asarray(h))
    assert max(len(g) for g in ts.barostat.group_idxs) == n_p  # the protein, one group
    assert len(ts.potentials) == len(js.potentials)
    for tp, jp in zip(ts.potentials, js.potentials):
        _assert_rel(tp.params, jp.params)
    if lamb in (0.0, 1.0):
        assert ts.integrator.seed == js.integrator.seed


def test_run_complex_on_the_cpu(complex_edge, monkeypatch):
    """run_complex of the port at the JAX nightly test's depth (50
    equilibration steps, 4 frames of 20, 2 bisection frames, 3 windows)
    cut further: 35 FIRE steps a window, 20 NPT steps, BFGS capped at 10
    iterations, 5 equilibration steps, 2 frames of 5, 1 bisection frame.
    Every ΔG finite, every final frame finite, the host the helix's."""
    from timemachine_torch.fe.free_energy import HREXParams, MDParams
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.md import fire, minimizer

    monkeypatch.setattr(
        minimizer, "pre_equilibrate_host",
        functools.partial(minimizer.pre_equilibrate_host, minimizer_steps_per_window=35, equilibration_steps=20),
    )
    monkeypatch.setattr(
        trbfe, "_default_minimization_config",
        lambda: fire.ScipyMinimizationConfig(method="BFGS", options={"disp": False, "maxiter": 10}),
    )
    md = MDParams(n_frames=2, n_eq_steps=5, steps_per_frame=5, seed=2026, hrex_params=HREXParams(n_frames_bisection=1))
    ta, tb_ = complex_edge["tmols"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result, cfg = trbfe.run_complex(
            ta, tb_, complex_edge["core"], Forcefield.load_default(), complex_edge["pdb"], md_params=md, n_windows=3,
            min_cutoff=None, device="cpu",
        )
    fin = result.final_result
    assert len(fin.initial_states) == 3 and len(fin.dGs) == 2
    assert np.all(np.isfinite(fin.dGs)) and np.all(np.isfinite(fin.dG_errs))
    for traj in result.trajectories:
        assert np.all(np.isfinite(traj.frames[-1]))
    np.testing.assert_array_equal(cfg.box, complex_edge["tcfg"].box + 0.1 * np.eye(3))
    np.testing.assert_array_equal(cfg.conf, complex_edge["tcfg"].conf)
    assert fin.initial_states[0].protein_idxs.size == cfg.conf.shape[0] - cfg.num_water_atoms


def _jax_readable(topology, charges):
    """The JAX package's HostTopology with the port's residues' bonds as
    (i, j, order) rows and the charges set."""
    residues = [
        jb.HostResidue(r.name, r.atomic_nums, r.bonds if r.bond_orders is None else [(i, j, o) for (i, j), o in zip(r.bonds, r.bond_orders)])
        for r in topology.residues
    ]
    return jb.HostTopology(residues, topology.group_idxs, np.asarray(charges))


def test_env_bcc_matches_jax(complex_edge):
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.ff.envbcc import EnvironmentBCCHandler
    from timemachine_torch.ff.handlers import EnvironmentBCCPartialHandler
    from timemachine_tpu.ff.envbcc import EnvironmentBCCHandler as JHandler

    t = complex_edge["tcfg"]
    topo = t.host_topology
    handle = EnvironmentBCCPartialHandler(BCC_SMIRKS, BCC_PARAMS, None).get_env_handle(topo, Forcefield.load_default())
    assert isinstance(handle, EnvironmentBCCHandler) and handle.protein_ff_name == Forcefield.load_default().protein_ff
    q = handle.parameterize(handle.params)
    assert q.dtype == torch.float64 and q.shape == (t.conf.shape[0],)
    ref = JHandler(BCC_SMIRKS, BCC_PARAMS, "amber99sbildn", "tip3p", _jax_readable(topo, topo.charges)).parameterize(
        np.asarray(BCC_PARAMS)
    )
    np.testing.assert_allclose(q.numpy(), np.asarray(ref), rtol=TOL_BCC, atol=TOL_BCC)
    n_p = t.conf.shape[0] - t.num_water_atoms
    assert np.abs(q.numpy()[:n_p] - topo.charges[:n_p]).max() > 1e-3  # the corrections moved the protein's charges
    np.testing.assert_array_equal(q.numpy()[n_p:], topo.charges[n_p:])  # the waters' pass through
    assert abs(float(q.sum()) - float(topo.charges.sum())) < 1e-12  # each correction conserves charge
    # differentiable in the BCC parameters
    p = torch.tensor(BCC_PARAMS, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(handle.parameterize(p)[:n_p].pow(2).sum(), p)
    assert torch.all(torch.isfinite(g)) and torch.any(g != 0)


def test_jax_env_bcc_cannot_read_its_builders_record(complex_edge):
    """ROADMAP R14: JAX's handler on JAX's own builder record fails (pair
    bonds where Mol.from_arrays wants (i, j, order); charges None)."""
    from timemachine_tpu.ff.envbcc import EnvironmentBCCHandler as JHandler

    topo = complex_edge["jcfg"].host_topology
    assert topo.charges is None
    with pytest.raises((TypeError, ValueError)):
        JHandler(BCC_SMIRKS, BCC_PARAMS, "amber99sbildn", "tip3p", topo).parameterize(np.asarray(BCC_PARAMS))


def test_env_bcc_reaches_the_interaction_group(complex_edge):
    """A force field with an environment BCC handler: combine_with_host's
    ligand x environment group carries the corrected host charges."""
    from timemachine_torch.ff.handlers import EnvironmentBCCPartialHandler

    t, st = complex_edge["tcfg"], complex_edge["tst"]
    ff = replace(st.ff, env_bcc_handle=EnvironmentBCCPartialHandler(BCC_SMIRKS, BCC_PARAMS, None))
    plain = st.combine_with_host(t.host_system, 0.0, t.num_water_atoms, st.ff, t.host_topology)
    with_bcc = st.combine_with_host(t.host_system, 0.0, t.num_water_atoms, ff, t.host_topology)
    q_bcc = ff.env_bcc_handle.get_env_handle(t.host_topology, ff).parameterize(ff.env_bcc_handle.params).numpy()
    n_host = t.conf.shape[0]
    plain_q = plain.nonbonded_ixn_group.params.detach().numpy()[:n_host, 0]
    bcc_q = with_bcc.nonbonded_ixn_group.params.detach().numpy()[:n_host, 0]
    np.testing.assert_array_equal(bcc_q, q_bcc)
    assert not np.array_equal(bcc_q, plain_q)
    np.testing.assert_array_equal(with_bcc.nonbonded_all_pairs.params.detach().numpy(), plain.nonbonded_all_pairs.params.detach().numpy())
