"""The port's λ-chain coordinate optimization (timemachine_torch/fe/rbfe.py:
get_free_idxs, optimize_coordinates, get_nearest_state_idx,
optimize_initial_state_from_pre_optimized) against timemachine_tpu/fe/rbfe.py.

The windows are tests/test_torch_rbfe.py's three small ethanol -> propane
windows (a 2.6 nm water box, λ 0, 0.4 and 1), each package started from the
same coordinates. scipy's BFGS is capped at MAXITER iterations in both
packages (their default runs to convergence, 100-800 energy calls a window,
too long for the CPU sweep here). Each window passes the displacement check
at 0.7 nm, and the first of each λ chain its energy decrease, in both
packages (both functions assert them). Both packages' host term is the
dense exact-erfc form here, so BFGS walks one energy: the free atoms of the
two packages' results agree within COORD_TOL nm (measured 5.6e-14, 1.7e-13
and 2.7e-13 nm at λ 0, 0.4 and 1, and 1.6e-13 nm for the new state at λ
0.2, against moves of 0.14-0.17 nm from the start; 1.8e-4 to 7.4e-4 nm
while the port ran the rowscan polynomial, ROADMAP P11). Two port runs are
bitwise equal.

The float32 windows' minimizer energy (the card's mix for the minimizer at
4,096 atoms and up, named here explicitly on the CPU's plain sweep: the host
term configured kernel="v1", an f32 nb_tiles exact-erfc sweep whose per-atom
energies are summed in float64, the exclusions exact in float64 at the
f32-rounded coordinates, ROADMAP P22) against the same windows in float64
throughout (the CPU's dense form), at the start and the minimized
coordinates, in units of one float32 rounding of the all-pairs term
(2^-24 |U_all-pairs|, the noise a float32 total would put on every energy
BFGS compares): dU within U_ROUNDINGS of them (measured 0.59-0.81: the
water's rigid, identical pairs round alike in the f32 sweep, so their errors
add into an offset) and its change between the two coordinates, what BFGS
reads, within U_CHANGE_ROUNDINGS (measured 0.005-0.21); the gradient within
F32_GRAD_REL of the all-pairs force norm (the f32 sweep's force rounding, as
chip_smoke.py's TOL_FORCE_REL_NORM; measured 4.7e-7 to 4.9e-7).
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_rbfe import LAMBDAS_SMALL, TEMP, small  # noqa: E402, F401  (small: the fixture)
from timemachine_torch import convert  # noqa: E402
from timemachine_torch.fe import rbfe as trbfe  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores

MAXITER = 30
COORD_TOL = 1e-8
NEW_LAMB = 0.2
U_ROUNDINGS, U_CHANGE_ROUNDINGS = 2.0, 1.0
F32_GRAD_REL = 1e-5


def _config(fire_module):
    return fire_module.ScipyMinimizationConfig(method="BFGS", options={"disp": False, "maxiter": MAXITER})


@pytest.fixture(scope="module")
def optimized(small):
    """optimize_coordinates of both packages, and the port's twice."""
    from timemachine_tpu.fe import rbfe as jrbfe
    from timemachine_tpu.md import fire as jfire
    from timemachine_torch.md import fire as tfire

    j = jrbfe.optimize_coordinates(small["jax"], min_cutoff=0.7, minimization_config=_config(jfire))
    t = [trbfe.optimize_coordinates(small["port"], min_cutoff=0.7, minimization_config=_config(tfire)) for _ in range(2)]
    return dict(jax=[np.asarray(x) for x in j], port=t[0], again=t[1])


@pytest.mark.parametrize("cutoff", [0.5, 0.8])
@pytest.mark.parametrize("w", range(len(LAMBDAS_SMALL)))
def test_get_free_idxs_matches_jax(small, w, cutoff):
    from timemachine_tpu.fe import rbfe as jrbfe

    t = trbfe.get_free_idxs(small["port"][w], cutoff=cutoff)
    assert t == jrbfe.get_free_idxs(small["jax"][w], cutoff=cutoff)
    assert set(small["port"][w].ligand_idxs.tolist()) <= set(t)


@pytest.mark.parametrize("w", range(len(LAMBDAS_SMALL)))
def test_optimize_coordinates_matches_jax(small, optimized, w):
    """Each window is minimized from its chain's carry (λ 0.4 from λ 0's
    result; λ 0 and 1 from their own x0), only its free atoms moving."""
    state = small["port"][w]
    start = optimized["port"][0] if w == 1 else state.x0
    t, j = optimized["port"][w], optimized["jax"][w]
    free = trbfe.get_free_idxs(state)
    frozen = np.setdiff1d(np.arange(state.x0.shape[0]), free)
    np.testing.assert_array_equal(t[frozen], start[frozen])
    assert np.abs(t[free] - start[free]).max() > 2 * COORD_TOL
    np.testing.assert_allclose(t[free], j[free], rtol=0, atol=COORD_TOL)
    _, dist = trbfe.displacements(state, t)
    assert dist.max() < 0.7


def test_optimize_coordinates_lowers_each_chain_start_energy(small, optimized):
    """λ 0 starts the left chain, λ 1 the right: each minimized energy is
    below its start's (float64 energies of the port's own val_and_grad)."""
    from timemachine_torch.md import minimizer

    for w in (0, 2):
        s = small["port"][w]
        vg = minimizer.get_val_and_grad_fn(s.potentials, s.box0)
        assert vg(optimized["port"][w])[0] < vg(s.x0)[0]


@pytest.mark.parametrize("w", range(len(LAMBDAS_SMALL)))
def test_float32_window_energy_is_within_one_f32_rounding_of_float64(small, optimized, w):
    from timemachine_torch.md import minimizer
    from timemachine_torch.potentials import NonbondedAllPairs

    s32, s64 = small["port32"][w], small["port"][w]
    pots32 = copy.deepcopy(s32.potentials)
    all_pairs = next(p for p in pots32 if isinstance(p, NonbondedAllPairs))
    all_pairs.configure(torch.as_tensor(s64.box0, dtype=torch.float32), torch.as_tensor(s64.x0, dtype=torch.float32), kernel="v1")
    vg32 = minimizer.get_val_and_grad_fn(pots32, s64.box0)
    vg64 = minimizer.get_val_and_grad_fn(s64.potentials, s64.box0)
    d_u = []
    for x in (s64.x0, optimized["port"][w]):
        (u32, g32), (u64, g64) = vg32(x), vg64(x)
        with torch.no_grad():
            u_ap, f_ap = NonbondedAllPairs.energy_force_f64(all_pairs, torch.as_tensor(x), torch.as_tensor(s64.box0))
        rounding = 2.0**-24 * abs(float(u_ap))
        d_u.append(u32 - u64)
        assert abs(d_u[-1]) <= U_ROUNDINGS * rounding, (u32, u64, float(u_ap))
        assert np.linalg.norm(g32 - g64) <= F32_GRAD_REL * float(torch.linalg.vector_norm(f_ap))
    assert abs(d_u[1] - d_u[0]) <= U_CHANGE_ROUNDINGS * rounding, d_u


def test_optimize_coordinates_is_bitwise_reproducible(optimized):
    for a, b in zip(optimized["port"], optimized["again"], strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lamb", [0.0, 0.1, 0.39, 0.4, 0.45, 0.5, 0.51, 0.9, 1.0])
def test_get_nearest_state_idx_matches_jax(small, lamb):
    from timemachine_tpu.fe import rbfe as jrbfe

    assert trbfe.get_nearest_state_idx(lamb, small["port"]) == jrbfe.get_nearest_state_idx(lamb, small["jax"])


def test_optimize_initial_state_from_pre_optimized_matches_jax(small, optimized, monkeypatch):
    """A new state at λ 0.2 seeded from the optimized anchors (λ 0 is the
    nearest on its side) and minimized from the anchor's coordinates in both
    packages; a state at an anchor's λ is that anchor."""
    from timemachine_tpu.fe import rbfe as jrbfe
    from timemachine_tpu.md import fire as jfire
    from timemachine_tpu.md.builders import build_water_system
    from timemachine_torch.md import fire as tfire

    monkeypatch.setattr(jrbfe, "_default_minimization_config", lambda: _config(jfire))
    monkeypatch.setattr(trbfe, "_default_minimization_config", lambda: _config(tfire))
    j_anchors, t_anchors = [], []
    for w, (js, ts) in enumerate(zip(small["jax"], small["port"])):
        j_anchors.append(jrbfe.replace(js, x0=optimized["jax"][w]))
        t_anchors.append(trbfe.replace(ts, x0=optimized["port"][w]))
    st = small["st"]
    cfg = build_water_system(2.6, st.ff.water_ff, mols=[st.mol_a, st.mol_b])
    host = jrbfe.Host(cfg.host_system, cfg.masses, cfg.conf, cfg.box, cfg.num_water_atoms, cfg.host_topology)
    j_new = jrbfe.setup_initial_state(st, NEW_LAMB, host, TEMP, 2023)
    t_new = convert.initial_state_from_jax(j_new, device="cpu")
    j_out = jrbfe.optimize_initial_state_from_pre_optimized(j_new, j_anchors)
    t_out = trbfe.optimize_initial_state_from_pre_optimized(t_new, t_anchors)
    assert t_out is t_new and j_out is j_new
    free = trbfe.get_free_idxs(t_anchors[0])
    assert not np.array_equal(t_out.x0[free], t_anchors[0].x0[free])
    np.testing.assert_allclose(t_out.x0, np.asarray(j_out.x0), rtol=0, atol=COORD_TOL)
    assert trbfe.optimize_initial_state_from_pre_optimized(trbfe.replace(t_new, lamb=0.4), t_anchors) is t_anchors[1]
