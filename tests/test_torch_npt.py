"""The port's NPT main path on a small water box: HMR masses, FIRE, then
Langevin at 2.5 fs with a Monte Carlo barostat every 25 steps, all in f32
as on the card. The run stays finite, and how steps are split into calls
does not change the trajectory: 2 x 50 steps equal 1 x 100 bitwise (the
list state and both random streams carry across calls)."""

import numpy as np
import pytest
import torch

from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.fe.model_utils import apply_hmr
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.context import Context
from timemachine_torch.md.fire import FireMinimizationConfig, fire_minimize
from timemachine_torch.md.utils import sample_velocities
from timemachine_tpu.md.builders import build_water_system

torch.set_num_threads(1)  # the suite's workers share the host's cores


@pytest.fixture(scope="module")
def npt():
    cfg = host_config_from_jax(build_water_system(3.0), device="cpu", dtype=torch.float32)
    bps = cfg.host_system.get_U_fns()
    x0 = torch.as_tensor(cfg.conf, dtype=torch.float32)
    box = torch.as_tensor(cfg.box, dtype=torch.float32)
    cfg.host_system.nonbonded_all_pairs.configure(box, x0)
    x_min = fire_minimize(x0, lambda x: sum(p.energy_force(x, box)[1] for p in bps), FireMinimizationConfig(20))
    masses = apply_hmr(cfg.masses, cfg.host_system.bond.idxs.numpy())
    v0 = sample_velocities(masses, 300.0, seed=2028)

    def make_context():
        baro = MonteCarloBarostat(len(masses), 1.013, 300.0, cfg.group_idxs, 25, seed=2027)
        return Context(x_min, v0, box, LangevinIntegrator(300.0, 2.5e-3, 1.0, masses, seed=2026), bps, movers=[baro], device="cpu")

    return make_context, x_min, box


def test_npt_is_finite_and_chunking_invariant(npt):
    make_context, x_min, box = npt
    whole = make_context()
    frames, boxes = whole.multiple_steps(100, store_x_interval=50)
    split = make_context()
    split.multiple_steps(50)
    split.multiple_steps(50)

    assert frames.shape == (2, *x_min.shape) and boxes.shape == (2, 3, 3)
    np.testing.assert_array_equal(frames[-1], whole.get_x_t())
    for get in ("get_x_t", "get_v_t", "get_box"):
        np.testing.assert_array_equal(getattr(whole, get)(), getattr(split, get)())
    assert np.isfinite(whole.get_x_t()).all() and np.isfinite(whole.get_v_t()).all()
    st = whole.get_mover_states()[0]
    assert int(st.total_attempted) == 4 and int(st.total_accepted) == int(split.get_mover_states()[0].total_accepted)
    assert whole.get_box()[0, 0] != float(box[0, 0])  # some volume move was accepted
    assert np.abs(whole.get_x_t() - x_min.numpy()).max() > 0.01


def test_state_changes_drop_the_list_state(npt):
    make_context, x_min, box = npt
    ctxt = make_context()
    ctxt.multiple_steps(2)
    for change in (lambda: ctxt.set_x_t(x_min), lambda: ctxt.set_box(box), lambda: ctxt.set_params(
        [p.params.clone() for p in ctxt.potentials]
    )):
        assert ctxt._prov_states is not None
        change()
        assert ctxt._prov_states is None
        ctxt.multiple_steps(1)


def test_blown_up_state_raises(npt):
    make_context, x_min, _ = npt
    ctxt = make_context()
    x = x_min.clone()
    x[5] = torch.nan
    ctxt.set_x_t(x)
    with pytest.raises(RuntimeError, match="not finite"):
        ctxt.multiple_steps(1)
