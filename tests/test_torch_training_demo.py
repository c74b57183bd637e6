"""The port's forcefield-training demonstration
(timemachine_torch/optimize/training_demo.py) against the JAX package's
scripts/training_demo.py pieces, in float64 on the CPU, on ethanol at the
RBFE cache's conformer, at a toy depth: 2 walkers, 4 batches of 10 steps,
1 round of 5 Adam steps.

Tolerances: the demo's energies and the endpoint reweighting estimator's
value and d/ds against JAX's construct_endpoint_reweighting_estimator on
the same samples, 1e-10 relative; the Adam steps against Adam's formula
(Kingma & Ba's update with optax.adam's defaults, which torch.optim.Adam
shares) to 1e-12.
"""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

from timemachine_torch.chem import mol_from_smiles as t_mol_from_smiles
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.optimize import training_demo as td
from timemachine_torch.testsystems import rbfe_solvent

torch.set_num_threads(1)  # the suite's workers share the host's cores

jax.config.update("jax_enable_x64", True)

CPU = torch.device("cpu")
TOL_REL = 1e-10
TOY = td.DemoConfig(n_walkers=2, n_batches=4, steps_per_batch=10, n_rounds=1, steps_per_round=5)


def _conf():
    return np.asarray(rbfe_solvent.metadata(rbfe_solvent.load_arrays())["conf_a"])


@pytest.fixture(scope="module")
def demo():
    """The port's ethanol and energies, its toy run, and JAX's energies."""
    import jax.numpy as jnp
    from timemachine_tpu.chem import mol_from_smiles as j_mol_from_smiles
    from timemachine_tpu.constants import BOLTZ
    from timemachine_tpu.fe.topology import BaseTopology
    from timemachine_tpu.ff import Forcefield as JF

    t_mol = t_mol_from_smiles("CCO", add_hs=True, name="ethanol")
    j_mol = j_mol_from_smiles("CCO", add_hs=True, name="ethanol")
    for m in (t_mol, j_mol):
        m.set_conf(_conf())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        guest = BaseTopology(j_mol, JF.load_default()).setup_end_state()
    box = jnp.eye(3) * 100.0
    bonded = [guest.bond, guest.angle, guest.proper, guest.improper]
    nbpl = guest.nonbonded_pair_list
    params0 = jnp.asarray(nbpl.params)
    kT = BOLTZ * 300.0

    def u_total(x, scale):
        return sum(bp(x, box) for bp in bonded) + nbpl.potential(x, params0.at[:, 0].multiply(scale**2), box)

    def u_discharged(x):
        return sum(bp(x, box) for bp in bonded) + nbpl.potential(x, params0.at[:, 0].set(0.0), box)

    record = td.run_demo(t_mol, TF.load_default(), TOY, device=CPU, log=lambda s: None)
    return dict(t_mol=t_mol, energies=td.DemoEnergies(t_mol, TF.load_default(), device=CPU), record=record, kT=kT,
                j_batched=jax.jit(jax.vmap(u_total, in_axes=(0, None))))


def test_demo_energies_match_jax(demo):
    """u_total at three scales and discharged (scale 0) on the round's frames."""
    x = demo["record"]["samples"][0]["xs_a"]
    e = demo["energies"]
    for s in (0.0, 0.8, 1.25):
        t = e.batched(lambda y: e.u_total(y, s), x).numpy()
        np.testing.assert_allclose(t, np.asarray(demo["j_batched"](x, s)), rtol=TOL_REL, atol=0)
    np.testing.assert_array_equal(e.batched(e.u_discharged, x).numpy(), e.batched(lambda y: e.u_total(y, 0.0), x).numpy())


def test_estimator_value_and_gradient_match_jax(demo):
    """The round's estimator on the round's own frames: value and d/ds at
    three scales against JAX's estimator on the same frames."""
    import jax.numpy as jnp
    from timemachine_tpu.fe.reweighting import construct_endpoint_reweighting_estimator

    rnd = demo["record"]["samples"][0]
    xs_a, xs_b, scale, ref_df = rnd["xs_a"], rnd["xs_b"], rnd["scale"], rnd["ref_df"]
    est_t = td.endpoint_estimator(demo["energies"], xs_a, xs_b, scale, ref_df)
    kT = demo["kT"]
    j_batched = demo["j_batched"]
    est_j = construct_endpoint_reweighting_estimator(
        xs_a, xs_b, lambda xs, s: j_batched(jnp.asarray(xs), s) / kT, lambda xs, s: j_batched(jnp.asarray(xs), 0.0) / kT,
        scale, ref_df,
    )
    value_and_grad_j = jax.value_and_grad(est_j)
    for s in (scale, 1.0, 1.1):
        st = torch.tensor(s, dtype=torch.float64, requires_grad=True)
        value = est_t(st)
        (grad,) = torch.autograd.grad(value, st)
        v_j, g_j = value_and_grad_j(s)
        assert float(value.detach()) == pytest.approx(float(v_j), rel=TOL_REL)
        assert float(grad) == pytest.approx(float(g_j), rel=TOL_REL)
        if s == scale:
            assert demo["record"]["rounds"][0]["dest_ds_start"] == pytest.approx(float(g_j), rel=TOL_REL)


def test_adam_steps_follow_the_formula(demo):
    """train_round's 5 steps against Adam's update written out: m, v with
    b1 0.9, b2 0.999, bias-corrected, eps 1e-8, at the JAX script's lr."""
    rnd = demo["record"]["samples"][0]
    label = demo["record"]["label_df_kbt"]
    est = td.endpoint_estimator(demo["energies"], rnd["xs_a"], rnd["xs_b"], rnd["scale"], rnd["ref_df"])
    out = td.train_round(est, label, rnd["scale"], TOY)

    theta, m, v = rnd["scale"], 0.0, 0.0
    for t in range(1, TOY.steps_per_round + 1):
        st = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad((est(st) - label) ** 2, st)
        g = float(g)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        theta -= TOY.learning_rate * (m / (1 - 0.9**t)) / (np.sqrt(v / (1 - 0.999**t)) + 1e-8)
    assert out["scale"] == pytest.approx(theta, abs=1e-12)
    assert out["scale"] == demo["record"]["rounds"][0]["scale"]


def test_toy_demo_record(demo):
    r = demo["record"]
    assert r["mol"] == "ethanol" and r["scale_init"] == 1.25 and len(r["rounds"]) == TOY.n_rounds
    rnd = r["rounds"][0]
    numbers = [r["label_df_kbt"], r["label_err_kbt"], r["scale_final"]] + [v for v in rnd.values() if isinstance(v, float)]
    assert np.isfinite(numbers).all()
    assert rnd["loss_end"] <= rnd["loss_start"]
    assert abs(r["scale_final"] - 1.0) < 0.25
    frames = TOY.n_walkers * (TOY.n_batches - TOY.n_batches // 5)
    assert r["samples"][0]["xs_a"].shape == (frames, 9, 3)


def test_main_writes_only_where_given_a_path(tmp_path, monkeypatch, capsys):
    from timemachine_torch.chem import embed as tembed

    seeds = []
    monkeypatch.setattr(tembed, "embed_mol", lambda mol, seed: (seeds.append(seed), mol.set_conf(_conf())))
    args = ["--smiles", "CCO", "--walkers", "2", "--batches", "4", "--steps-per-batch", "10",
            "--rounds", "1", "--adam-steps", "2", "--device", "cpu"]
    monkeypatch.chdir(tmp_path)
    assert td.main(args) == 0
    assert list(tmp_path.iterdir()) == []
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["mol"] == "CCO" and "samples" not in record and seeds == [td.EMBED_SEED]
    out = tmp_path / "demo.json"
    assert td.main(args + ["--out", str(out)]) == 0
    assert json.loads(out.read_text())["label_df_kbt"] == record["label_df_kbt"]
