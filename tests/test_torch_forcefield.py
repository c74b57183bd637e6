"""The port's force field (timemachine_torch/ff) against timemachine_tpu/ff:
every default handler's parameters within 1e-12 relative (to each column's
largest |value|) with equal index arrays on ethanol, propane, toluene,
phenol and acetate; the exclusion list equal in order; the gradient of a
charge loss and of an LJ loss through torch autograd within 1e-10 of
jax.grad; every shipped force field JSON deserializes to the same handlers.
Where AM1 cannot run (a degenerate conformer), the base charges are JAX's
Gasteiger charges bitwise, with a GasteigerFallbackWarning, and the AM1CCC
handler's charges on them within 1e-12 relative of JAX's handler given the
same base charges; under TM_STRICT_CHARGES=1 the fallback is an error."""

import base64
import pickle
import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_chem import QM_PANEL, mol_pair
from timemachine_torch.ff import Forcefield as TF
from timemachine_torch.ff import handlers as th
from timemachine_torch.ff.serialize import builtin_params_dir
from timemachine_tpu import constants as jconstants
from timemachine_tpu.ff import Forcefield as JF
from timemachine_tpu.ff import handlers as jh
from timemachine_tpu.ff.gasteiger import gasteiger_charges as jax_gasteiger_charges

torch.set_num_threads(1)  # the suite's workers share the host's cores

HANDLES = ("hb_handle", "ha_handle", "pt_handle", "it_handle", "lj_handle", "lj_handle_intra", "q_handle", "q_handle_intra")
REL = 1e-12
GRAD_TOL = 1e-10


@pytest.fixture(scope="module")
def ffs():
    return JF.load_default(), TF.load_default()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_rel(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if ref.size:
        scale = np.maximum(np.abs(ref).reshape(len(ref), -1).max(0), np.finfo(np.float64).tiny)
        assert (np.abs(got - ref).reshape(len(ref), -1) / scale).max() <= tol


@pytest.mark.parametrize("handle", HANDLES)
@pytest.mark.parametrize("smiles", QM_PANEL)
def test_default_handler_parameters_match_jax(ffs, smiles, handle):
    jf, tf = ffs
    j, t = mol_pair(smiles)
    ref, got = getattr(jf, handle).parameterize(j), getattr(tf, handle).parameterize(t)
    if isinstance(ref, tuple):
        np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
        assert got[1].dtype == np.asarray(ref[1]).dtype
        ref, got = ref[0], got[0]
    _assert_rel(got, ref, REL)


@pytest.mark.parametrize("smiles", QM_PANEL)
def test_exclusions_match_jax_in_order(smiles):
    j, t = mol_pair(smiles)
    for scales in ((1.0, 1.0, 0.5, 0.5), (0.0, 0.5, 0.8, 0.3)):
        ji, js = jh.generate_exclusion_idxs(j, *scales)
        ti, ts = th.generate_exclusion_idxs(t, *scales)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("smiles", QM_PANEL)
def test_charge_and_lj_loss_gradients_match_jax(ffs, smiles):
    """dL/dθ of L = Σ w_i q_i(θ)^2 (the AM1CCC handler's bond increments)
    and of L = Σ w_i σ_i ε_i (the LJ handler's table), numpy-made weights."""
    import jax
    import jax.numpy as jnp

    jf, tf = ffs
    j, t = mol_pair(smiles)
    w = np.random.default_rng(0).uniform(0.5, 1.5, t.num_atoms)
    wj, wt = jnp.asarray(w), torch.tensor(w)
    for jhandle, thandle, loss in (
        (jf.q_handle, tf.q_handle, lambda p, w: (p**2 * w).sum()),
        (jf.lj_handle, tf.lj_handle, lambda p, w: (p[:, 0] * p[:, 1] * w).sum()),
    ):
        theta = np.asarray(thandle.params)
        ref = jax.grad(lambda th_: loss(jnp.asarray(jhandle.partial_parameterize(th_, j)), wj))(jnp.asarray(theta))
        th_t = torch.tensor(theta, requires_grad=True)
        loss(thandle.partial_parameterize(th_t, t), wt).backward()
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(th_t.grad.numpy(), np.asarray(ref), rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("path", sorted(builtin_params_dir().glob("*.json")), ids=lambda p: p.name)
def test_builtin_forcefields_deserialize_as_in_jax(path):
    jf, tf = JF.load_from_file(path.name), TF.load_from_file(path.name)
    assert (tf.protein_ff, tf.water_ff) == (jf.protein_ff, jf.water_ff)
    for jhandle, thandle in zip(jf.get_ordered_handles(), tf.get_ordered_handles()):
        assert type(thandle).__name__ == type(jhandle).__name__
        if jhandle is not None:
            assert list(thandle.smirks) == list(jhandle.smirks)
            np.testing.assert_array_equal(np.asarray(thandle.params), np.asarray(jhandle.params))
    assert tf.serialize(fmt="json") == jf.serialize(fmt="json")


def _degenerate_pair(smiles):
    """(JAX Mol, port Mol); the port's has every atom at the origin, so its
    AM1 SCF cannot run (am1_mol_charges raises on a degenerate conformer)."""
    j, t = mol_pair(smiles)
    t.set_conf(np.zeros((t.num_atoms, 3)))
    return j, t


@pytest.mark.parametrize("smiles", QM_PANEL)
def test_gasteiger_fallback_matches_jax(ffs, monkeypatch, smiles):
    """Without AM1 the base charges are JAX's gasteiger_charges scaled by
    sqrt(ONE_4PI_EPS0), bitwise, with one GasteigerFallbackWarning; they are
    cached under GasteigerCache (never an AM1 key) and read back silently;
    the AM1CCC handler's charges on them are JAX's handler's on the same base
    charges within 1e-12 relative."""
    monkeypatch.delenv("TM_STRICT_CHARGES", raising=False)
    jf, tf = ffs
    j, t = _degenerate_pair(smiles)
    with pytest.warns(th.GasteigerFallbackWarning):
        q = th.compute_or_load_base_charges(t, mode=tf.q_handle.base_mode)
    ref = jax_gasteiger_charges(j) * np.sqrt(jconstants.ONE_4PI_EPS0)
    np.testing.assert_array_equal(q, ref)
    assert th.GASTEIGER_CHARGE_CACHE in t.props
    assert not any(k in t.props for k in (th.AM1_CHARGE_CACHE, th.AM1ELF10_CHARGE_CACHE, th.AM1BCC_CHARGE_CACHE))
    j.props[f"{jf.q_handle.base_mode}Cache"] = base64.b64encode(pickle.dumps(list(ref)))
    with warnings.catch_warnings():
        warnings.simplefilter("error", th.GasteigerFallbackWarning)
        np.testing.assert_array_equal(th.compute_or_load_base_charges(t, mode=tf.q_handle.base_mode), q)
        _assert_rel(tf.q_handle.parameterize(t), jf.q_handle.parameterize(j), REL)


@pytest.mark.parametrize("smiles", QM_PANEL)
def test_strict_mode_refuses_the_gasteiger_fallback(ffs, monkeypatch, smiles):
    """TM_STRICT_CHARGES=1: where AM1 cannot run, base charges and the AM1CCC
    handler raise MissingBaseChargesError and warn nothing; Gasteiger charges
    cached by an earlier call without strict mode are refused too; a molecule
    with supplied charges, or with a real conformer (AM1), passes silently."""
    _, tf = ffs
    _, t = _degenerate_pair(smiles)
    monkeypatch.setenv("TM_STRICT_CHARGES", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error", th.GasteigerFallbackWarning)
        with pytest.raises(th.MissingBaseChargesError):
            th.compute_or_load_base_charges(t)
        with pytest.raises(th.MissingBaseChargesError):
            tf.q_handle.parameterize(t)
        assert th.GASTEIGER_CHARGE_CACHE not in t.props
        monkeypatch.delenv("TM_STRICT_CHARGES")
        with pytest.warns(th.GasteigerFallbackWarning):
            th.compute_or_load_base_charges(t)
        monkeypatch.setenv("TM_STRICT_CHARGES", "1")
        with pytest.raises(th.MissingBaseChargesError):
            th.compute_or_load_base_charges(t)
        _, supplied = _degenerate_pair(smiles)
        supplied.props["PartialCharges"] = " ".join("0.01" for _ in range(supplied.num_atoms))
        np.testing.assert_array_equal(
            th.compute_or_load_base_charges(supplied), np.full(supplied.num_atoms, 0.01) * np.sqrt(jconstants.ONE_4PI_EPS0)
        )
        _, real = mol_pair(smiles)
        assert np.isfinite(th.compute_or_load_base_charges(real)).all()
        assert th.AM1ELF10_CHARGE_CACHE in real.props and th.GASTEIGER_CHARGE_CACHE not in real.props
