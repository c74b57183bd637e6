"""The all-pairs term's exact-erfc forms against timemachine_tpu's: the
dense form (JAX's impl="dense": exclusions as rescale masks, the atom
subset) and the block-tile configuration kernel="v1" under the subset
(JAX's impl="tiled", which it serves), on tests/test_torch_rbfe.py's small
RBFE windows (ethanol -> propane in a 2.6 nm water box, the host term over
the host atoms), in float64; the rule that picks the form at each call
site (potentials.all_pairs_kernel) against JAX's; the dense MD providers;
and the dense oracle's JAX signature.

Tolerances: both sides compute one float64 function in other summation
orders, so energy to 1e-10 relative, dU/dx to 1e-10 of its norm and dU/dp
to 1e-10 of each column's norm (measured 1e-16 to 1e-12). One column
differs by construction: JAX's dense and tiled select LJ on eps_ij != 0,
which zeroes dU/d sqrt(eps)_i on atoms with eps_i = 0 (the waters'
hydrogens), where the block-tile kernel's DP pass (as JAX's own Pallas
backward) gives the derivative; that column is compared on the atoms with
eps_i != 0 for v1.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_rbfe import HOST, small  # noqa: E402, F401  (small: the fixture)
from timemachine_torch import convert  # noqa: E402
from timemachine_torch.fe import free_energy as tfe  # noqa: E402
from timemachine_torch.md import minimizer as tm  # noqa: E402
from timemachine_torch.ops import nonbonded as tnb  # noqa: E402
from timemachine_torch.potentials import DENSE_LIMIT, SITES, Nonbonded, all_pairs_kernel  # noqa: E402

torch.set_num_threads(1)  # the suite's workers share the host's cores

F64 = torch.float64
TOL = 1e-10
WINDOW = 1  # λ 0.4: both end states' ligand atoms are half on


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_u_grads(bp, x, box, impl):
    """(u, dU/dx, dU/dp) of JAX's host term in `impl`, on a copy."""
    import jax
    import jax.numpy as jnp

    pot = copy.deepcopy(bp.potential)
    pot.set_impl(impl)
    if impl == "tiled":
        pot.configure_tiled(np.asarray(box), conf=np.asarray(x))
    u, (gx, gp) = jax.value_and_grad(pot, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(bp.params), jnp.asarray(box))
    return float(u), np.asarray(gx), np.asarray(gp)


def _port_u_grads(term, x, box, kernel):
    """(u, dU/dx, dU/dp) of the port's host term configured as `kernel`,
    on a copy: u and dU/dx from energy_force (closed form), dU/dp from u's
    autograd (the dense form's) or DP pass (v1's)."""
    term = copy.deepcopy(term)
    term.configure(_t(box), _t(x), kernel=kernel)
    assert term.kernel == kernel
    u, f = term.energy_force(_t(x), _t(box))
    p = term.params.clone().requires_grad_(True)
    term.u(_t(x), p, _t(box)).backward()
    return float(u), -f.numpy(), p.grad.numpy(), term


@pytest.mark.parametrize("kernel,impl", [("dense", "dense"), ("v1", "tiled")])
def test_host_term_matches_jax(small, kernel, impl):
    """The window's host term (Nonbonded with its exclusions, over the host
    atoms) configured as `kernel` against JAX's in `impl`: energy, dU/dx and
    dU/dp to 1e-10; the float64 minimizer entry (energy_force_f64) equals
    energy_force; the ligand atoms get no force and no dU/dp."""
    js, s = small["jax"][WINDOW], small["port"][WINDOW]
    jbp, term = js.potentials[HOST], s.potentials[HOST]
    assert isinstance(term, Nonbonded) and term.atom_idxs is not None and len(term.atom_idxs) < term.num_atoms
    u_j, gx_j, gp_j = _jax_u_grads(jbp, s.x0, s.box0, impl)
    u, gx, gp, conf_term = _port_u_grads(term, s.x0, s.box0, kernel)
    assert abs(u - u_j) <= TOL * abs(u_j)
    assert _rel(gx, gx_j) <= TOL
    eps_on = np.asarray(jbp.params)[:, 2] != 0
    for col in range(4):
        rows = eps_on if (col == 2 and kernel == "v1") else slice(None)
        norm = np.linalg.norm(gp_j[rows, col])
        assert np.linalg.norm(gp[rows, col] - gp_j[rows, col]) <= TOL * max(norm, 1e-300), col
    lig = np.asarray(s.ligand_idxs)
    assert not gx[lig].any() and not gp[lig].any()
    u64, f64 = conf_term.energy_force_f64(_t(s.x0), _t(s.box0))
    assert abs(float(u64) - u) <= 1e-12 * abs(u) and _rel(-f64.numpy(), gx) <= 1e-12


def test_dense_oracle_takes_jax_masks(small):
    """nonbonded_all_pairs_dense with JAX's signature (N x N rescale masks
    from the exclusions, atom_mask) equals JAX's function to 1e-12, and the
    DenseAllPairs form it shares its blocks with to 1e-12."""
    import jax.numpy as jnp
    from timemachine_tpu.ops import nonbonded as jnb

    js = small["jax"][WINDOW]
    pot, params = js.potentials[HOST].potential, np.asarray(js.potentials[HOST].params)
    n, x, box = pot.num_atoms, np.asarray(js.x0), np.asarray(js.box0)
    exc, scales = jnb.filter_exclusions(pot.atom_idxs, pot.exclusion_idxs, pot.scale_factors)
    q_mask, lj_mask = jnb.exclusions_to_rescale_masks(exc, scales, n)
    mask = np.zeros(n)
    mask[pot.atom_idxs] = 1.0
    u_j = float(jnb.nonbonded_all_pairs_dense(
        jnp.asarray(x), jnp.asarray(params), jnp.asarray(box), jnp.asarray(q_mask), jnp.asarray(lj_mask),
        pot.beta, pot.cutoff, atom_mask=jnp.asarray(mask),
    ))
    u = float(tnb.nonbonded_all_pairs_dense(
        _t(x), _t(params), _t(box), _t(q_mask), _t(lj_mask), pot.beta, pot.cutoff, _t(mask)
    ))
    dense = tnb.DenseAllPairs(n, pot.beta, pot.cutoff, exc, scales, atom_idxs=pot.atom_idxs)
    assert u == pytest.approx(u_j, rel=1e-12)
    assert float(dense.energy(_t(x), _t(params), _t(box))) == pytest.approx(u_j, rel=1e-12)


def test_dense_blocks_do_not_change_the_function(small, monkeypatch):
    """The dense form over row blocks of 2^12 and of 2^20 slots: the same
    energy and force to 1e-12 (only the summation order moves)."""
    s = small["port"][WINDOW]
    term = s.potentials[HOST]
    out = []
    for elements in (1 << 12, 1 << 20):
        monkeypatch.setitem(tnb.DENSE_BLOCK_ELEMENTS, "cpu", elements)
        t = copy.deepcopy(term).configure(_t(s.box0), _t(s.x0), kernel="dense")
        out.append(t.energy_force(_t(s.x0), _t(s.box0)))
    assert float(out[0][0]) == pytest.approx(float(out[1][0]), rel=1e-12)
    assert _rel(out[0][1], out[1][1]) <= 1e-12


def test_dense_md_providers(small):
    """The dense form's providers, which have no lists: the single one's
    force and energies are energy_force's (bitwise), its energy under other
    parameters is u's; the batched one, over the three windows as
    replicas, gives each replica its single-system force and energy (1e-12)
    and the (K, S) energies under every window's parameters (1e-12)."""
    states = small["port"]
    terms = [copy.deepcopy(st.potentials[HOST]).configure(_t(st.box0), _t(st.x0), kernel="dense") for st in states]
    t0, s0 = terms[0], states[0]
    x, box = _t(s0.x0), _t(s0.box0)
    init, apply, energy, rigid, energy_with_params = t0.md_force_provider()
    state = init(x, box)
    u_ef, f_ef = t0.energy_force(x, box)
    f, state = apply(state, x, box, 3)
    assert torch.equal(f, f_ef) and float(energy(state, x, box)) == float(u_ef) == float(rigid(state, x, box))
    p1 = terms[1].params
    assert float(energy_with_params(state, x, p1, box)) == float(t0.u(x, p1, box))
    xs = torch.stack([_t(st.x0) for st in states])
    boxes = torch.stack([_t(st.box0) for st in states])
    params = torch.stack([t.params for t in terms])
    b_init, b_apply, b_energy, _, b_energy_params = t0.md_force_provider_batched()
    b_state = b_init(xs, params, boxes)
    forces, b_state = b_apply(b_state, xs, params, boxes, 0)
    us = b_energy(b_state, xs, params, boxes)
    sets = params[None].expand(3, 3, -1, -1)
    u_sets = b_energy_params(b_state, xs, sets, boxes)
    for k, t in enumerate(terms):
        u_k, f_k = t.energy_force(xs[k], boxes[k])
        assert _rel(forces[k], f_k) <= 1e-12 and float(us[k]) == pytest.approx(float(u_k), rel=1e-12)
        for j in range(3):
            assert float(u_sets[k, j]) == pytest.approx(float(t0.u(xs[k], params[j], boxes[k])), rel=1e-12)


SIZES = (1_700, 6_404)
# (site, device, atoms): JAX's form there, written out from the JAX sources
# (device "cuda" standing for a backend other than the CPU), and the port's
# form. "context": free_energy.py:477-489 (get_context) and
# minimizer.py:219-234 (pre_equilibrate_host), configure_pallas off the CPU
# from 4,096 atoms; "host_du_dx": minimizer.py:123-130, set_impl("tiled")
# from 4,096 atoms on every backend; "minimize": minimizer.py:287, the fresh
# term's impl="dense" everywhere, which the port serves on the card from
# 4,096 atoms by "v1" (the same function in O(N)); "fresh": moves.py:148-161,
# enhanced.py:271-276 and absolute_hydration.py:104-108, a Context or an
# energy over potentials no configure_pallas touched, impl="dense" everywhere,
# served as "minimize" is.
RULE = {
    ("context", "cpu", 1_700): ("dense", "dense"),
    ("context", "cpu", 6_404): ("dense", "dense"),
    ("context", "cuda", 1_700): ("dense", "dense"),
    ("context", "cuda", 6_404): ("pallas", "rowscan"),
    ("host_du_dx", "cpu", 1_700): ("dense", "dense"),
    ("host_du_dx", "cpu", 6_404): ("tiled", "v1"),
    ("host_du_dx", "cuda", 1_700): ("dense", "dense"),
    ("host_du_dx", "cuda", 6_404): ("tiled", "v1"),
    ("minimize", "cpu", 1_700): ("dense", "dense"),
    ("minimize", "cpu", 6_404): ("dense", "dense"),
    ("minimize", "cuda", 1_700): ("dense", "dense"),
    ("minimize", "cuda", 6_404): ("dense", "v1"),
    ("fresh", "cpu", 1_700): ("dense", "dense"),
    ("fresh", "cpu", 6_404): ("dense", "dense"),
    ("fresh", "cuda", 1_700): ("dense", "dense"),
    ("fresh", "cuda", 6_404): ("dense", "v1"),
}


@pytest.mark.parametrize("num_atoms", SIZES)
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_kernel_rule_mirrors_jax(num_atoms, device):
    """all_pairs_kernel at each call site against RULE's port form, the
    table written out from the JAX sources; a device name is all the rule
    reads, so the card's rule is checked here without a card."""
    rows = {site: forms for (site, dev, n), forms in RULE.items() if dev == device and n == num_atoms}
    assert sorted(rows) == sorted(SITES)
    for site, (jax_form, port_form) in rows.items():
        assert all_pairs_kernel(site, num_atoms, torch.device(device)) == port_form, (site, jax_form)
    assert DENSE_LIMIT == 4096
    with pytest.raises(ValueError):
        all_pairs_kernel("neither", num_atoms, device)


def test_call_sites_take_the_rule_and_leave_fresh_terms_fresh(small):
    """On the CPU a fresh state's host term reads dense through a minimizer
    (get_val_and_grad_fn), which configures a copy and leaves the state's
    own term unconfigured, as JAX's stays impl="dense"; get_context then
    configures the state's term in place, dense on the CPU, as JAX's
    configure_pallas would off it; the minimizer then reads that form."""
    from timemachine_torch.md.minimizer import get_val_and_grad_fn

    s = convert.initial_state_from_jax(small["jax"][WINDOW], device="cpu", dtype=F64)
    assert s.potentials[HOST].kernel is None
    vg = get_val_and_grad_fn(s.potentials, s.box0)
    u, g = vg(s.x0)
    assert s.potentials[HOST].kernel is None
    ctxt = tfe.get_context(s)
    assert s.potentials[HOST].kernel == "dense" and ctxt.potentials[HOST].kernel == "dense"
    u2, g2 = get_val_and_grad_fn(s.potentials, s.box0)(s.x0)
    assert u2 == pytest.approx(u, rel=1e-12) and _rel(g2, g) <= 1e-12
    exact = tm.exact_modules(s.potentials, _t(s.x0), _t(s.box0))
    assert exact[HOST] is s.potentials[HOST]
