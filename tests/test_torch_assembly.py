"""The port's scatter-free step pieces against timemachine_tpu: the shared
contribution plan (ops/assembly.py), the strided water paths of the bonded
terms and their generic counterparts (ops/bonded.py), the bonded terms'
energy_force and force_contribs, the exclusion tail's per-role
contributions (ops/nonbonded.py specific_pairs_force_contribs), and the
nonbonded term's split provider.

Inputs: the DHFR cache (23,558 atoms, waters first), JAX's
build_water_system, and a crop of DHFR (`dhfr_crop_arrays`: the waters and
protein atoms within 1.2 nm of the protein's centroid, 744 atoms in DHFR's
box, its terms kept where all their atoms are), all float64 on the CPU.

Tolerances: the plan's perm and starts equal JAX's exactly; every function
within 1e-12 of JAX's, relative to the largest |value| of JAX's output (the
same closed forms, summed in another order); the split provider's force
plus the plan's tail within 1e-12 of the unsplit term's (the same terms,
added in another order), its energies the unsplit ones bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch import potentials as tp
from timemachine_torch.convert import host_config_from_jax
from timemachine_torch.fe.system import HostSystem
from timemachine_torch.ops import assembly as tas
from timemachine_torch.ops import bonded as tb
from timemachine_torch.ops import nonbonded as tnb
from timemachine_torch.ops import rowscan_kernel as trs
from timemachine_torch.testsystems.dhfr import load_host_arrays, permute_host_arrays
from timemachine_tpu import potentials as jp
from timemachine_tpu.md.builders import build_water_system
from timemachine_tpu.ops import assembly as jas
from timemachine_tpu.ops import bonded as jb
from timemachine_tpu.ops import nonbonded as jnb

torch.set_num_threads(1)  # the suite's workers share the host's cores

F64 = torch.float64
TERMS = ("bond", "angle", "proper", "improper")
TOL = 1e-12


def dhfr_arrays():
    """The DHFR cache's arrays with the waters first (the main path's
    order), its float32 parameters widened to float64 so that both packages
    get the same inputs (JAX would keep float32 products of them)."""
    a = load_host_arrays()
    n = a["conf"].shape[0]
    n_p = n - int(a["num_water_atoms"])
    a = permute_host_arrays(a, np.concatenate([np.arange(n_p, n), np.arange(n_p)]))
    return {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in a.items()}


def dhfr_crop_arrays(radius: float = 1.2):
    """DHFR's waters (by their oxygen) and protein atoms within `radius` nm
    of the protein's centroid, waters first, in DHFR's box: every term and
    exclusion whose atoms all stay, renumbered."""
    a = dhfr_arrays()
    n, n_w = a["conf"].shape[0], int(a["num_water_atoms"])
    diag = np.diag(a["box"])
    d = a["conf"] - a["conf"][n_w:].mean(0)
    inside = np.linalg.norm(d - diag * np.round(d / diag), axis=1) < radius
    keep = inside.copy()
    keep[:n_w] = np.repeat(inside[:n_w:3], 3)
    idx = np.nonzero(keep)[0]
    remap = np.full(n, -1)
    remap[idx] = np.arange(idx.size)
    out = dict(a)
    for ik, pk in [(f"{t}_idxs", f"{t}_params") for t in TERMS] + [("excl_idxs", "excl_scales")]:
        ok = keep[a[ik]].all(1)
        out[ik], out[pk] = remap[a[ik][ok]].astype(np.int32), a[pk][ok]
    for k in ("nb_params", "conf", "masses"):
        out[k] = a[k][idx]
    out["num_water_atoms"] = np.array(int(keep[:n_w].sum()))
    return out


def jax_bound_potentials(a, impl: str = "dense"):
    """The JAX package's bound potentials of a host npz's arrays, in the
    port's HostSystem order."""
    n = a["nb_params"].shape[0]
    bps = [
        jp.HarmonicBond(a["bond_idxs"]).bind(a["bond_params"]),
        jp.HarmonicAngle(a["angle_idxs"]).bind(a["angle_params"]),
        jp.PeriodicTorsion(a["proper_idxs"]).bind(a["proper_params"]),
        jp.PeriodicTorsion(a["improper_idxs"]).bind(a["improper_params"]),
    ]
    nb = jp.Nonbonded(n, a["excl_idxs"], a["excl_scales"], float(a["beta"]), float(a["cutoff"]), impl=impl)
    return bps + [nb.bind(a["nb_params"])]


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(port - ref).max() <= tol * scale, (np.abs(port - ref).max(), scale)


@pytest.fixture(scope="module")
def dhfr():
    a = dhfr_arrays()
    return a, HostSystem.from_arrays(a, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def crop():
    a = dhfr_crop_arrays()
    hs = HostSystem.from_arrays(a, device="cpu", dtype=F64)
    hs.nonbonded_all_pairs.configure(_t(a["box"]), _t(a["conf"]), rowscan_has_w=False)
    return a, hs


def _jax_tail(a):
    exc, scales = a["excl_idxs"], a["excl_scales"]
    nw = jnb.leading_water_exclusions(exc, scales)
    return exc[3 * nw :], scales[3 * nw :]


def test_plan_indices_equal_jax_on_dhfr(dhfr):
    """build_contrib_plan's perm and starts on DHFR's groups (the bonded
    tails past the leading waters, in term order, then the exclusion tail)
    equal JAX's exactly; assemble_forces of random contributions is JAX's
    within 1e-12."""
    a, hs = dhfr
    port_groups, jax_groups = [], []
    for term, bp in zip(hs.get_U_fns()[:4], jax_bound_potentials(a)[:4]):
        port_groups += term.force_contribs()[0]
        jax_groups += bp.potential.force_contribs()[0]
    port_groups.append(hs.nonbonded_all_pairs.tail_idxs.numpy())
    jax_groups.append(_jax_tail(a)[0])
    n = a["conf"].shape[0]
    assert [g.shape for g in port_groups] == [g.shape for g in jax_groups]
    assert [g.shape[0] for g in port_groups] == [16569 - 2 * 7024, 11584 - 7024, 6644, 502, 34709 - 3 * 7023]
    plan = tas.build_contrib_plan(port_groups, n, device="cpu")
    ref = jas.build_contrib_plan(jax_groups, n)
    np.testing.assert_array_equal(plan.perm, ref.perm)
    np.testing.assert_array_equal(plan.starts, ref.starts)
    assert plan.group_shapes == ref.group_shapes

    rng = np.random.default_rng(2031)
    contribs = [[rng.normal(0, 100.0, (g.shape[0], 3)) for _ in range(g.shape[1])] for g in port_groups]
    port = tas.assemble_forces(plan, [[_t(c) for c in group] for group in contribs])
    _close(port, jas.assemble_forces(ref, [[jnp.asarray(c) for c in group] for group in contribs]))
    assert torch.equal(port, tas.assemble_forces(plan, [[_t(c) for c in group] for group in contribs]))


def test_plan_sentinel_and_empty_atoms():
    """Padding rows (any -1) sort past the last atom as in JAX; atoms no
    contribution reaches get zero force."""
    groups = [np.array([[0, 2], [-1, 1], [2, 0]]), np.array([[2, 2, 0]])]
    plan = tas.build_contrib_plan(groups, 4, device="cpu")
    ref = jas.build_contrib_plan(groups, 4)
    np.testing.assert_array_equal(plan.perm, ref.perm)
    np.testing.assert_array_equal(plan.starts, ref.starts)
    rng = np.random.default_rng(5)
    contribs = [[rng.normal(size=(3, 3)) for _ in range(2)], [rng.normal(size=(1, 3)) for _ in range(3)]]
    contribs[0][0][1] = contribs[0][1][1] = 0.0  # a padding term's contributions are zero, as JAX requires
    port = tas.assemble_forces(plan, [[_t(c) for c in g] for g in contribs])
    _close(port, jas.assemble_forces(ref, [[jnp.asarray(c) for c in g] for g in contribs]))
    assert not port[3].any() and not port[1].any()
    with pytest.raises(ValueError):
        tas.assemble_forces(plan, [])


def _water_system():
    cfg = build_water_system(2.6)
    port = host_config_from_jax(cfg, device="cpu", dtype=F64)
    return cfg, port


@pytest.mark.parametrize("system", ["water", "dhfr"])
def test_water_paths_equal_jax(system, dhfr):
    """water_bond_energy_force and water_angle_energy_force on every leading
    water, the leading-water counts, and the generic bond, angle and
    torsion paths on the rest, each within 1e-12 of JAX's."""
    if system == "water":
        cfg, port = _water_system()
        a = {f"{t}_idxs": np.asarray(getattr(cfg.host_system, t).potential.idxs) for t in TERMS}
        a.update({f"{t}_params": np.asarray(getattr(cfg.host_system, t).params) for t in TERMS})
        # the builder's waters sit at their minimum: jitter them off it
        conf = np.asarray(cfg.conf, np.float64) + np.random.default_rng(11).normal(0, 0.005, cfg.conf.shape)
        box = np.asarray(cfg.box, np.float64)
    else:
        a = dhfr[0]
        conf, box = a["conf"], a["box"]
    x, b = _t(conf), _t(box)
    nw, na = tb._leading_water_bonds(a["bond_idxs"]), tb._leading_water_angles(a["angle_idxs"])
    assert nw == jb._leading_water_bonds(a["bond_idxs"]) and na == jb._leading_water_angles(a["angle_idxs"])
    # DHFR's first protein bonds and angle happen to follow the water pattern, in JAX too
    assert (nw, na) == ((585, 585) if system == "water" else (7024, 7024))
    for port_fn, jax_fn, params, nw in (
        (tb.water_bond_energy_force, jb.water_bond_energy_force, a["bond_params"][: 2 * nw], nw),
        (tb.water_angle_energy_force, jb.water_angle_energy_force, a["angle_params"][:na], na),
    ):
        u, f = port_fn(x, _t(params), nw)
        ju, jf = jax_fn(jnp.asarray(conf), jnp.asarray(params), nw)
        _close(u, ju)
        _close(f, jf)
    if system == "water":
        return
    for port_fn, jax_fn, key, rows in (
        (tb.generic_bond_energy_force, jb.generic_bond_energy_force, "bond", 2 * nw),
        (tb.generic_angle_energy_force, jb.generic_angle_energy_force, "angle", na),
        (tb.torsion_energy_force, jb.torsion_energy_force, "proper", 0),
        (tb.torsion_energy_force, jb.torsion_energy_force, "improper", 0),
    ):
        idxs, params = a[f"{key}_idxs"][rows:], a[f"{key}_params"][rows:]
        u, f = port_fn(x, _t(params), b, torch.as_tensor(idxs.astype(np.int64)))
        ju, jf = jax.jit(lambda c, p, bx, fn=jax_fn, ii=idxs: fn(c, p, bx, ii))(
            jnp.asarray(conf), jnp.asarray(params), jnp.asarray(box)
        )
        _close(u, ju)
        _close(f, jf)


def test_water_angle_agrees_with_stable_angle_at_dhfr_geometry(dhfr):
    """The strided water angle (arccos, clipped at 1 -+ 1e-7) and the
    generic eps-aware path agree at DHFR's water geometry, away from the
    clip, as JAX's tests/test_pbc_bonded_stability.py holds them."""
    a = dhfr[0]
    nw = tb._leading_water_angles(a["angle_idxs"])
    x, params = _t(a["conf"]), _t(a["angle_params"][:nw])
    u, f = tb.water_angle_energy_force(x, params, nw)
    ug, fg = tb.generic_angle_energy_force(x, params, None, torch.as_tensor(a["angle_idxs"][:nw].astype(np.int64)))
    _close(u, ug)
    _close(f, fg)


def test_bonded_terms_energy_force_and_contribs_equal_jax(dhfr):
    """Each of DHFR's bonded terms: energy_force (and energy_force_fn) within
    1e-12 of JAX's energy_force_fn, and force_contribs' groups equal and
    contributions and strided force within 1e-12 of JAX's."""
    a, hs = dhfr
    conf, box = jnp.asarray(a["conf"]), jnp.asarray(a["box"])
    x, b = _t(a["conf"]), _t(a["box"])
    for term, bp in zip(hs.get_U_fns()[:4], jax_bound_potentials(a)[:4]):
        u, f = term.energy_force(x, b)
        ju, jf = jax.jit(bp.potential.energy_force_fn())(conf, bp.params, box)
        _close(u, ju)
        _close(f, jf)
        assert torch.equal(term.energy_force_fn()(x, term.params, b)[1], f)
        (groups, fn), (jgroups, jfn) = term.force_contribs(), bp.potential.force_contribs()
        np.testing.assert_array_equal(groups[0], jgroups[0])
        (cs,), extra = fn(x, term.params, b)
        (jcs,), jextra = jax.jit(jfn)(conf, bp.params, box)
        assert len(cs) == len(jcs)
        for c, jc in zip(cs, jcs):
            _close(c, jc)
        assert (extra is None) == (jextra is None)
        if extra is not None:
            _close(extra, jextra)


def test_pure_water_and_empty_terms_have_no_contribs():
    """A pure-water term has no contributions (the strided path is the whole
    term), nor has an empty one, as in JAX; energy_force_fn is None for the
    empty one only."""
    _, port = _water_system()
    bond, angle, proper, _ = port.host_system.get_U_fns()[:4]
    assert bond.force_contribs() is None and angle.force_contribs() is None
    assert bond.num_waters == angle.num_waters == 585 and bond.energy_force_fn() is not None
    assert proper.idxs.shape[0] == 0 and proper.force_contribs() is None and proper.energy_force_fn() is None


def test_specific_pairs_force_contribs_equal_jax(dhfr):
    """The exclusion tail's per-role contributions with the rowscan
    polynomial, and the leading waters' exclusion gradient, on DHFR, within
    1e-12 of JAX's (specific_pairs_force_contribs; the gradient of
    water_exclusion_energy with the same series)."""
    a = dhfr[0]
    tail, scales = _jax_tail(a)
    beta, cutoff = float(a["beta"]), float(a["cutoff"])
    h = trs.es_energy_force_series(beta, cutoff)[0]
    x, p, b = _t(a["conf"]), _t(a["nb_params"]), _t(a["box"])
    u, (f_l, f_r) = tnb.specific_pairs_force_contribs(
        x, p, b, torch.as_tensor(tail.astype(np.int64)), beta, cutoff, _t(scales), h
    )
    conf, params, box = jnp.asarray(a["conf"]), jnp.asarray(a["nb_params"]), jnp.asarray(a["box"])
    ju, (jf_l, jf_r) = jax.jit(
        lambda c, p, bx: jnb.specific_pairs_force_contribs(c, p, bx, tail, beta, cutoff, jnp.asarray(scales), np.asarray(h))
    )(conf, params, box)
    _close(u, ju)
    _close(f_l, jf_l)
    _close(f_r, jf_r)
    nw = jnb.leading_water_exclusions(a["excl_idxs"], a["excl_scales"])
    g = tnb.water_exclusion_energy_force(x, p, b, nw, cutoff, h)[1]
    jg = jax.jit(jax.grad(
        lambda c: jnb.water_exclusion_energy(c, params, box, nw, beta, cutoff, es_poly_coeffs=np.asarray(h))
    ))(conf)
    _close(g, jg)


def test_split_provider_is_the_unsplit_term(crop):
    """On the crop (rowscan, its plain sweep here): the split provider's
    force plus the plan's assembly of the tail's contributions equals the
    unsplit md_force_provider's force and Nonbonded.energy_force within
    1e-12; every energy of the split provider is the unsplit one's,
    bitwise."""
    a, hs = crop
    nb = hs.nonbonded_all_pairs
    x, b = _t(a["conf"]), _t(a["box"])
    provider, groups, tail_fn = nb.md_force_provider_split()
    full = nb.md_force_provider()
    np.testing.assert_array_equal(groups[0], nb.tail_idxs.numpy())
    assert nb.num_waters > 0 and groups[0].shape[0] > 0
    state = provider[0](x, b)
    f_split, _ = provider[1](state, x, b, 1)
    contribs, extra = tail_fn(x, nb.params, b)
    assert extra is None
    plan = tas.build_contrib_plan(groups, x.shape[0], device="cpu")
    f_total = f_split + tas.assemble_forces(plan, contribs)
    f_full, _ = full[1](state, x, b, 1)
    _close(f_total, f_full)
    _close(f_total, nb.energy_force(x, b)[1])
    params2 = nb.params * torch.tensor([0.9, 1.0, 1.1, 1.0], dtype=F64)
    for k, args in ((2, (state, x, b)), (3, (state, x, b)), (4, (state, x, params2, b))):
        assert torch.equal(provider[k](*args), full[k](*args))


def test_split_and_sorted_are_declined_where_jax_declines(crop):
    """md_force_provider_split is None without a polynomial series (v1,
    dense) or without an exclusion tail; md_force_provider_sorted is None
    but for the rowscan configuration, as in JAX."""
    a, _ = crop
    x, b = _t(a["conf"]), _t(a["box"])
    for kernel in ("gather", "v1", "dense"):
        nb = HostSystem.from_arrays(a, device="cpu", dtype=F64).nonbonded_all_pairs
        nb.configure(b, x, kernel=kernel)
        assert nb.md_force_provider_sorted() is None
        assert (nb.md_force_provider_split() is None) == (kernel != "gather")
    water = _water_system()[1].host_system.nonbonded_all_pairs
    water.configure(_t(_water_system()[0].box), _t(_water_system()[0].conf))
    assert water.tail_idxs.shape[0] == 0 and water.md_force_provider_split() is None
    info = water.md_force_provider_sorted()
    assert info is not None and info.canonical_force is not None and info.rebuild_interval == tp.REBUILD_INTERVAL
    ap = tp.NonbondedAllPairs(a["conf"].shape[0], 2.0, 1.2, a["nb_params"], device="cpu")
    ap.configure(b, x)
    assert ap.md_force_provider_sorted().canonical_force is None
