"""The committed cache of the solvent leg's 12 ethanol -> propane windows
(timemachine_torch/testsystems/cache/rbfe_solvent_ethanol_propane.npz,
written by `python tests/test_torch_rbfe.py --write-cache`) against the JAX
package.

The port's modules and the JAX package's potentials are built from the same
arrays at windows 0, 6 and 11: the exact-function terms' energies agree to
1e-10 relative in f64. The host term at 6,393 atoms is not recomputed
through JAX here (tests/test_torch_rbfe_masked.py holds its function);
its arrays must be what the JAX package's Nonbonded(atom_idxs=) keeps.
"""

import numpy as np
import pytest
import torch

from timemachine_torch.fe.free_energy import assert_potentials_compatible
from timemachine_torch.md.utils import sample_velocities
from timemachine_torch.testsystems import rbfe_solvent

torch.set_num_threads(1)  # the suite's workers share the host's cores

WINDOWS = (0, 6, 11)
EXACT = ("bond", "angle", "proper", "improper", "chiral_atom", "nonbonded_pair_list", "nonbonded_ixn_group")
ORDER = EXACT[:6] + ("nonbonded_all_pairs", "nonbonded_ixn_group")


@pytest.fixture(scope="module")
def cache():
    return rbfe_solvent.load_arrays()


@pytest.fixture(scope="module")
def states(cache):
    return {w: rbfe_solvent.initial_state(cache, w, device="cpu") for w in WINDOWS}


def test_cache_records_its_inputs(cache):
    """The writer's inputs: the SMILES, seeds, box and λ grid of the JAX
    package's solvent leg (fe/rbfe.py run_solvent, estimate_relative_free_energy
    with DEFAULT_MD_PARAMS' seed); the file stays under 8 MB; every v0 is
    redrawn from its seed (the writer checked the draw bitwise)."""
    meta = rbfe_solvent.metadata(cache)
    assert meta["smiles"].tolist() == ["CCO", "CCC"] and meta["names"].tolist() == ["ethanol", "propane"]
    assert int(meta["embed_seed"]) == 7 and int(meta["seed"]) == 2023
    assert float(meta["box_width"]) == 4.0 and float(meta["headroom"]) == 0.1 and float(meta["min_cutoff"]) == 0.7
    np.testing.assert_array_equal(meta["lambdas"], np.linspace(0.0, 1.0, 12))
    np.testing.assert_array_equal(cache["lamb"], meta["lambdas"])
    assert meta["conf_a"].shape == (9, 3) and meta["conf_b"].shape == (11, 3)
    assert rbfe_solvent.n_windows(cache) == 12 and (cache["v0_seed"] >= 0).all()
    assert rbfe_solvent.CACHE.stat().st_size < 8 * 2**20
    n = cache["masses"].shape[0]
    assert n > 6000 and len(cache["ligand_idxs"]) == n - len(cache["s_atom_idxs"])
    np.testing.assert_array_equal(cache["s_atom_idxs"], np.arange(n - len(cache["ligand_idxs"])))
    assert "s_box0" in cache and "w_x0" in cache  # one pre-equilibrated box, each window minimized apart


@pytest.mark.parametrize("w", WINDOWS)
def test_cache_exact_terms_match_jax(cache, states, w):
    """At windows 0, 6 and 11 each exact-function term of the port's state
    (bonded, chiral, the ligand's pairs, the interaction group) against the
    JAX potential built from the same arrays: energy to 1e-10 relative in
    f64; the state's potentials are in the JAX package's order, and the
    window's v0 is sample_velocities of its seed."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from timemachine_tpu import potentials as jp

    a = rbfe_solvent.window_arrays(cache, w)
    s = states[w]
    assert [type(p).__name__ for p in s.potentials] == [
        "HarmonicBond", "HarmonicAngle", "PeriodicTorsion", "PeriodicTorsion", "ChiralAtomRestraint",
        "NonbondedPairListPrecomputed", "Nonbonded", "NonbondedInteractionGroup",
    ]
    n = a["nb_params"].shape[0]
    j = {
        "bond": jp.HarmonicBond(a["bond_idxs"]).bind(a["bond_params"]),
        "angle": jp.HarmonicAngle(a["angle_idxs"]).bind(a["angle_params"]),
        "proper": jp.PeriodicTorsion(a["proper_idxs"]).bind(a["proper_params"]),
        "improper": jp.PeriodicTorsion(a["improper_idxs"]).bind(a["improper_params"]),
        "chiral_atom": jp.ChiralAtomRestraint(a["chiral_atom_idxs"]).bind(a["chiral_atom_params"]),
        "nonbonded_pair_list": jp.NonbondedPairListPrecomputed(
            a["pair_list_idxs"], float(a["pair_list_beta"]), float(a["pair_list_cutoff"])
        ).bind(a["pair_list_params"]),
        "nonbonded_ixn_group": jp.NonbondedInteractionGroup(
            n, a["ixn_row_idxs"], float(a["ixn_beta"]), float(a["ixn_cutoff"]), a["ixn_col_idxs"]
        ).bind(a["ixn_params"]),
    }
    x, box = torch.as_tensor(a["x0"]), torch.as_tensor(a["box0"])
    for term in EXACT:
        pot = s.potentials[ORDER.index(term)]
        u_j = float(j[term](jnp.asarray(a["x0"]), jnp.asarray(a["box0"])))
        assert float(pot.energy(x, box)) == pytest.approx(u_j, rel=1e-10, abs=1e-10), term
    np.testing.assert_array_equal(s.v0, sample_velocities(cache["masses"], float(cache["temperature"]), int(cache["v0_seed"][w])))


def test_cache_host_term_arrays(cache, states):
    """The host term's arrays at windows 0, 6 and 11 are the cache's, the
    same in every window (so a window's host energy is the same bits under
    its neighbours' parameters), and its exclusions are the ones the JAX
    package's Nonbonded(atom_idxs=) keeps; the three states are compatible
    for one reused Context."""
    from timemachine_tpu.ops.nonbonded import filter_exclusions

    assert {"s_nb_params", "s_excl_idxs", "s_excl_scales", "s_atom_idxs"} <= set(cache)
    exc, scales = filter_exclusions(cache["s_atom_idxs"], cache["s_excl_idxs"], cache["s_excl_scales"])
    for w in WINDOWS:
        nb = states[w].potentials[ORDER.index("nonbonded_all_pairs")]
        np.testing.assert_array_equal(nb.params.numpy(), cache["s_nb_params"])
        np.testing.assert_array_equal(torch.nonzero(nb.atom_mask).squeeze(1).numpy(), cache["s_atom_idxs"])
        nw = nb.num_waters
        kept = np.concatenate([np.stack([3 * np.arange(nw).repeat(3), 3 * np.arange(nw).repeat(3)], 1)
                               + np.tile([[0, 1], [0, 2], [1, 2]], (nw, 1)), nb.tail_idxs.numpy()])
        np.testing.assert_array_equal(kept, exc)
        np.testing.assert_array_equal(nb.tail_scales.numpy(), scales[3 * nw :])
        assert (scales[: 3 * nw] == 1.0).all()
    for w in WINDOWS[1:]:
        assert_potentials_compatible(states[0].potentials, states[w].potentials)
