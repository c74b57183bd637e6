"""The port's cheminformatics (timemachine_torch/chem, graph_utils) against
timemachine_tpu's: the SMILES panel of tests/test_chem.py parsed by both
packages must give the same atoms, bonds, bond orders (the Kekulé structure
too), aromatic atoms and bonds under "mdl" and "am1bcc", ring sets and SMARTS
matches, exactly. graph_utils' traversals are held to networkx's orders on
numpy-made random graphs.

Also the shared inputs of the alchemy tests (tests/test_torch_qm.py,
test_torch_forcefield.py, test_torch_atom_mapping.py,
test_torch_single_topology.py): conformers embedded once by the JAX package
at seed 7 and handed to both packages, and the ethanol -> propane
conformers the RBFE cache records.
"""

from functools import lru_cache

import networkx as nx
import numpy as np
import pytest
import torch

from timemachine_torch import chem as tchem
from timemachine_torch import graph_utils as gu
from timemachine_tpu import chem as jchem

torch.set_num_threads(1)  # the suite's workers share the host's cores

PANEL = (
    "CCO", "[NH4+]", "CC(=O)[O-]", "c1ccccc1", "c1ccncc1", "c1cc[nH]c1", "c1ccc2ccccc2c1", "C1CC1", "c1ccoc1",
    "C1CCCCC1", "C1=CCC=CC1", "O=c1cccc[nH]1", "c1ccsc1", "c1c[nH]cn1", "CC=CC#N", "Cc1ccccc1", "C1CC1C",
    "CC(=O)OC", "CCCC", "CC(=O)N",
)  # every SMILES of tests/test_chem.py:11-157
PATTERNS = (
    "[#6]", "[#8]", "[#8-1]", "[#8+0]", "[#6X3]", "[#6X4]", "[#6H3]", "[!#1]", "[#6,#8]", "[#6]=[#6]", "[#6]#[#7]",
    "[#6]~[#6]", "[#6:1]=[#6:2]", "[#6:2]=[#6:1]", "[a]", "[#6a]", "[A;!#1]", "[ar6]", "[r6]", "[#6]:[#6]",
    "[#6]-@[#6]", "[#6]-!@[#6]", "[#6$(*=[#8])]", "[#8X2$(*-[#6]=[#8])]", "[#6:1]~[#6:2]~[#6:3]~[#6:4]",
    "[*:1]~[#6X3:2](~[*:3])~[*:4]",
)  # the SMARTS patterns of the same tests

# the alchemy tests' molecules: the RBFE edge, a ring edge and a charged one
EDGE = ("CCO", "CCC")
RING_EDGE = ("Cc1ccccc1", "Oc1ccccc1")
QM_PANEL = ("CCO", "CCC", "Cc1ccccc1", "Oc1ccccc1", "CC(=O)[O-]")
EMBED_SEED = 7


@lru_cache(maxsize=None)
def conformer(smiles: str) -> np.ndarray:
    """The molecule's conformer in nm: the RBFE cache's for the edge's
    ligands, else the JAX package's embedding at EMBED_SEED."""
    from timemachine_torch.testsystems import rbfe_solvent

    meta = rbfe_solvent.metadata(rbfe_solvent.load_arrays())
    if smiles in EDGE:
        return np.asarray(meta["conf_a" if smiles == EDGE[0] else "conf_b"])
    from timemachine_tpu.chem.embed import embed_mol

    return np.asarray(embed_mol(jchem.mol_from_smiles(smiles, add_hs=True), seed=EMBED_SEED).get_conf())


def mol_pair(smiles: str, name: str = ""):
    """(JAX Mol, port Mol) with explicit hydrogens and the same conformer."""
    mols = jchem.mol_from_smiles(smiles, add_hs=True, name=name), tchem.mol_from_smiles(smiles, add_hs=True, name=name)
    for m in mols:
        m.set_conf(conformer(smiles))
    return mols


def _atoms(m):
    return [(a.atomic_num, a.formal_charge, a.implicit_h) for a in m.atoms]


def _bonds(m):
    return [(b.src, b.dst, b.order) for b in m.bonds]


@pytest.mark.parametrize("add_hs", [False, True])
@pytest.mark.parametrize("smiles", PANEL)
def test_smiles_panel_matches_jax(smiles, add_hs):
    """Atoms, bonds and orders in order, ring sets, aromaticity under both
    models and every panel pattern's matches: exactly the JAX package's."""
    j, t = jchem.mol_from_smiles(smiles, add_hs=add_hs), tchem.mol_from_smiles(smiles, add_hs=add_hs)
    assert _atoms(t) == _atoms(j)
    assert _bonds(t) == _bonds(j)  # the Kekulé structure included
    assert {frozenset(r) for r in t.ring_info()} == {frozenset(r) for r in j.ring_info()}
    assert len(t.ring_info()) == len(j.ring_info())
    for i in range(t.num_atoms):
        assert t.atom_ring_sizes(i) == j.atom_ring_sizes(i) and t.atom_in_ring(i) == j.atom_in_ring(i)
    for model in ("mdl", "am1bcc"):
        assert t.aromatic_atoms(model) == j.aromatic_atoms(model)
        assert t.aromatic_bonds(model) == j.aromatic_bonds(model)
    for patt in PATTERNS:
        assert set(tchem.match_smarts(t, patt)) == set(jchem.match_smarts(j, patt)), patt


@pytest.mark.parametrize("smiles", ["c1ccc2cc3ccccc3cc2c1", "c1cc2ccc3cccc4ccc(c1)c2c34", "c1ccc2c(c1)[nH]c1ccccc12", "Cc1cc(C)nc(N)n1"])
def test_kekule_structure_of_fused_rings_matches_jax(smiles):
    """Fused aromatic systems have several Kekulé structures; the port's
    blossom matching picks networkx's on these (ROADMAP P17 holds the
    parameters equal where it would not)."""
    assert _bonds(tchem.mol_from_smiles(smiles)) == _bonds(jchem.mol_from_smiles(smiles))


def test_sdf_round_trip_matches_jax():
    """write_sdf of the port reads back in both packages as the same molecule."""
    j, t = mol_pair("Oc1ccccc1", "phenol")
    text = tchem.sdf.mol_to_molblock(t) + "$$$$\n"
    assert text == jchem.sdf.mol_to_molblock(j) + "$$$$\n"
    back_t, back_j = tchem.read_sdf_string(text)[0], jchem.read_sdf_string(text)[0]
    assert _atoms(back_t) == _atoms(back_j) and _bonds(back_t) == _bonds(back_j)
    np.testing.assert_array_equal(back_t.coords, back_j.coords)


def _random_graph(seed: int):
    """A numpy-made random graph with several components, as edge insertions."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(12, 40))
    edges = []
    for _ in range(int(rng.integers(n // 2, 2 * n))):
        i, j = (int(x) for x in rng.integers(0, n, 2))
        if i != j and (i, j) not in edges and (j, i) not in edges:
            edges.append((i, j))
    g, h = gu.Graph(), nx.Graph()
    for graph in (g, h):
        graph.add_nodes_from(range(n))
        graph.add_edges_from(edges)
    return g, h


@pytest.mark.parametrize("seed", range(6))
def test_graph_traversals_follow_networkx_order(seed):
    """Components (and each component set's iteration order), BFS distances
    in visiting order, induced subgraphs' node order, edge order and bridges
    are networkx's."""
    g, h = _random_graph(seed)
    assert g.edges() == list(h.edges())
    assert [list(c) for c in gu.connected_components(g)] == [list(c) for c in nx.connected_components(h)]
    got = [(n, list(d.items())) for n, d in gu.all_pairs_shortest_path_length(g, cutoff=3)]
    assert got == [(n, list(d.items())) for n, d in nx.all_pairs_shortest_path_length(h, cutoff=3)]
    assert gu.bridges(g) == {tuple(sorted(e)) for e in nx.bridges(h)}
    rng = np.random.default_rng(100 + seed)
    for size in (3, len(g) // 2, len(g) - 2):
        keep = frozenset(int(x) for x in rng.choice(len(g), size, replace=False))
        sg, sh = g.subgraph(keep), h.subgraph(keep)
        assert sg.nodes() == list(sh.nodes())
        assert [list(c) for c in gu.connected_components(sg)] == [list(c) for c in nx.connected_components(sh)]


@pytest.mark.parametrize("seed", range(4))
def test_cycle_basis_and_matching_are_valid(seed):
    """The minimum cycle basis has networkx's length profile and spans the
    same cycle space dimension; the matching has networkx's cardinality."""
    g, h = _random_graph(seed)
    basis, ref = gu.minimum_cycle_basis(g), nx.minimum_cycle_basis(h)
    assert sorted(len(c) for c in basis) == sorted(len(c) for c in ref)
    for cycle in basis:
        assert all(g.has_edge(cycle[k], cycle[(k + 1) % len(cycle)]) for k in range(len(cycle)))
    matching = gu.max_cardinality_matching(g)
    assert len(matching) == len(nx.max_weight_matching(h, maxcardinality=True))
    assert len({v for e in matching for v in e}) == 2 * len(matching) and all(g.has_edge(*e) for e in matching)
