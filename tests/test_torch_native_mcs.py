"""The port's native McGregor search (timemachine_torch/native/mcgregor.cpp
through fe/mcgregor_native.py) against the port's pure-Python search and
the JAX package's: the same cores and node counts on JAX's ring and chain
cases (tests/test_native_mcs.py), the same NoMappingError, and get_cores by
the native search equal, in order, to get_cores by the Python search and
to JAX's; where the library cannot be built, get_cores warns with the build
error and runs the Python search. Skips where g++ is absent, as JAX's test
does.
"""

import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_chem import EDGE, RING_EDGE, mol_pair
from timemachine_torch import native
from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
from timemachine_torch.fe import atom_mapping as tam
from timemachine_torch.fe import mcgregor, mcgregor_native
from timemachine_tpu.fe import mcgregor as jmcgregor
from timemachine_tpu.fe.atom_mapping import get_cores as j_get_cores
from timemachine_tpu.fe.mcgregor_native import mcs_native as j_mcs_native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

torch.set_num_threads(1)  # the suite's workers share the host's cores


def _mcs_kwargs(**overrides):
    kwargs = dict(
        max_visits=100_000,
        max_cores=1000,
        enforce_core_core=True,
        max_connected_components=1,
        min_connected_component_size=1,
        min_num_edges=1,
        initial_mapping=None,
    )
    kwargs.update(overrides)
    return kwargs


def _core_set(cores):
    return {tuple(map(tuple, c)) for c in cores}


CASES = {
    # JAX's ring case: a 6-ring into a 6-ring with a substituent
    "ring": (6, 7, [(i, (i + 1) % 6) for i in range(6)], [(i, (i + 1) % 6) for i in range(6)] + [(0, 6)], [list(range(7))] * 6, {}),
    # JAX's chain case: a 5-chain into a branched 7-atom graph
    "chain": (5, 7, [(i, i + 1) for i in range(4)], [(0, 1), (1, 2), (2, 3), (3, 4), (2, 5), (5, 6)], [list(range(7))] * 5,
              dict(max_connected_components=None)),
    # a seeded chain: the initial mapping pins atom 0
    "seeded chain": (5, 7, [(i, i + 1) for i in range(4)], [(0, 1), (1, 2), (2, 3), (3, 4), (2, 5), (5, 6)],
                     [list(range(7))] * 5, dict(max_connected_components=None, initial_mapping=np.array([[0, 0]]))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_python_and_jax(case):
    n_a, n_b, bonds_a, bonds_b, prio, over = CASES[case]
    kwargs = _mcs_kwargs(**over)
    cores_py, _, diag_py = mcgregor.mcs(n_a, n_b, prio, bonds_a, bonds_b, **kwargs)
    cores_cc, marcs, diag_cc = mcgregor_native.mcs_native(n_a, n_b, prio, bonds_a, bonds_b, **kwargs)
    cores_j, _, diag_j = j_mcs_native(n_a, n_b, prio, bonds_a, bonds_b, **kwargs)
    cores_jpy, _, _ = jmcgregor.mcs(n_a, n_b, prio, bonds_a, bonds_b, **kwargs)
    assert marcs is None
    assert _core_set(cores_cc) == _core_set(cores_py) == _core_set(cores_j) == _core_set(cores_jpy)
    assert [c.tolist() for c in cores_cc] == [c.tolist() for c in cores_j]
    assert vars(diag_cc) == vars(diag_j)  # distinct dataclasses, one per package
    assert (diag_cc.total_nodes_visited, diag_cc.num_cores, diag_cc.core_size) == (
        diag_py.total_nodes_visited, diag_py.num_cores, diag_py.core_size
    )


def test_native_no_mapping_error():
    with pytest.raises(mcgregor.NoMappingError):
        mcgregor_native.mcs_native(2, 2, [[], []], [(0, 1)], [(0, 1)], **_mcs_kwargs(max_connected_components=None))


def test_native_counts_its_searches():
    before = mcgregor_native.searches
    n_a, n_b, bonds_a, bonds_b, prio, over = CASES["ring"]
    mcgregor_native.mcs_native(n_a, n_b, prio, bonds_a, bonds_b, **_mcs_kwargs(**over))
    assert mcgregor_native.searches == before + 1


def test_quartet_packing_matches_jax():
    from timemachine_tpu.fe.mcgregor_native import pack_quartets as j_pack

    q = np.array([[0, 1, 2, 3], [65535, 7, 300, 12], [4, 3, 2, 1]])
    np.testing.assert_array_equal(mcgregor_native.pack_quartets(q), j_pack(q))


VARIANTS = {
    "default": {},
    "chiral_and_planar_off": dict(enforce_chiral=False, disallow_planar_torsion_flips=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("edge", [EDGE, RING_EDGE], ids=["ethanol-propane", "toluene-phenol"])
def test_get_cores_native_matches_python_and_jax(edge, variant, monkeypatch):
    """The native search (its chiral and planar tables built in) gives the
    cores of the port's Python search and of JAX's get_cores, in order."""
    (ja, ta), (jb, tb) = mol_pair(edge[0]), mol_pair(edge[1])
    kwargs = {**DEFAULT_ATOM_MAPPING_KWARGS, **VARIANTS[variant]}
    before = mcgregor_native.searches
    native_cores = tam.get_cores(ta, tb, **kwargs)
    assert mcgregor_native.searches == before + 1
    monkeypatch.setattr(tam, "_native_search", lambda: None)
    python_cores = tam.get_cores(ta, tb, **kwargs)
    assert mcgregor_native.searches == before + 1
    ref = j_get_cores(ja, jb, **kwargs)
    assert len(native_cores) == len(python_cores) == len(ref) > 0
    for a, b, r in zip(native_cores, python_cores, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(r))


def test_get_cores_falls_back_with_the_build_error(monkeypatch, tmp_path):
    """No compiler: the build raises NativeBuildError, get_cores warns with
    its message and returns the Python search's cores."""
    (_, ta), (_, tb) = mol_pair(EDGE[0]), mol_pair(EDGE[1])
    ref = tam.get_cores(ta, tb, **DEFAULT_ATOM_MAPPING_KWARGS)
    monkeypatch.setattr(mcgregor_native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="no-such-compiler"):
        native.build_library("mcgregor")
    before = mcgregor_native.searches
    with pytest.warns(UserWarning, match="native MCS unavailable .*failed to build mcgregor.cpp"):
        cores = tam.get_cores(ta, tb, **DEFAULT_ATOM_MAPPING_KWARGS)
    assert mcgregor_native.searches == before
    assert len(cores) == len(ref)
    for a, b in zip(cores, ref):
        np.testing.assert_array_equal(a, b)


def test_build_is_reused_and_keyed_by_source():
    path = native.build_library("mcgregor")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.build_library("mcgregor") == path
