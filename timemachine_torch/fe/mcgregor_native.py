"""ctypes front-end for the native McGregor MCS search
(timemachine_torch/native/mcgregor.cpp; the port's copy of
timemachine_tpu/fe/mcgregor_native.py).

Same contract as `timemachine_torch.fe.mcgregor.mcs` minus the returned marcs
matrices (unused by atom mapping). Python filter/leaf-filter callbacks are
bridged through C function pointers; the leaf-filter cache lives in C++.
`load_library()` builds the library at first use and raises
native.NativeBuildError where it cannot; `searches` counts the searches run.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Callable, Optional

import numpy as np

from timemachine_torch.fe.mcgregor import (
    UNMAPPED,
    MaxVisitsWarning,
    MCSDiagnostics,
    NoMappingError,
    perm_to_core,
)

_FILTER_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int)

_lib = None
searches = 0  # native searches run in this process


def load_library():
    """The search's ctypes library, built at first use."""
    global _lib
    if _lib is None:
        from timemachine_torch.native import build_library

        lib = ctypes.CDLL(str(build_library("mcgregor")))
        lib.mcs_search.restype = ctypes.c_int
        lib.mcs_search.argtypes = [
            ctypes.c_int,  # n_a
            ctypes.c_int,  # n_b
            ctypes.POINTER(ctypes.c_int32),  # priority_flat
            ctypes.POINTER(ctypes.c_int32),  # priority_offsets
            ctypes.POINTER(ctypes.c_int32),  # bonds_a
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),  # bonds_b
            ctypes.c_int,
            ctypes.c_int64,  # max_visits
            ctypes.c_int64,  # max_cores
            ctypes.c_int,  # enforce_core_core
            ctypes.c_int,  # max_ccs (-1 = None)
            ctypes.c_int,  # min_cc_size
            ctypes.c_int,  # min_num_edges
            ctypes.POINTER(ctypes.c_int32),  # init_mapping
            ctypes.c_int,  # n_init
            _FILTER_CB,  # filter
            _FILTER_CB,  # leaf_filter
            ctypes.POINTER(ctypes.c_int32),  # chiral_quartets_a
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),  # disallowed_b_keys
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),  # planar_torsions_a
            ctypes.POINTER(ctypes.c_int8),  # planar_signs_a
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),  # planar_b_keys
            ctypes.POINTER(ctypes.c_int8),  # planar_b_signs
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),  # out_maps
            ctypes.POINTER(ctypes.c_int32),  # out_n_maps
            ctypes.POINTER(ctypes.c_int64),  # out_nodes_visited
            ctypes.POINTER(ctypes.c_int64),  # out_leaves_visited
            ctypes.POINTER(ctypes.c_int),  # out_timed_out
        ]
        _lib = lib
    return _lib


def _as_i32_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def pack_quartets(quartets) -> np.ndarray:
    """(Q, 4) int -> packed uint64 keys matching the C++ pack_quartet."""
    q = np.asarray(quartets, dtype=np.int64).reshape(-1, 4)
    q16 = (q & 0xFFFF).astype(np.uint64)
    return (q16[:, 0] << 48) | (q16[:, 1] << 32) | (q16[:, 2] << 16) | q16[:, 3]


def mcs_native(
    n_a: int,
    n_b: int,
    priority_idxs,
    bonds_a,
    bonds_b,
    max_visits: int,
    max_cores,
    enforce_core_core: bool,
    max_connected_components: Optional[int],
    min_connected_component_size: int,
    min_num_edges: int,
    initial_mapping,
    filter_fxn: Optional[Callable] = None,
    leaf_filter_fxn: Optional[Callable] = None,
    chiral_quartets_a=None,
    disallowed_quartets_b=None,
    planar_torsions_a=None,
    planar_signs_a=None,
    planar_torsions_b=None,
    planar_signs_b=None,
):
    """Drop-in accelerated `mcs` (marcs omitted from the return).

    The chiral/planar tables, when given, run as native built-in filters
    (see mcgregor.cpp) instead of per-node Python callbacks."""
    global searches
    assert n_a <= n_b
    lib = load_library()
    searches += 1

    offsets = np.zeros(n_a + 1, dtype=np.int32)
    flat = []
    for i, jdxs in enumerate(priority_idxs):
        flat.extend(int(j) for j in jdxs)
        offsets[i + 1] = len(flat)
    flat = np.asarray(flat, dtype=np.int32)
    if flat.size == 0:
        flat = np.zeros(1, dtype=np.int32)

    bonds_a = np.ascontiguousarray(np.asarray(bonds_a, dtype=np.int32).reshape(-1, 2))
    bonds_b = np.ascontiguousarray(np.asarray(bonds_b, dtype=np.int32).reshape(-1, 2))

    if initial_mapping is not None and len(initial_mapping):
        init = np.ascontiguousarray(np.asarray(initial_mapping, dtype=np.int32).reshape(-1, 2))
        n_init = len(init)
    else:
        init = np.zeros((1, 2), dtype=np.int32)
        n_init = 0

    max_cores_i = int(max_cores)
    out_maps = np.full((max_cores_i, n_a), UNMAPPED, dtype=np.int32)
    out_n_maps = ctypes.c_int32(0)
    out_nodes = ctypes.c_int64(0)
    out_leaves = ctypes.c_int64(0)
    out_timed_out = ctypes.c_int(0)

    def wrap_cb(fn):
        if fn is None:
            return ctypes.cast(None, _FILTER_CB)

        def cb(ptr, n):
            a_to_b = tuple(ptr[i] for i in range(n))
            return 1 if fn(a_to_b) else 0

        return _FILTER_CB(cb)

    c_filter = wrap_cb(filter_fxn)
    c_leaf = wrap_cb(leaf_filter_fxn)

    def i32_arr(x, fallback_shape):
        if x is None or len(x) == 0:
            return np.zeros(fallback_shape, dtype=np.int32), 0
        arr = np.ascontiguousarray(np.asarray(x, dtype=np.int32))
        return arr, len(arr)

    chiral_a, n_chiral_a = i32_arr(chiral_quartets_a, (1, 4))
    if disallowed_quartets_b is not None and len(disallowed_quartets_b):
        dis_b = np.ascontiguousarray(pack_quartets(list(disallowed_quartets_b)))
        n_dis_b = len(dis_b)
    else:
        dis_b = np.zeros(1, dtype=np.uint64)
        n_dis_b = 0
    planar_a, n_planar_a = i32_arr(planar_torsions_a, (1, 4))
    signs_a = (
        np.ascontiguousarray(np.asarray(planar_signs_a, dtype=np.int8))
        if n_planar_a
        else np.zeros(1, dtype=np.int8)
    )
    if planar_torsions_b is not None and len(planar_torsions_b):
        pb_keys = np.ascontiguousarray(pack_quartets(planar_torsions_b))
        pb_signs = np.ascontiguousarray(np.asarray(planar_signs_b, dtype=np.int8))
        n_planar_b = len(pb_keys)
    else:
        pb_keys = np.zeros(1, dtype=np.uint64)
        pb_signs = np.zeros(1, dtype=np.int8)
        n_planar_b = 0

    status = lib.mcs_search(
        n_a,
        n_b,
        _as_i32_ptr(flat),
        _as_i32_ptr(offsets),
        _as_i32_ptr(bonds_a),
        len(bonds_a),
        _as_i32_ptr(bonds_b),
        len(bonds_b),
        int(max_visits),
        max_cores_i,
        int(bool(enforce_core_core)),
        -1 if max_connected_components is None else int(max_connected_components),
        int(min_connected_component_size),
        int(min_num_edges),
        _as_i32_ptr(init),
        n_init,
        c_filter,
        c_leaf,
        _as_i32_ptr(chiral_a),
        n_chiral_a,
        dis_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_dis_b,
        _as_i32_ptr(planar_a),
        signs_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n_planar_a,
        pb_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pb_signs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n_planar_b,
        _as_i32_ptr(out_maps),
        ctypes.byref(out_n_maps),
        ctypes.byref(out_nodes),
        ctypes.byref(out_leaves),
        ctypes.byref(out_timed_out),
    )

    nodes_visited = int(out_nodes.value)
    leaves_visited = int(out_leaves.value)
    n_maps = int(out_n_maps.value)
    timed_out = bool(out_timed_out.value)

    if status == 1:
        raise NoMappingError("No possible mapping given the predicate matrix")
    if status == 2:
        raise NoMappingError(
            f"Exceeded max number of visits/cores - no valid cores could be found: {nodes_visited} nodes visited."
        )
    if status == 3:
        raise NoMappingError(f"Unable to find mapping with at least {min_num_edges} edges")

    if timed_out and n_maps < max_cores_i:
        warnings.warn(
            f"Inexhaustive search: reached max number of visits ({max_visits}) and found only "
            f"{n_maps} out of {max_cores_i} desired cores.",
            MaxVisitsWarning,
        )

    all_cores = [perm_to_core(out_maps[k]) for k in range(n_maps)]
    return (
        all_cores,
        None,
        MCSDiagnostics(
            total_nodes_visited=nodes_visited,
            total_leaves_visited=leaves_visited,
            core_size=len(all_cores[0]),
            num_cores=len(all_cores),
        ),
    )
