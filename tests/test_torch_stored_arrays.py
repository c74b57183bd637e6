"""Frames on disk: the port's fe/stored_arrays.py and the Trajectory built on
it (timemachine_torch/fe/free_energy.py), against timemachine_tpu's.

StoredArrays: serialized bytes equal JAX's; indexing, slicing, iteration,
__array__, equality, pickling and store/load through a FileClient give
JAX's results on the same arrays (tolerance 0). The drivers: run_sims_sequential
and run_sims_hrex on JAX's harmonic states give, with frames on disk,
bitwise the frames of the same run kept in a list in memory. image_frames
within 1e-12 nm of JAX's; assert_deep_eq passes and fails on the panel of
cases JAX's does, its message naming the same path.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from timemachine_torch import potentials as tp
from timemachine_torch.fe import free_energy as tfe
from timemachine_torch.fe import stored_arrays as tsa
from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.parallel.client import FileClient
from timemachine_tpu.fe import stored_arrays as jsa

torch.set_num_threads(1)  # the suite's workers share the host's cores

TEMP = 300.0
X_TOL = 1e-12  # nm


def _chunks(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 5, 3)) for n in (3, 1, 4)]


@pytest.mark.parametrize("array", [np.arange(12.0).reshape(4, 3), np.arange(6, dtype=np.int32), np.float32(2.5),
                                   np.zeros((0, 3)), np.array([[True, False]])])
def test_serialized_bytes_equal_jax(array):
    assert tsa.serialize_array(array) == jsa.serialize_array(array)
    back = tsa.deserialize_array(jsa.serialize_array(array))
    assert back.dtype == np.asarray(array).dtype and np.array_equal(back, array)


def test_stored_arrays_behave_as_jax():
    chunks = _chunks()
    t, j = tsa.StoredArrays.from_chunks(chunks), jsa.StoredArrays.from_chunks(chunks)
    assert len(t) == len(j) == 8
    for key in (0, 2, 3, 4, 7, -1, -8):
        np.testing.assert_array_equal(t[key], j[key])
    for key in (slice(None), slice(1, 6), slice(None, None, -2), slice(5, 2), slice(2, 7, 3)):
        np.testing.assert_array_equal(t[key], j[key])
        assert t[key].shape == j[key].shape
    for key in (8, -9):
        with pytest.raises(IndexError):
            t[key]
    with pytest.raises(NotImplementedError):
        t[[0, 1]]
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    np.testing.assert_array_equal(np.asarray(t, dtype=np.float32), np.asarray(j, dtype=np.float32))
    assert all(np.array_equal(a, b) for a, b in zip(t, j))
    assert t == tsa.StoredArrays.from_chunks(chunks)
    assert not (t == tsa.StoredArrays.from_chunks([np.concatenate(chunks)]))  # other chunking
    other = [c.copy() for c in chunks]
    other[2][1, 0, 0] += 1.0
    assert not (t == tsa.StoredArrays.from_chunks(other))
    back = pickle.loads(pickle.dumps(t))
    assert back == t and back._dir.name != t._dir.name
    empty_t, empty_j = tsa.StoredArrays(), jsa.StoredArrays()
    assert len(empty_t) == 0 and np.asarray(empty_t).shape == np.asarray(empty_j).shape == (0,)
    assert empty_t[:].shape == empty_j[:].shape


def test_store_and_load_through_a_file_client_as_jax(tmp_path):
    from timemachine_tpu.parallel.client import FileClient as JFileClient

    chunks = _chunks(1)
    t = tsa.StoredArrays.from_chunks(chunks)
    t.store(FileClient(tmp_path / "port"), prefix=tmp_path / "port" / "frames")
    jsa.StoredArrays.from_chunks(chunks).store(JFileClient(tmp_path / "jax"), prefix=tmp_path / "jax" / "frames")
    for idx in range(3):
        name = f"frames/{idx}.npy"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    with pytest.raises(FileExistsError):
        t.store(FileClient(tmp_path / "port"), prefix=tmp_path / "port" / "frames")
    loaded = tsa.StoredArrays.load(FileClient(tmp_path / "port"), prefix=tmp_path / "port" / "frames")
    j_loaded = jsa.StoredArrays.load(JFileClient(tmp_path / "jax"), prefix=tmp_path / "jax" / "frames")
    assert loaded == t and len(loaded) == len(j_loaded)
    np.testing.assert_array_equal(np.asarray(loaded), np.asarray(j_loaded))


def test_trajectory_holds_stored_arrays():
    t = tfe.Trajectory.empty()
    assert isinstance(t.frames, tsa.StoredArrays) and len(t.frames) == 0
    t2 = tfe.Trajectory(tsa.StoredArrays.from_chunks([np.zeros((2, 3, 3))]), [np.eye(3)] * 2, None)
    t.extend(t2)
    assert len(t.frames) == 2 and len(t.boxes) == 2
    with pytest.raises(ValueError):
        tfe.Trajectory(tsa.StoredArrays.from_chunks([np.zeros((2, 3, 3))]), [np.eye(3)], None)
    with pytest.raises(AssertionError):
        tfe.Trajectory(tsa.StoredArrays.from_chunks([np.zeros((1, 3, 3))]), [np.eye(2)], None)


def _harmonic_states():
    x0 = np.array([[0.0, 0, 0], [0.12, 0, 0]])
    out = []
    for lamb in (0.0, 0.5, 1.0):
        bond = tp.HarmonicBond(np.array([[0, 1]], dtype=np.int32), np.array([[2e4 * (1.0 + lamb), 0.11]]), 2, device="cpu")
        out.append(tfe.InitialState([bond], LangevinIntegrator(TEMP, 1.5e-3, 1.0, np.array([12.0, 12.0]), seed=5), None,
                                    x0, np.zeros_like(x0), np.eye(3) * 10.0, lamb, np.array([0], dtype=np.int32),
                                    np.array([], dtype=np.int32)))
    return out


class _InMemory(list):
    """The frames of a run kept in a list, as the port kept them before StoredArrays."""


@pytest.mark.parametrize("driver", ["sequential", "hrex"])
def test_drivers_on_disk_are_bitwise_the_in_memory_run(driver, monkeypatch):
    md = tfe.MDParams(n_frames=4, n_eq_steps=10, steps_per_frame=5, seed=3,
                      hrex_params=tfe.HREXParams(n_frames_bisection=2) if driver == "hrex" else None)

    def run():
        if driver == "sequential":
            return tfe.run_sims_sequential(_harmonic_states(), md, TEMP)[1]
        return tfe.run_sims_hrex(_harmonic_states(), md, print_diagnostics_interval=None)[1]

    on_disk = run()
    assert all(isinstance(t.frames, tsa.StoredArrays) for t in on_disk)
    n_files = 1 if driver == "sequential" else 4  # one file a batch of up to 100 frames, or a frame of HREX
    assert all(len(list(Path(t.frames._dir.name).glob("*.npy"))) == n_files for t in on_disk)
    monkeypatch.setattr(tfe, "StoredArrays", _InMemory)
    in_memory = run()
    assert all(type(t.frames) is _InMemory for t in in_memory)
    for a, b in zip(on_disk, in_memory):
        assert len(a.frames) == len(b.frames) == 4
        for fa, fb in zip(a.frames, b.frames):
            assert np.array_equal(fa, fb)
        np.testing.assert_array_equal(np.asarray(a.frames), np.asarray(b.frames))
        np.testing.assert_array_equal(np.asarray(a.boxes), np.asarray(b.boxes))


def test_image_frames_matches_jax():
    from timemachine_tpu.fe import free_energy as jfe
    from timemachine_tpu.integrators import LangevinIntegrator as JL
    from timemachine_tpu.potentials import BoundPotential, HarmonicBond

    rng = np.random.default_rng(11)
    n = 7
    idxs = np.array([[0, 1], [1, 2], [3, 4]], dtype=np.int32)  # molecules {0, 1, 2}, {3, 4}, {5}, {6}
    params = np.tile([1e4, 0.1], (3, 1))
    masses = np.full(n, 12.0)
    common = (np.zeros((n, 3)), np.zeros((n, 3)), np.eye(3) * 3.0, 0.0, np.array([3, 4], dtype=np.int32),
              np.array([], dtype=np.int32))
    j_state = jfe.InitialState([BoundPotential(HarmonicBond(idxs), params)], JL(TEMP, 1e-3, 1.0, masses, 1), None, *common)
    t_state = tfe.InitialState([tp.HarmonicBond(idxs, params, n, device="cpu")], LangevinIntegrator(TEMP, 1e-3, 1.0, masses, 1),
                               None, *common)
    frames = rng.uniform(-6.0, 9.0, size=(5, n, 3))
    boxes = [np.diag(rng.uniform(2.5, 3.5, 3)) for _ in range(5)]
    j = jfe.image_frames(j_state, frames, boxes)
    t = tfe.image_frames(t_state, tsa.StoredArrays.from_chunks([frames]), boxes)
    assert t.shape == j.shape == (5, n, 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=X_TOL)
    with pytest.raises(AssertionError, match="3x3"):
        tfe.image_frames(t_state, frames, [np.eye(2)] * 5)


def _deep_eq_panel(array):
    """(obj1, obj2, custom) cases; `array` makes each package's arrays."""
    from dataclasses import dataclass

    @dataclass
    class Inner:
        a: object
        b: list

    @dataclass
    class Other:
        a: object
        b: list

    skip_b = lambda path, x1, x2: path[-1] == "b"  # noqa: E731
    return [
        (Inner(array([1.0, 2.0]), [1, (2, "x")]), Inner(array([1.0, 2.0]), [1, (2, "x")]), None),
        (Inner(array([1.0, 2.0]), [1, 2]), Inner(array([1.0, 3.0]), [1, 2]), None),
        (Inner(1, [1, [2, array([0, 1])]]), Inner(1, [1, [2, array([0, 2])]]), None),
        (Inner(1, [1, 2]), Inner(1, [1, 2, 3]), None),
        (Inner(1, [1, "x"]), Inner(1, [1, "y"]), None),
        (Inner(1, [1]), Other(1, [1]), None),
        (Inner(1, [1]), Inner(1, [2]), skip_b),
        ([Inner(1, [array([1.0])])], [Inner(1, [array([np.nan])])], None),
    ]


def test_assert_deep_eq_matches_jax_on_a_panel():
    import jax.numpy as jnp

    from timemachine_tpu.fe.free_energy import assert_deep_eq as j_deep_eq

    def outcome(fn, x1, x2, custom):
        try:
            fn(x1, x2) if custom is None else fn(x1, x2, custom)
        except AssertionError as e:
            return str(e).replace("Other", "Inner")
        return "ok"

    j_cases = _deep_eq_panel(lambda v: jnp.asarray(v))
    t_cases = _deep_eq_panel(lambda v: torch.tensor(v))
    outcomes = []
    for (j1, j2, jc), (t1, t2, tc) in zip(j_cases, t_cases):
        want = outcome(j_deep_eq, j1, j2, jc)
        assert outcome(tfe.assert_deep_eq, t1, t2, tc) == want
        outcomes.append(want)
    assert outcomes[0] == "ok" and outcomes[6] == "ok"
    assert outcomes[1] == "arrays differ at ('$', 'a')"
    assert outcomes[2] == "arrays differ at ('$', 'b', 1, 1)"
    assert outcomes[3].startswith("lengths differ") and outcomes[5].startswith("types differ")
    # numpy arrays on one side, tensors on the other, compare by value
    tfe.assert_deep_eq([np.arange(3)], [torch.arange(3)])
