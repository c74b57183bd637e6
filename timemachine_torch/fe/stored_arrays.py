"""Disk-backed array sequence for trajectory frames (counterpart of
timemachine_tpu/fe/stored_arrays.py).

Frames arrive in chunks, and each chunk is written as one .npy file to a
temporary directory (under TMPDIR), so a long leg's frames do not stay in
host memory. Chunk boundaries are kept as cumulative offsets, so random
access finds its chunk with one searchsorted; the chunk read last is
cached, since frames are usually read in order. Slices, `__array__`,
equality, pickling (the chunks travel by value) and `store`/`load` through
a FileClient (parallel/client.py) behave as JAX's. The bytes of a
serialized array are numpy's .npy format, as JAX's.
"""

from __future__ import annotations

import io
import tempfile
from itertools import count
from pathlib import Path
from typing import Collection, Iterable, Iterator, Sequence

import numpy as np


def serialize_array(array) -> bytes:
    buf = io.BytesIO()
    np.save(buf, array)
    return buf.getvalue()


def deserialize_array(bs: bytes) -> np.ndarray:
    return np.load(io.BytesIO(bs))


class StoredArrays(Sequence):
    """Append-only sequence of equally shaped arrays, spilled to disk in the
    chunks they arrived in."""

    def __init__(self) -> None:
        self._offsets = np.zeros(1, dtype=np.int64)  # cumulative chunk ends
        self._dir = tempfile.TemporaryDirectory()
        self._cache: tuple[int, np.ndarray] | None = None  # (chunk index, data)

    @classmethod
    def from_chunks(cls, chunks: Iterable[Collection]) -> "StoredArrays":
        out = cls()
        for chunk in chunks:
            out.extend(chunk)
        return out

    def extend(self, xs: Collection):
        chunk = np.asarray(xs)
        np.save(self.get_chunk_path(Path(self._dir.name), self._n_chunks()), chunk)
        self._offsets = np.append(self._offsets, self._offsets[-1] + len(chunk))

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _n_chunks(self) -> int:
        return len(self._offsets) - 1

    def _load_chunk(self, idx: int) -> np.ndarray:
        if self._cache is not None and self._cache[0] == idx:
            return self._cache[1]
        data = np.load(self.get_chunk_path(Path(self._dir.name), idx))
        self._cache = (idx, data)
        return data

    def __getitem__(self, key):
        if isinstance(key, slice):
            items = [self[i] for i in range(*key.indices(len(self)))]
            if not items:
                item_shape = self._load_chunk(0).shape[1:] if self._n_chunks() else ()
                return np.zeros((0,) + item_shape)
            return np.stack(items)
        if not isinstance(key, (int, np.integer)):
            raise NotImplementedError("only integer and slice indexing is supported")
        n = len(self)
        if key < 0:
            key += n
        if not 0 <= key < n:
            raise IndexError(key)
        chunk_idx = int(np.searchsorted(self._offsets, key, side="right")) - 1
        return self._load_chunk(chunk_idx)[key - int(self._offsets[chunk_idx])]

    def __iter__(self) -> Iterator[np.ndarray]:
        for idx in range(self._n_chunks()):
            yield from self._load_chunk(idx)

    def __array__(self, dtype=None, copy=None):
        chunks = [self._load_chunk(i) for i in range(self._n_chunks())]
        out = np.concatenate(chunks) if chunks else np.zeros((0,))
        return out.astype(dtype) if dtype is not None else out

    def __eq__(self, other) -> bool:
        return np.array_equal(self._offsets, other._offsets) and all(
            np.array_equal(a, b, equal_nan=True) for a, b in zip(self, other)
        )

    @staticmethod
    def get_chunk_path(path: Path, idx: int) -> Path:
        return (path / str(idx)).with_suffix(".npy")

    def __reduce__(self):
        return self.from_chunks, ([self._load_chunk(i) for i in range(self._n_chunks())],)

    def store(self, client, prefix: Path = Path(".")):
        """Upload every chunk through a FileClient-like object."""
        for idx in range(self._n_chunks()):
            dest = self.get_chunk_path(prefix, idx)
            if client.exists(str(dest)):
                raise FileExistsError(f"file already exists: {dest}")
            with open(self.get_chunk_path(Path(self._dir.name), idx), "rb") as ifs:
                client.store_stream(str(dest), ifs)

    @classmethod
    def load(cls, client, prefix: Path = Path(".")) -> "StoredArrays":
        out = cls()
        for idx in count():
            path = cls.get_chunk_path(prefix, idx)
            if not client.exists(str(path)):
                break
            out.extend(list(deserialize_array(client.load(str(path)))))
        return out
