"""Job fan-out clients and the artifact store (counterpart of
timemachine_tpu/parallel/client.py).

`AbstractClient.submit() -> Future`: `SerialClient` runs a task inline,
`ProcessPoolClient` in a pool of spawned processes, and `DevicePoolClient`
in such a pool with each task restricted to one card through
CUDA_VISIBLE_DEVICES, set in the worker before the task runs, the cards
taken round robin. The workers are spawned, not forked: a process forked
after its parent has used the card cannot use the card itself, while a
spawned one starts with CUDA untouched, so a pool made after the parent's
first kernel still runs card tasks. A task and its arguments must pickle.
`FileClient` stores artifacts on the local file system and `save_results`
pickles a result bundle into it.
"""

from __future__ import annotations

import os
import pickle
from abc import ABC, abstractmethod
from concurrent import futures
from pathlib import Path
from typing import Any, Optional


class AbstractClient(ABC):
    @abstractmethod
    def submit(self, task_fn, *args, **kwargs):
        """Returns a Future with .result() and .done()."""

    def verify(self):
        """Check that the client can run jobs."""
        return


class _ImmediateFuture:
    def __init__(self, value=None, exception=None):
        self._value = value
        self._exception = exception

    def result(self, timeout=None):
        if self._exception is not None:
            raise self._exception
        return self._value

    def done(self):
        return True


class SerialClient(AbstractClient):
    """Runs each task inline; its exception is raised at .result(), as a future's."""

    def submit(self, task_fn, *args, **kwargs):
        try:
            return _ImmediateFuture(task_fn(*args, **kwargs))
        except Exception as e:
            return _ImmediateFuture(exception=e)


class ProcessPoolClient(AbstractClient):
    """A pool of max_workers spawned processes."""

    def __init__(self, max_workers: int):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.max_workers = max_workers
        self.executor = futures.ProcessPoolExecutor(max_workers=max_workers, mp_context=ctx)

    def submit(self, task_fn, *args, **kwargs):
        return self.executor.submit(task_fn, *args, **kwargs)

    def verify(self):
        assert self.max_workers > 0


class DevicePoolClient(ProcessPoolClient):
    """One spawned process per card; task i runs with CUDA_VISIBLE_DEVICES
    set to card i mod max_workers, round robin (JAX's non-TPU branch;
    `platform` names the kind of device)."""

    def __init__(self, max_workers: Optional[int] = None, platform: str = "gpu"):
        super().__init__(max_workers or get_device_count())
        self.platform = platform
        self._idx = 0

    @staticmethod
    def wrap_task(task_fn, device_ordinal, *args, **kwargs):
        # the card this task may see, set before the task first touches CUDA
        os.environ["CUDA_VISIBLE_DEVICES"] = str(device_ordinal)
        return task_fn(*args, **kwargs)

    def submit(self, task_fn, *args, **kwargs):
        future = self.executor.submit(self.wrap_task, task_fn, self._idx, *args, **kwargs)
        self._idx = (self._idx + 1) % self.max_workers
        return future

    def verify(self):
        assert get_device_count() >= self.max_workers


def get_device_count() -> int:
    """The cards torch sees (torch.cuda.device_count(); 0 without one)."""
    import torch

    return torch.cuda.device_count()


# the reference's name for the device pool
CUDAPoolClient = DevicePoolClient


class AbstractFileClient(ABC):
    @abstractmethod
    def store(self, path: str, data: bytes): ...

    @abstractmethod
    def load(self, path: str) -> bytes: ...

    @abstractmethod
    def exists(self, path: str) -> bool: ...

    @abstractmethod
    def full_path(self, path: str) -> str: ...


class FileClient(AbstractFileClient):
    """Artifacts as files under `base` on the local file system."""

    def __init__(self, base: Optional[Path] = None):
        self.base = Path(base or ".")
        self.base.mkdir(parents=True, exist_ok=True)

    def store(self, path, data: bytes):
        full = self.full_path(path)
        Path(full).parent.mkdir(parents=True, exist_ok=True)
        Path(full).write_bytes(data)

    def store_stream(self, path, fileobj, batch_size: int = 1024 * 1024):
        full = Path(self.full_path(path))
        full.parent.mkdir(parents=True, exist_ok=True)
        with open(full, "wb") as out:
            while chunk := fileobj.read(batch_size):
                out.write(chunk)

    def load(self, path) -> bytes:
        return Path(self.full_path(path)).read_bytes()

    def exists(self, path) -> bool:
        return Path(self.full_path(path)).exists()

    def full_path(self, path) -> str:
        return str(self.base / path)


def save_results(results: dict[str, Any], file_client: AbstractFileClient, prefix: str = ""):
    """Each object of `results` pickled into the store under prefix/name."""
    for name, obj in results.items():
        file_client.store(os.path.join(prefix, name), pickle.dumps(obj))
