"""The port's parallel/client.py and parallel/utils.py against
timemachine_tpu's: JAX's client tests (tests/test_analysis_tools.py's
TestSerialClient, TestProcessPoolClient, test_file_client,
test_save_results, test_device_pool_client_round_robin) on the port, the
DevicePoolClient's round robin read through each task's
CUDA_VISIBLE_DEVICES, its workers spawned (a forked worker of a parent that
has used the card cannot use it), and the files FileClient and
save_results write byte for byte JAX's. batch_list equals JAX's.
"""

import io
import os
import pickle

import pytest
import torch

from timemachine_torch.parallel import client as tc
from timemachine_torch.parallel import utils as tu

torch.set_num_threads(1)  # the suite's workers share the host's cores


def _square(x):
    return x * x


def _kwargs_task(x, scale=1):
    return x * scale


def _boom():
    raise RuntimeError("task failed")


def _visible_devices(_):
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def _torch_sum(n):
    return float(torch.arange(n, dtype=torch.float64).sum())


class TestSerialClient:
    def test_submit(self):
        client = tc.SerialClient()
        client.verify()
        fut = client.submit(_square, 4)
        assert fut.done() and fut.result() == 16

    def test_submit_kwargs(self):
        assert tc.SerialClient().submit(_kwargs_task, 3, scale=5).result() == 15

    def test_exception_raised_at_result(self):
        fut = tc.SerialClient().submit(_boom)  # must not raise here
        with pytest.raises(RuntimeError, match="task failed"):
            fut.result()


class TestProcessPoolClient:
    def test_submit(self):
        client = tc.ProcessPoolClient(max_workers=2)
        client.verify()
        futures = [client.submit(_square, i) for i in range(5)]
        assert [f.result() for f in futures] == [0, 1, 4, 9, 16]
        client.executor.shutdown()

    def test_results_picklable_and_exceptions_reach_the_caller(self):
        client = tc.ProcessPoolClient(max_workers=1)
        assert pickle.loads(pickle.dumps(client.submit(_square, 7).result())) == 49
        with pytest.raises(RuntimeError, match="task failed"):
            client.submit(_boom).result()
        client.executor.shutdown()


def test_device_pool_client_round_robin():
    client = tc.DevicePoolClient(max_workers=2, platform="cpu")
    futures = [client.submit(_square, i) for i in range(4)]
    assert [f.result() for f in futures] == [0, 1, 4, 9]
    client.executor.shutdown()


def test_device_pool_client_pins_each_task_round_robin_in_spawned_workers():
    torch.ones(3).sum()  # the parent has used torch before the pool exists
    client = tc.DevicePoolClient(max_workers=2)
    assert client.platform == "gpu" and client.executor._mp_context.get_start_method() == "spawn"
    seen = [client.submit(_visible_devices, i).result() for i in range(5)]
    assert seen == ["0", "1", "0", "1", "0"]
    assert client.submit(_torch_sum, 10).result() == 45.0
    client.executor.shutdown()


def test_device_count_is_torch_cuda_count():
    assert tc.get_device_count() == torch.cuda.device_count() == tu.get_gpu_count()


def test_file_client(tmp_path):
    fc = tc.FileClient(tmp_path / "store")
    assert not fc.exists("a/b.bin")
    fc.store("a/b.bin", b"hello")
    assert fc.exists("a/b.bin") and fc.load("a/b.bin") == b"hello"
    assert fc.full_path("a/b.bin").endswith("store/a/b.bin")
    fc.store_stream("c.bin", io.BytesIO(b"x" * 3000), batch_size=1024)
    assert fc.load("c.bin") == b"x" * 3000


def test_file_client_and_save_results_write_jax_bytes(tmp_path):
    from timemachine_tpu.parallel import client as jc

    results = {"results.pkl": {"dg": 1.5, "errs": [0.1, 0.2]}, "traj.pkl": [1, 2, (3, "x")]}
    for mod, name in ((tc, "port"), (jc, "jax")):
        fc = mod.FileClient(tmp_path / name)
        mod.save_results(results, fc, prefix="edge_0")
        fc.store_stream("stream.bin", io.BytesIO(bytes(range(256)) * 20), batch_size=1000)
    for rel in ("edge_0/results.pkl", "edge_0/traj.pkl", "stream.bin"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert pickle.loads(tc.FileClient(tmp_path / "port").load("edge_0/results.pkl")) == results["results.pkl"]


@pytest.mark.parametrize("n, workers", [(7, 3), (2, 5), (4, None), (0, 2)])
def test_batch_list_matches_jax(n, workers):
    from timemachine_tpu.parallel import utils as ju

    values = list(range(n))
    assert tu.batch_list(values, workers) == ju.batch_list(values, workers)
