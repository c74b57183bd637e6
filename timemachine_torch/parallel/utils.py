"""Parallel helpers (counterpart of timemachine_tpu/parallel/utils.py)."""

from typing import Optional

from timemachine_torch.parallel.client import get_device_count

get_gpu_count = get_device_count


def batch_list(values: list, num_workers: Optional[int] = None) -> list:
    """Round-robin split into at most num_workers non-empty batches (one
    value a batch when num_workers is None): worker k gets values k, k + W,
    k + 2W, ..."""
    stride = num_workers or len(values)
    return [values[k::stride] for k in range(min(stride, len(values)))]
