"""Rate probes of the card, each a hand-written CUDA kernel with its plain
PyTorch version: the FP32 FMA peak (`fp32_peak`, counterpart of
scripts/probe_mfu.py's kernel) and the bf16 vs f32 rate of the pair sweeps'
distance-and-gate sequence (`bf16_rate`, counterpart of
scripts/probe_bf16.py's kernel)."""

import statistics

import torch


def kernel_ms(fn, reps: int, kernel: str) -> float:
    """Median device time of the launches of the CUDA kernel whose name
    contains `kernel` over reps calls of fn (after one), which launches it
    once a call, from torch.profiler: the bf16 probe's kernels run for
    microseconds, less than the host takes to launch one, so CUDA events
    around a stream of launches would time the host (the FP32 probe's run
    for over 0.1 ms and are timed by CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launches = [e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not launches:
        raise RuntimeError(f"kernel_ms: the profiler saw no launch of {kernel!r}")
    return statistics.median(e.time_range.elapsed_us() / 1e3 for e in launches)
