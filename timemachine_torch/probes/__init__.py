"""Rate probes of the card, each a hand-written CUDA kernel with its plain
PyTorch version: the FP32 FMA peak (`fp32_peak`, counterpart of
scripts/probe_mfu.py's kernel) and the bf16 vs f32 rate of the pair sweeps'
distance-and-gate sequence (`bf16_rate`, counterpart of
scripts/probe_bf16.py's kernel); and the tile census of the pair sweep
(`tile_census`, counterpart of scripts/probe_bf16.py --census)."""

import statistics
import sys
import time

import torch

PROFILER_TRIES = 3  # profiler sessions that see no launch before kernel_ms times by CUDA events
SPIN_CYCLES_PER_CALL = 500_000  # about 250 us of spin a queued call at the H100's 1.98 GHz boost clock (a wrapper call takes the host about 70 us)


def kernel_ms(fn, reps: int, kernel: str) -> tuple:
    """(ms, how): the median device time of the launches of the CUDA kernel
    whose name contains `kernel` over reps calls of fn (after one), which
    launches it once a call. how is "profiler" where torch.profiler saw the
    launches: the kernel's own duration on the device. CUPTI now and then
    hands a session no kernel record at all; after PROFILER_TRIES such
    sessions, how is "events" and ms is event_pairs_ms. The bf16 probe's
    kernels run for microseconds, less than the host takes to launch one,
    so CUDA events around a stream of their launches time the host unless a
    spin kernel holds the stream first (bf16_rate.backlogged_ms); the FP32
    probe's run for over 0.1 ms and are timed by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launches = [e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name]
        if launches:
            return statistics.median(e.time_range.elapsed_us() / 1e3 for e in launches), "profiler"
        print(f"kernel_ms: the profiler saw no launch of {kernel!r} in {reps} calls", file=sys.stderr)
    return event_pairs_ms(fn, reps), "events"


def event_pairs_ms(fn, reps: int) -> float:
    """Median device time of one call of fn over reps calls, each between two
    CUDA events. A spin kernel holds the stream while the host queues them
    all, so each pair brackets the device's run of that call alone, not the
    host's launch; raises if the host took longer to queue them than the
    spin lasted."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    spin_start, spin_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_start.record()
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
    spin_end.record()
    t0 = time.perf_counter()
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= spin_start.elapsed_time(spin_end):
        raise RuntimeError(f"event_pairs_ms: queuing {reps} calls took {host_ms:.3f} ms, longer than the spin")
    return statistics.median(start.elapsed_time(end) for start, end in pairs)
