"""FP32 peak probe (counterpart of the kernel in
scripts/probe_mfu.py::measure_vpu_peak): four cross-coupled FMA chains per
element, INNER steps each, over the script's grid of 256 (8, 1024) blocks.

`fp32_peak` launches the hand-written CUDA kernel (`csrc/probe_fma.cu`) on
CUDA tensors and uses `fp32_peak_plain`, the same function in plain PyTorch,
on CPU tensors. `measure` times the kernel at INNER and at twice INNER: a
rate is trusted only where the time doubles with the work, which the TPU
version's did not (its compiler folded the loop).

Usage on a card:  python -m timemachine_torch.probes.fp32_peak
"""

from __future__ import annotations

import ctypes
import math
import time

import numpy as np
import torch

from timemachine_torch.device import resolve_device
from timemachine_torch.ops import _build
from timemachine_torch.ops.rowscan_kernel import check_tensor
from timemachine_torch.probes import queued_ms

GRID, ROWS, LANES = 256, 8, 1024  # the TPU script's grid and block
INNER = 512
MULTIPLIERS, ADDEND = (1.0000001, 1.0000002, 1.0000003), 1e-7  # as in the script, rounded to f32


def _f32(v: float) -> float:
    return float(np.float32(v))


def inputs(device=None, seed: int = 0, shape=(GRID * ROWS, LANES)):
    """(GRID * ROWS, LANES) f32 in [0.5, 0.99) from `seed`: every product
    stays below 1, so the chains fall to their fixed point near ADDEND and
    stay finite (the script's ones grow to inf, as does any start within
    about 1e-6 of 1)."""
    x = np.random.default_rng(seed).uniform(0.5, 0.99, shape).astype(np.float32)
    return torch.as_tensor(x, device=resolve_device(device))


def fma_f32(a, b, c):
    """a * b + c for f32 tensors a, b and a float c, rounded once to f32 as
    fmaf rounds. The product is exact in f64; the f64 sum's rounding error
    (TwoSum) decides the one case the f64 sum cannot: a sum that lands
    exactly halfway between two f32 values."""
    p = a.double() * b.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)  # a * b + c == s + err exactly
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, math.inf, -math.inf).to(r.dtype)
    n = torch.nextafter(r, toward)  # the f32 neighbour of r on s's side
    tie = (d != 0) & (r.double() + n.double() == 2.0 * s)
    return torch.where(tie & (err * d > 0), n, r)


def fp32_peak_plain(x, inner: int = INNER, multipliers=MULTIPLIERS, addend: float = ADDEND):
    """The probe's function in plain PyTorch: each FMA by fma_f32, the other
    operations in f32, in the kernel's order, so the kernel matches bit for
    bit."""
    fp32_peak_plain.calls += 1
    m1, m2, m3 = (_f32(m) for m in multipliers)
    c = _f32(addend)
    a0 = x
    a1, a2, a3 = a0 * m1, a0 * m2, a0 * m3
    for _ in range(inner):
        a0, a1, a2, a3 = fma_f32(a0, a1, c), fma_f32(a1, a2, c), fma_f32(a2, a3, c), fma_f32(a3, a0, c)
    return ((a0 + a1) + a2) + a3


fp32_peak_plain.calls = 0


def _launcher():
    fn = _build.load_library("probe_fma").fma_chains_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fp32_peak(x, inner: int = INNER, multipliers=MULTIPLIERS, addend: float = ADDEND):
    """The probe on x (any shape, contiguous f32): a CUDA tensor launches
    the kernel of csrc/probe_fma.cu on the current stream, a CPU tensor runs
    fp32_peak_plain."""
    if x.device.type == "cpu":
        return fp32_peak_plain(x, inner, multipliers, addend)
    if x.device.type != "cuda":
        raise ValueError(f"fp32_peak: no kernel for device {x.device}")
    check_tensor("x", x, torch.float32, x.device)
    if inner < 0 or x.numel() >= 2**31:
        raise ValueError(f"fp32_peak: want 0 <= inner and fewer than 2^31 elements, got {inner}, {x.numel()}")
    out = torch.empty_like(x)
    rc = _launcher()(
        x.data_ptr(), out.data_ptr(), x.numel(), inner, *(_f32(m) for m in multipliers), _f32(addend),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fp32_peak: kernel launch failed with CUDA error {rc}")
    fp32_peak.launches += 1
    return out


fp32_peak.launches = 0


def flops(n: int, inner: int = INNER) -> int:
    """FP32 operations of the chains on n elements, an FMA counted as 2."""
    return 2 * 4 * inner * n


def measure(x, inner: int = INNER, reps: int = 20, warm_s: float = 0.5):
    """(TFLOP/s at inner, ms at inner, ms at 2 * inner) on x's card: the
    device time per launch over reps launches at inner, then over reps at
    2 * inner (probes.queued_ms), after warm_s seconds of launches that bring
    the clocks up."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        fp32_peak(x, 2 * inner)
        torch.cuda.synchronize()
    ms, ms2 = (queued_ms(lambda k=k: fp32_peak(x, k), reps) for k in (inner, 2 * inner))
    return flops(x.numel(), inner) / (ms * 1e-3) / 1e12, ms, ms2


if __name__ == "__main__":
    x = inputs()
    tflops, ms, ms2 = measure(x)
    print(f"{torch.cuda.get_device_name(0)}: {tflops:.2f} TFLOP/s FP32 ({ms:.4f} ms at INNER {INNER}, "
          f"{ms2:.4f} ms at {2 * INNER}, ratio {ms2 / ms:.3f}; from the difference "
          f"{flops(x.numel(), INNER) / ((ms2 - ms) * 1e-3) / 1e12:.2f} TFLOP/s)")
