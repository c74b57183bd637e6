"""bf16 vs f32 rate probe of the pair sweeps' distance-and-gate sequence
(counterpart of the kernel in scripts/probe_bf16.py::probe_rate): per
element of a (256, 1024) block, ITERS times, in the working type,

    sh = 1 + t * 1e-3 (in f32, then rounded)
    dx = a - b sh,  dy = a sh - b,  dz = a - b,  r2 = (dx dx + dy dy) + dz dz
    acc = acc + (f32(r2) < 1.44)

and out = f32(acc): 3 subtractions, 3 multiplications, 2 additions and a
compare per slot, the sequence a bf16 distance prefilter would run.

`bf16_rate` launches the hand-written CUDA kernel (`csrc/probe_bf16.cu`) on
CUDA tensors and uses `bf16_rate_plain`, the same function in plain PyTorch,
on CPU tensors. The CPU census half of the script is not a kernel and is
not ported here.

Usage on a card:  python -m timemachine_torch.probes.bf16_rate
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from timemachine_torch.device import resolve_device
from timemachine_torch.ops import _build
from timemachine_torch.ops.rowscan_kernel import check_tensor
from timemachine_torch.probes import kernel_ms

SUB, LANE, ITERS = 256, 1024, 64  # the TPU script's block and sweep iterations
CUT2 = 1.44
OPS_PER_SLOT = 10  # 3 sub, 3 mul, 2 add, the compare and the count


def inputs(device=None, shape=(SUB, LANE)):
    """(a, b) f32 in [0.2, 2) from seeds 0 and 1, as the script makes them."""
    dev = resolve_device(device)
    a, b = (np.random.default_rng(s).uniform(0.2, 2.0, shape).astype(np.float32) for s in (0, 1))
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def _shift(t: int, dtype) -> float:
    """1 + t * 1e-3 in f32, rounded to dtype, as a float."""
    sh = np.float32(1.0) + np.float32(t) * np.float32(1e-3)
    return float(torch.tensor(float(sh), dtype=torch.float32).to(dtype))


def bf16_rate_plain(a, b, dtype=torch.bfloat16, iters: int = ITERS, cut2: float = CUT2):
    """The probe's function in plain PyTorch: every operation a separate
    tensor operation in dtype, which rounds to dtype as the kernel's
    intrinsics do, so the kernel matches bit for bit."""
    bf16_rate_plain.calls += 1
    av, bv = a.to(dtype), b.to(dtype)
    acc = torch.zeros_like(av)
    for t in range(iters):
        sh = _shift(t, dtype)
        dx = av - bv * sh
        dy = av * sh - bv
        dz = av - bv
        r2 = dx * dx + dy * dy + dz * dz
        acc = acc + (r2.float() < cut2).to(dtype)
    return acc.float()


bf16_rate_plain.calls = 0


def _launcher():
    fn = _build.load_library("probe_bf16").gate_rate_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bf16_rate(a, b, dtype=torch.bfloat16, iters: int = ITERS, cut2: float = CUT2):
    """The probe on a, b (same shape, contiguous f32) in dtype bfloat16 or
    float32: a CUDA tensor launches the kernel of csrc/probe_bf16.cu on the
    current stream, a CPU tensor runs bf16_rate_plain."""
    if a.device.type == "cpu":
        return bf16_rate_plain(a, b, dtype, iters, cut2)
    if a.device.type != "cuda":
        raise ValueError(f"bf16_rate: no kernel for device {a.device}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bf16_rate: dtype must be bfloat16 or float32, got {dtype}")
    check_tensor("a", a, torch.float32, a.device)
    check_tensor("b", b, torch.float32, a.device, tuple(a.shape))
    n = a.numel()
    if (dtype == torch.bfloat16 and n % 2) or n >= 2**31:
        raise ValueError(f"bf16_rate: {n} elements (bf16 takes an even count below 2^31)")
    out = torch.empty_like(a)
    rc = _launcher()(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, iters, float(np.float32(cut2)), int(dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bf16_rate: kernel launch failed with CUDA error {rc}")
    bf16_rate.launches += 1
    return out


bf16_rate.launches = 0


def time_ms(a, b, dtype, reps: int = 200) -> float:
    """Device time per launch on a's card."""
    return kernel_ms(lambda: bf16_rate(a, b, dtype), reps, "gate_bf16" if dtype == torch.bfloat16 else "gate_f32")


if __name__ == "__main__":
    a, b = inputs()
    ms = {dt: time_ms(a, b, dt) for dt in (torch.float32, torch.bfloat16)}
    for dt, t in ms.items():
        print(f"{dt}: {t * 1e3:.2f} us/call, {t * 1e9 / (a.numel() * ITERS):.3f} ps/slot-iteration")
    print(f"{torch.cuda.get_device_name(0)}: bf16 speedup over f32 {ms[torch.float32] / ms[torch.bfloat16]:.2f}x")
