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
on CPU tensors. The redesign gates bf16 in packed bf16 against
`gate_threshold_bf16(cut2)`; `first_design=True` launches the first design,
which gates in f32. `measure` times both at ITERS x MULTIPLES iterations:
the least-squares slope is the marginal time per ITERS iterations, the
intercept the fixed cost of a launch. The census half of the script is
`timemachine_torch.probes.tile_census`.

Usage on a card:  python -m timemachine_torch.probes.bf16_rate
(the times at each multiple, slopes, intercepts and speed-ups, the loops'
SASS instruction counts from cuobjdump, and the tile census of the DHFR
start)
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from timemachine_torch.device import resolve_device
from timemachine_torch.ops import _build
from timemachine_torch.ops.rowscan_kernel import check_tensor
from timemachine_torch.probes import kernel_ms, queued_ms

SUB, LANE, ITERS = 256, 1024, 64  # the TPU script's block and sweep iterations
CUT2 = 1.44
OPS_PER_SLOT = 10  # 3 sub, 3 mul, 2 add, the compare and the count
ELEMS = 2  # f32 elements or bf16 element pairs per thread of the redesign: mirrors csrc/probe_bf16.cu
THREADS = 128  # threads per block of the redesign: mirrors csrc/probe_bf16.cu
MULTIPLES = (1, 4, 8, 16, 32)  # measure's iteration counts, in ITERS
KERNELS = {  # (dtype, first_design) -> the kernel's name in csrc/probe_bf16.cu
    (torch.float32, False): "f32_gate_wave", (torch.bfloat16, False): "bf16_gate_wave",
    (torch.float32, True): "gate_f32", (torch.bfloat16, True): "gate_bf16",
}


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


def gate_threshold_bf16(cut2: float) -> int:
    """The bits of T, the smallest bf16 value >= f32(cut2). For every bf16
    r2, f32(r2) < cut2 exactly when r2 < T (a bf16 value below T is at most
    its predecessor, which lies below cut2 since T is the least >= cut2; NaN
    is false on both sides), so the kernel gates in packed bf16."""
    c = np.float32(cut2)
    if np.isnan(c):
        raise ValueError("gate_threshold_bf16: cut2 is NaN")
    u = int(c.view(np.uint32))
    if u & 0xFFFF == 0 or u >> 31:  # exact in bf16, or negative: dropping low bits rounds toward +inf
        return u >> 16
    return (u >> 16) + 1  # positive: the next bf16 up (past the largest finite value: +inf)


def _launcher():
    fn = _build.load_library("probe_bf16").gate_rate_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def bf16_rate(a, b, dtype=torch.bfloat16, iters: int = ITERS, cut2: float = CUT2, first_design: bool = False):
    """The probe on a, b (same shape, contiguous f32; 16-byte aligned for
    the redesign) in dtype bfloat16 or float32: a CUDA tensor launches the
    kernel of csrc/probe_bf16.cu on the current stream (the redesign, or
    the first design with first_design=True), a CPU tensor runs
    bf16_rate_plain."""
    if a.device.type == "cpu":
        return bf16_rate_plain(a, b, dtype, iters, cut2)
    if a.device.type != "cuda":
        raise ValueError(f"bf16_rate: no kernel for device {a.device}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bf16_rate: dtype must be bfloat16 or float32, got {dtype}")
    check_tensor("a", a, torch.float32, a.device)
    check_tensor("b", b, torch.float32, a.device, tuple(a.shape))
    n = a.numel()
    if not 0 < n < 2**31 or (dtype == torch.bfloat16 and n % 2) or iters < 0:
        raise ValueError(f"bf16_rate: {n} elements, {iters} iterations (want 0 < n < 2^31, even in bf16, iters >= 0)")
    if not first_design and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("bf16_rate: the redesign loads 16-byte vectors: a and b must be 16-byte aligned")
    out = torch.empty_like(a)
    rc = _launcher()(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, iters, float(np.float32(cut2)), gate_threshold_bf16(cut2),
        int(dtype == torch.bfloat16), int(first_design), torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bf16_rate: kernel launch failed with CUDA error {rc}")
    bf16_rate.launches += 1
    return out


bf16_rate.launches = 0


def time_ms(a, b, dtype, reps: int = 200, first_design: bool = False) -> tuple:
    """(device time per launch at ITERS on a's card, how it was timed):
    probes.kernel_ms."""
    return kernel_ms(lambda: bf16_rate(a, b, dtype, first_design=first_design), reps, KERNELS[dtype, first_design])


REPS = 20  # launches per timing
SPIN_CYCLES = 10_000_000  # about 5 ms at the H100's 1.98 GHz boost clock
WARM_S = 0.5  # seconds of launches before timing, to bring the clocks up


@dataclass
class GateFit:
    """One kernel's times at ITERS x MULTIPLES iterations and their line."""

    ms_by_iters: dict  # iterations -> ms per launch (CUDA events)
    marginal_ms: float  # least-squares slope: ms per ITERS iterations
    fixed_ms: float  # its intercept: ms per launch at no iterations
    ratio: float  # ms at 32 ITERS / ms at 16 ITERS (2 if the time is linear)
    device_ms: float  # the kernel's own device time per launch at ITERS
    timed_by: str  # "profiler", or "events" where the profiler saw no launch (probes.kernel_ms)


def fit(ms_by_iters: dict) -> tuple:
    """(slope per ITERS iterations, intercept) of the least-squares line."""
    x = np.array([k / ITERS for k in ms_by_iters], np.float64)
    slope, intercept = np.polyfit(x, np.array(list(ms_by_iters.values()), np.float64), 1)
    return float(slope), float(intercept)


def measure(a, b, designs=(False, True)) -> dict:
    """{(dtype, first_design): GateFit} for f32 and bf16 and each of
    `designs` on a's card: after WARM_S seconds of launches that bring the
    clocks up, each kernel's time per launch at ITERS x MULTIPLES
    iterations (probes.queued_ms behind a spin of SPIN_CYCLES), and its own device time at ITERS (time_ms)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        bf16_rate(a, b, torch.float32, ITERS * MULTIPLES[-1], first_design=True)
        torch.cuda.synchronize()
    fits = {}
    for dt in (torch.float32, torch.bfloat16):
        for first in designs:
            ms = {ITERS * m: queued_ms(lambda k=ITERS * m: bf16_rate(a, b, dt, k, first_design=first), REPS, SPIN_CYCLES)
                  for m in MULTIPLES}
            slope, intercept = fit(ms)
            ratio = ms[ITERS * MULTIPLES[-1]] / ms[ITERS * MULTIPLES[-2]]
            fits[dt, first] = GateFit(ms, slope, intercept, ratio, *time_ms(a, b, dt, first_design=first))
    return fits


_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


@dataclass
class LoopSass:
    """The hot loop of one kernel in `cuobjdump -sass`."""

    body: Counter  # opcode -> instructions in the loop body
    slots: int  # slot-iterations the body computes, counted by its gates
    fused: int  # FFMA, and HFMA2 that are neither a product (addend RZ) nor a sum (a factor 1)

    @property
    def per_slot(self) -> float:
        return sum(self.body.values()) / max(self.slots, 1)


def _is_fused(op: str, operands: str) -> bool:
    """Whether a SASS instruction fuses a multiply and an add: an FFMA, or
    an HFMA2 whose addend is not RZ and whose factors hold no constant 1."""
    head = op.split(".")[0]
    if head == "FFMA":
        return True
    if head != "HFMA2":
        return False
    src = [t.strip().split(".")[0].lstrip("-|") for t in operands.split(",")[1:]]
    return not (src[-1] == "RZ" or any(t in ("1", "1.0", "RZ") for t in src[:-1]))


def sass_loop_counts() -> dict:
    """{kernel name: LoopSass} from `cuobjdump -sass` of the built
    probe_bf16 library (cuobjdump beside nvcc). A kernel's hot loop is its
    largest innermost loop (a backward branch with no other inside); its
    slot-iterations are counted by its gates (FSET/FSETP one slot each,
    HSET2/HSETP2 two)."""
    lib = _build.library_path("probe_bf16")
    if not lib.exists():
        _build.load_library("probe_bf16")
    cuobjdump = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = next((k for k in KERNELS.values() if k in block.splitlines()[0]), None)
        if name is None:
            continue
        instr = [(int(m.group(1), 16), m.group(3), m.group(4)) for m in _SASS_INSTR.finditer(block)]
        loops = []
        for addr, op, operands in instr:
            target = re.search(r"0x([0-9a-f]+)", operands) if op.startswith("BRA") else None
            if target and int(target.group(1), 16) < addr:
                loops.append((int(target.group(1), 16), addr))
        innermost = [(lo, hi) for lo, hi in loops if not any(lo <= l2 and h2 < hi for l2, h2 in loops)]
        lo, hi = max(innermost, key=lambda lh: lh[1] - lh[0])
        body = [(op, operands) for addr, op, operands in instr if lo <= addr <= hi and op.split(".")[0] != "NOP"]
        ops = Counter(op for op, _ in body)
        slots = sum(c * (2 if op.startswith("HSET") else 1) for op, c in ops.items()
                    if op.split(".")[0] in ("FSET", "FSETP", "HSET2", "HSETP2"))
        out[name] = LoopSass(ops, slots, sum(_is_fused(op, operands) for op, operands in body))
    return out


if __name__ == "__main__":
    from timemachine_torch.probes.tile_census import describe, tile_census
    from timemachine_torch.testsystems.dhfr import setup_dhfr_native

    a, b = inputs()
    card = torch.cuda.get_device_name(0)
    fits = measure(a, b)
    for (dt, first), f in fits.items():
        print(
            f"{KERNELS[dt, first]}: " + ", ".join(f"{k} it {ms * 1e3:.3f} us" for k, ms in f.ms_by_iters.items())
            + f"; marginal {f.marginal_ms * 1e3:.3f} us per {ITERS} iterations, fixed {f.fixed_ms * 1e3:.3f} us, "
            f"ratio 32/16 {f.ratio:.3f}, {f.timed_by} at {ITERS} {f.device_ms * 1e3:.3f} us"
        )
    for first in (False, True):
        f32, bf = fits[torch.float32, first], fits[torch.bfloat16, first]
        print(f"{'first design' if first else 'redesign'}: bf16 speedup over f32 {f32.marginal_ms / bf.marginal_ms:.3f}x "
              f"marginal, {f32.ms_by_iters[ITERS] / bf.ms_by_iters[ITERS]:.3f}x per launch at {ITERS} ({card})")
    for name, loop in sass_loop_counts().items():
        print(f"SASS {name}: {loop.per_slot:.2f} instructions per slot-iteration ({sum(loop.body.values())} over "
              f"{loop.slots}), {loop.fused} fused multiply-adds: " + " ".join(f"{op} {c}" for op, c in sorted(loop.body.items())))
    hc = setup_dhfr_native(waters_first=True)
    print(f"tile census of the DHFR start: {describe(tile_census(hc.conf, hc.box))}")
