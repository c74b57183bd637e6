"""Fixed-point <-> float converters of the original CUDA engine's force
accumulation (counterpart of timemachine_tpu/fixed_point.py): values times
2^36 as uint64.

These are not the port's kernels' own scale: csrc/fixed_point.cuh sums the
Newton-triangular sweeps' reactions in int64 at 2^32 units per kJ/mol/nm. They are
kept so that analysis code and tests that reason about the original
engine's overflow -> NaN -> +inf semantics round-trip values as JAX's do.
Host numpy, 64-bit whatever the caller's float type.
"""

import numpy as np

FIXED_BITS = 36
FIXED_EXPONENT = 2**FIXED_BITS


def fixed_to_float(v):
    """uint64 fixed point -> float64."""
    return np.float64(np.asarray(v, dtype=np.uint64).astype(np.int64)) / FIXED_EXPONENT


def float_to_fixed(v):
    """float -> uint64 fixed point."""
    return np.asarray(np.float64(v) * FIXED_EXPONENT, dtype=np.int64).astype(np.uint64)
