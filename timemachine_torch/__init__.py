"""timemachine_torch: the PyTorch + CUDA port of timemachine_tpu for NVIDIA Hopper.

The JAX package `timemachine_tpu` stays the reference; this package mirrors
its module paths so each counterpart is easy to find. It imports `torch`
and never `jax`. Plain tensor code is PyTorch; the one kernel on the MD main
path, the rowscan pair sweep, is a hand-written CUDA kernel
(`csrc/rowscan.cu`), built with `nvcc` at first use on a CUDA device.

Slice 1 covers the apo NPT main path: the DHFR loader, bonded and nonbonded
potentials, the Langevin integrator, the Monte Carlo barostat, FIRE and the
MD Context.
"""

__version__ = "0.1.0"
