"""timemachine_torch: the PyTorch + CUDA port of timemachine_tpu for NVIDIA Hopper.

The JAX package `timemachine_tpu` stays the reference; this package mirrors
its module paths so each counterpart is easy to find. It imports `torch`
and never `jax`. Plain tensor code is PyTorch; each kernel is hand-written
CUDA, built with `nvcc` at first use on a CUDA device: the rowscan pair
sweep of the MD main path (`csrc/rowscan.cu`), the block-tile sweep of the
du/dp backward and the `kernel="v1"` path (`csrc/nb_tiles.cu`), the sweeps
of the `kernel="gather"`, `"quad"` and `"dot"` MD providers
(`csrc/gather.cu`, `csrc/quadscan.cu`, `csrc/dotscan.cu`) and two probes of
the card (`csrc/probe_fma.cu`, `csrc/probe_bf16.cu`).

Slice 1 covers the apo NPT main path: the DHFR loader, bonded and nonbonded
potentials, the Langevin integrator, the Monte Carlo barostat, FIRE and the
MD Context. Slice 2 adds forcefield-parameter gradients (`u(x, params,
box)` on every potential), the reweighting estimators and losses.
"""

__version__ = "0.1.0"
