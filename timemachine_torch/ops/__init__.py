"""Tensor math of the potentials, and the pair sweeps with their CUDA kernels."""
