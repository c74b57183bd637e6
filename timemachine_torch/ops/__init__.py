"""Tensor math of the potentials, and the rowscan pair sweep with its CUDA kernel."""
