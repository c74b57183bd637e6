"""Map-augmented free-energy estimator inputs, targeted FEP (the port of
timemachine_tpu/maps/estimators.py; Jarzynski 2002, Paliwal & Shirts 2013).

Given invertible configuration maps M[i -> j] with a tractable log|det J|,
reduced works and u_kn matrices take a Jacobian correction:
u'_j(M(x)) = u_j(M(x)) - log|det J(x)|. The energies and maps may return
numpy arrays or tensors on any device; the results are float64 numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mapped_work", "mapped_u_kn", "compute_mapped_reduced_work", "compute_mapped_u_kn"]


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def mapped_work(samples, u_src, u_dst, map_fn) -> np.ndarray:
    """Reduced work of carrying `samples` from state src to state dst
    through the invertible map: u_dst(M(x)) - u_src(x) - log|det J_M(x)|."""
    y, logdetjac = map_fn(samples)
    return _np(u_dst(y)) - _np(u_src(samples)) - _np(logdetjac)


def mapped_u_kn(sample_lists, reduced_energy_fns, map_fns) -> np.ndarray:
    """(K, N_tot) reduced-energy matrix for MBAR, the samples of state k
    carried into each state l by map_fns[k, l] before evaluation; columns
    [sum(N[:k]), sum(N[:k+1])) hold state k's samples (fe.mbar's layout).
    The caller guarantees that map_fns[k, l] inverts map_fns[l, k]."""
    n_states = len(sample_lists)
    if len(reduced_energy_fns) != n_states:
        raise ValueError("one reduced-energy fn per state required")

    blocks = []
    for k, xs in enumerate(sample_lists):
        rows = []
        for l, u_l in enumerate(reduced_energy_fns):
            ys, logdetjac = map_fns[k, l](xs)
            rows.append(_np(u_l(ys)) - _np(logdetjac))
        blocks.append(np.stack(rows))  # (K, N_k)

    u_kn = np.concatenate(blocks, axis=1)
    assert u_kn.shape == (n_states, sum(len(xs) for xs in sample_lists))
    return u_kn


compute_mapped_reduced_work = mapped_work
compute_mapped_u_kn = mapped_u_kn
