"""MBAR, the multistate Bennett acceptance ratio (counterpart of
timemachine_tpu/fe/mbar.py): the self-consistent solve of the MBAR equations
and the asymptotic covariance (Shirts & Chodera, J. Chem. Phys. 129,
124105 (2008)).

Everything computes in f64 on the device of its inputs (numpy inputs: the
CPU). `solve_mbar` is differentiable in u_kn: its backward pass is the
implicit derivative of the fixed point, a torch.autograd.Function.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DEFAULT_RELATIVE_TOLERANCE = 1e-6
DEFAULT_MAXIMUM_ITERATIONS = 1_000


def _f64(a, device=None):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def self_consistent_update(f_k, u_kn, log_n_k):
    """One fixed-point update f_k <- -log sum_n exp(-u_kn - log_denom_n), for
    f_k (..., K) and u_kn (..., K, N). A sample with u = +inf in every state
    has log_denom = -inf and carries no measure: its terms are -inf, not NaN."""
    log_denom_n = torch.logsumexp(f_k[..., :, None] + log_n_k[:, None] - u_kn, dim=-2)
    terms = -u_kn - log_denom_n[..., None, :]
    terms = torch.where(torch.isneginf(log_denom_n)[..., None, :], -torch.inf, terms)
    return -torch.logsumexp(terms, dim=-1)


def _fixed_point(u_kn, n_k, f_k0, relative_tolerance, maximum_iterations):
    """(f_k, iterations): iterate until max |f - f_prev| <= tol max(max |f|, 1),
    each iterate shifted so that f_0 = 0. Leading dimensions of u_kn and
    f_k0 are a batch of problems iterated together, each held where it
    stopped, so that each ends as it would alone; one host sync a step."""
    log_n_k = torch.log(n_k)
    f_k, f_prev = f_k0, f_k0 + 1.0
    iterations = torch.zeros(f_k.shape[:-1], dtype=torch.int64, device=f_k.device)
    for _ in range(maximum_iterations):
        delta = torch.amax(torch.abs(f_k - f_prev), dim=-1)
        active = delta > relative_tolerance * torch.clamp(torch.amax(torch.abs(f_k), dim=-1), min=1.0)
        if not bool(active.any()):
            break
        f_new = self_consistent_update(f_k, u_kn, log_n_k)
        f_new = f_new - f_new[..., :1]
        f_prev = torch.where(active[..., None], f_k, f_prev)
        f_k = torch.where(active[..., None], f_new, f_k)
        iterations += active
    return f_k, iterations


class _SolveMBAR(torch.autograd.Function):
    """f_k at the default tolerance, with the implicit-derivative backward:
    (I - J) df = B du with J = d scu / df singular along the ones vector;
    the pseudo-inverse solve plus the f_0 = 0 gauge gives the VJP
    B^T (I - J)^{+T} P^T g."""

    @staticmethod
    def forward(ctx, u_kn, n_k):
        f_k, _ = _fixed_point(
            u_kn, n_k, u_kn.new_zeros(u_kn.shape[0]), DEFAULT_RELATIVE_TOLERANCE, DEFAULT_MAXIMUM_ITERATIONS
        )
        ctx.save_for_backward(f_k, u_kn, n_k)
        return f_k

    @staticmethod
    def backward(ctx, g):
        f_k, u_kn, n_k = ctx.saved_tensors
        log_n_k = torch.log(n_k)
        jac = torch.func.jacfwd(lambda f: self_consistent_update(f, u_kn, log_n_k))(f_k)
        a = torch.eye(len(f_k), dtype=u_kn.dtype, device=u_kn.device) - jac
        w = g.clone()
        w[0] = g[0] - torch.sum(g)
        v = torch.linalg.pinv(a.T, rtol=1e-10) @ w
        _, vjp = torch.func.vjp(lambda u: self_consistent_update(f_k, u, log_n_k), u_kn)
        (grad_u,) = vjp(v)
        return grad_u, None


def solve_mbar(
    u_kn,
    n_k,
    initial_f_k: Optional[np.ndarray] = None,
    relative_tolerance: float = DEFAULT_RELATIVE_TOLERANCE,
    maximum_iterations: int = DEFAULT_MAXIMUM_ITERATIONS,
):
    """(f_k with f_0 = 0, iterations) for u_kn (K, N_total), the reduced
    energy of every sample in every state, and n_k the samples drawn from
    each state. At the default settings the result is differentiable in
    u_kn (iterations then read -1, as in the JAX package). Given
    initial_f_k or other settings, u_kn (B, K, N_total) solves B problems
    of one n_k together (the bootstrap's replicates)."""
    u_kn = _f64(u_kn)
    n_k = _f64(n_k, u_kn.device)
    if initial_f_k is None and relative_tolerance == DEFAULT_RELATIVE_TOLERANCE and maximum_iterations == DEFAULT_MAXIMUM_ITERATIONS:
        return _SolveMBAR.apply(u_kn, n_k), -1
    f_k0 = u_kn.new_zeros(u_kn.shape[-2]) if initial_f_k is None else _f64(initial_f_k, u_kn.device)
    return _fixed_point(u_kn, n_k, f_k0.expand(u_kn.shape[:-1]), relative_tolerance, maximum_iterations)


def kln_to_kn(u_kln, N_k=None):
    """(K, K, N_max) u_kln (frames of k in state l) -> the (K, N_total) u_kn
    layout, dropping padding beyond N_k[k]. Numpy."""
    u_kln = np.asarray(u_kln)
    K = u_kln.shape[0]
    N_k = np.full(K, u_kln.shape[2], dtype=int) if N_k is None else np.asarray(N_k, dtype=int)
    return np.concatenate([u_kln[k, :, : N_k[k]] for k in range(K)], axis=1)


def mbar_weights(f_k, u_kn, n_k):
    """W[n, k] = exp(f_k - u_kn) / sum_l n_l exp(f_l - u_ln); columns sum to
    1, and a sample with u = +inf in every state has zero weight."""
    f_k, u_kn = _f64(f_k), _f64(u_kn)
    log_n_k = torch.log(_f64(n_k, u_kn.device))
    log_denom_n = torch.logsumexp(f_k[:, None] + log_n_k[:, None] - u_kn, dim=0)
    log_w = f_k[:, None] - u_kn - log_denom_n[None, :]
    log_w = torch.where(torch.isneginf(log_denom_n)[None, :], -torch.inf, log_w)
    return torch.exp(log_w).T  # (N, K)


def asymptotic_covariance(w, n_k):
    """Theta = V S (I - S V^T diag(N) V S)^+ S V^T (Shirts & Chodera, App. D)."""
    w = _f64(w)
    _, s_, vt_ = torch.linalg.svd(w, full_matrices=False)
    v = vt_.T
    s = torch.diag(s_)
    inner = torch.eye(len(s_), dtype=w.dtype, device=w.device) - s @ vt_ @ torch.diag(_f64(n_k, w.device)) @ v @ s
    return v @ s @ torch.linalg.pinv(inner, rtol=1e-10) @ s @ vt_


class MBAR:
    """The pymbar-like surface: MBAR(u_kn, N_k), compute_free_energy_differences,
    compute_overlap. Results are numpy."""

    def __init__(
        self,
        u_kn,
        n_k,
        initial_f_k=None,
        maximum_iterations: int = DEFAULT_MAXIMUM_ITERATIONS,
        relative_tolerance: float = DEFAULT_RELATIVE_TOLERANCE,
    ):
        self.u_kn = _f64(u_kn)
        self.n_k = _f64(n_k, self.u_kn.device)
        with torch.no_grad():
            f_k, n_iter = solve_mbar(
                self.u_kn, self.n_k, initial_f_k=initial_f_k, relative_tolerance=relative_tolerance,
                maximum_iterations=maximum_iterations,
            )
        self.f_k = f_k.cpu().numpy()
        self.n_iterations = int(n_iter)

    @property
    def weights(self):
        return mbar_weights(torch.as_tensor(self.f_k, device=self.u_kn.device), self.u_kn, self.n_k).cpu().numpy()

    def compute_free_energy_differences(self, compute_uncertainty: bool = True):
        result = {"Delta_f": self.f_k[None, :] - self.f_k[:, None]}
        if compute_uncertainty:
            theta = asymptotic_covariance(self.weights, self.n_k.cpu().numpy()).cpu().numpy()
            d2 = theta.diagonal()[None, :] + theta.diagonal()[:, None] - 2 * theta
            result["dDelta_f"] = np.sqrt(np.where(d2 > 0, d2, 0.0))
        return result

    def compute_overlap(self):
        w = self.weights
        return {"matrix": self.n_k.cpu().numpy()[:, None] * (w.T @ w)}


def exp_estimator(w):
    """Exponential averaging (Zwanzig): dF = -log <exp(-w)>."""
    w = _f64(w).reshape(-1)
    return -(torch.logsumexp(-w, dim=0) - np.log(float(w.numel())))
