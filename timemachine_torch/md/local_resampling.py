"""Local resampling: an MCMC move applied to a stochastically selected
subset of particles, exactly (the port of
timemachine_tpu/md/local_resampling.py).

Selecting the subset from the current state biases a naive subset move; the
move runs instead against the target augmented with the Bernoulli
log-density of the frozen selection mask, so that the extended chain
(x, mask) -> (x', mask) leaves the original target invariant. The move
runs on the device it is given (None: the card); the mask is drawn by
numpy, as JAX's is.
"""

from __future__ import annotations

import numpy as np
import torch

from timemachine_torch.device import resolve_device, working_dtype


def bernoulli_logpdf(log_p_i, selection_mask):
    """log P(mask | p) from per-particle log-probabilities: the sum of log p
    over the selected particles plus log(1 - p) over the rest, log1p and
    exp kept stable near p -> 1."""
    log_p_i = torch.as_tensor(log_p_i)
    log_q_i = torch.log1p(-torch.exp(torch.clamp(log_p_i, max=-1e-12)))
    mask = torch.as_tensor(selection_mask, device=log_p_i.device)
    return torch.sum(torch.where(mask, log_p_i, log_q_i))


def local_resampling_move(x, target_logpdf_fxn, particle_selection_log_prob_fxn, mcmc_move, rng=None, device=None):
    """One local-resampling step (ref local_resampling.py:7-38): returns
    (x', aux) where mcmc_move(x_sub, subproblem_logpdf) -> (x_sub', aux).

    rng: an optional np.random.Generator for the mask's uniforms; without
    it they come from numpy's global stream, as in JAX's. x is moved to
    `device` (None: the card) in its working dtype, and the functions are
    called on tensors there."""
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device, dtype=working_dtype(device)).clone()
    n = len(x)

    log_p = particle_selection_log_prob_fxn(x)
    p_select = np.exp(np.asarray(torch.as_tensor(log_p).detach().cpu()))
    assert p_select.shape == (n,), "must compute per-particle selection_probs"
    assert 0.0 <= np.min(p_select) and np.max(p_select) <= 1.0, "selection_probs must be in [0,1]"
    draw = rng.random(n) if rng is not None else np.random.rand(n)
    mask = torch.as_tensor(draw < p_select, device=x.device)

    def masked_logpdf(x_full):
        # the target plus the frozen mask's selection density: the correction
        # that makes the subset move exact
        return target_logpdf_fxn(x_full) + bernoulli_logpdf(particle_selection_log_prob_fxn(x_full), mask)

    def subproblem_logpdf(x_sub):
        x_full = x.clone()
        x_full[mask] = torch.as_tensor(x_sub, device=x.device, dtype=x.dtype)
        return masked_logpdf(x_full)

    x_new_sub, aux = mcmc_move(x[mask], subproblem_logpdf)
    x_new = x.clone()
    x_new[mask] = torch.as_tensor(x_new_sub, device=x.device, dtype=x.dtype)
    return x_new, aux
