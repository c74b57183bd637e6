"""Losses for fitting forcefield parameters to experimental labels
(counterpart of timemachine_tpu/fe/loss.py): scalar or elementwise torch
functions that compose with the estimators of fe/reweighting.py."""

from __future__ import annotations

import math

import torch

from timemachine_torch.constants import KCAL_TO_KJ


def truncated_residuals(predictions, labels, reliable_interval=(-math.inf, math.inf)):
    """Residuals for labels trusted only inside an interval: against a label
    outside it, a prediction is penalized only for crossing the interval's
    boundary, never for its distance to the label.

    >>> import torch
    >>> labels = torch.tensor([0.5, 0.5, 0.5, -6, -6, -6])
    >>> predictions = torch.tensor([-10.0, 0, +10, -10, 0, +10])
    >>> print(truncated_residuals(predictions, labels, (-5, +1)))
    tensor([-10.5000,  -0.5000,   9.5000,   0.0000,   5.0000,  15.0000])
    """
    lo, hi = reliable_interval
    r = predictions - torch.clamp(labels, lo, hi)
    below = torch.clamp(r, min=0.0)  # label under the interval: only over-predictions count
    above = torch.clamp(r, max=0.0)  # label over the interval: only under-predictions count
    return torch.where(labels < lo, below, torch.where(labels > hi, above, r))


def l1_loss(residual):
    """|residual|"""
    return torch.abs(residual)


def pseudo_huber_loss(residual, threshold=KCAL_TO_KJ):
    """hypot(threshold, residual) - threshold: quadratic well below the
    threshold, slope 1 above it. The default threshold is 1 kcal/mol in
    kJ/mol."""
    residual = torch.as_tensor(residual)
    return torch.hypot(torch.full_like(residual, threshold), residual) - threshold


def flat_bottom_loss(residual, threshold=KCAL_TO_KJ):
    """relu(|residual| - threshold): free inside +/- threshold, L1 outside."""
    return torch.relu(torch.abs(residual) - threshold)
