"""End-state term alignment and λ-windowed parameter interpolation.

Capability target: reference timemachine/fe/interpolate.py. Two alchemical
end states carry per-term parameter tables (bonds, angles, torsions, chiral
volumes, nonbonded pairs); an intermediate state interpolates between them.
Terms present in only one end state are padded into the other with a
"soft-off" default (zero force constant / zero charge) so both tables share
one index set.

Design here: alignment is a deterministic **sorted outer join** over
canonical term keys (returns parallel rows, already ordered — callers never
re-sort), with per-term-type join behavior declared as small functions
rather than a partial-application chain. Interpolation schedules are
composable scalar functions of λ, applied inside per-term [λ_min, λ_max]
windows with exact end-state pinning outside the window.

The port of timemachine_tpu/fe/interpolate.py: the schedules are torch f64
(differentiable in the parameters), with `interp` the same arithmetic as
jnp.interp. Its exp and log may differ from XLA's by an ulp.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from timemachine_torch.ff.handlers import as_f64


class DuplicateAlignmentKeysError(RuntimeError):
    pass


class AlignedRow(NamedTuple):
    idxs: tuple
    src: tuple
    dst: tuple


def _freeze(v):
    """Recursively convert array-likes to nested tuples (hashable, sortable)."""
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_freeze(e) for e in v)
    if isinstance(v, (np.generic,)):
        return v.item()
    return v


def outer_join_terms(
    src_idxs,
    src_params,
    dst_idxs,
    dst_params,
    *,
    soft_off: Callable,
    join_key: Optional[Callable] = None,
    key_to_idxs: Optional[Callable] = None,
    check_idxs: Optional[Callable] = None,
):
    """Full outer join of two term tables on a canonical key.

    soft_off(params_other) supplies the missing side's parameters (typically
    zero force constant with geometry copied from the present side, so the
    term's energy — not its rest geometry — turns off).
    join_key(idxs, params) -> hashable key (default: the idxs themselves).
    key_to_idxs recovers idxs from a key when join_key folds params in.

    Returns a list of AlignedRow sorted by key — deterministic, duplicates
    rejected.
    """
    join_key = join_key or (lambda idxs, _p: idxs)
    key_to_idxs = key_to_idxs or (lambda k: k)

    def to_table(all_idxs, all_params, label):
        table = {}
        for idxs, params in zip(all_idxs, all_params):
            if check_idxs is not None:
                check_idxs(idxs)
            k = _freeze(join_key(_freeze(idxs), params))
            if k in table:
                raise DuplicateAlignmentKeysError(f"duplicate {label} key {k}")
            table[k] = params
        return table

    src_table = to_table(src_idxs, src_params, "src")
    dst_table = to_table(dst_idxs, dst_params, "dst")

    rows = []
    for k in sorted(src_table.keys() | dst_table.keys()):
        s = src_table.get(k)
        d = dst_table.get(k)
        rows.append(
            AlignedRow(
                key_to_idxs(k),
                _freeze(s) if s is not None else _freeze(soft_off(d)),
                _freeze(d) if d is not None else _freeze(soft_off(s)),
            )
        )
    return rows


def _require_canonical(idxs):
    assert idxs[0] < idxs[-1], f"non-canonical term idxs {idxs}"


# -- per-term-type joins ------------------------------------------------------
# Parameter layouts: bond (k, b0); angle (k, a0, eps); torsion (k, phase,
# period); chiral atom k; nonbonded pair (q, sig, eps, w).


def align_harmonic_bond_idxs_and_params(src_idxs, src_params, dst_idxs, dst_params):
    return outer_join_terms(
        src_idxs,
        src_params,
        dst_idxs,
        dst_params,
        soft_off=lambda p: (0, p[1]),
        check_idxs=_require_canonical,
    )


def align_harmonic_angle_idxs_and_params(src_idxs, src_params, dst_idxs, dst_params):
    return outer_join_terms(
        src_idxs, src_params, dst_idxs, dst_params, soft_off=lambda p: (0, p[1], 0)
    )


def align_nonbonded_idxs_and_params(src_idxs, src_params, dst_idxs, dst_params):
    return outer_join_terms(
        src_idxs, src_params, dst_idxs, dst_params, soft_off=lambda _p: (0, 0, 0, 0)
    )


def align_chiral_atom_idxs_and_params(src_idxs, src_params, dst_idxs, dst_params):
    return outer_join_terms(src_idxs, src_params, dst_idxs, dst_params, soft_off=lambda _p: 0)


def align_proper_idxs_and_params(src_idxs, src_params, dst_idxs, dst_params):
    # propers join on (idxs, phase, period): multiple phase/period terms may
    # share idxs, and only matching shapes may interpolate into each other
    return outer_join_terms(
        src_idxs,
        src_params,
        dst_idxs,
        dst_params,
        soft_off=lambda p: (0, p[1], p[2]),
        join_key=lambda idxs, p: (idxs, _freeze(p[1]), _freeze(p[2])),
        key_to_idxs=lambda k: k[0],
    )


def align_improper_idxs_and_params(src_idxs, src_params, dst_idxs, dst_params):
    return outer_join_terms(
        src_idxs, src_params, dst_idxs, dst_params, soft_off=lambda p: (0, p[1], p[2])
    )


def align_chiral_bond_idxs_and_params(src_idxs, src_params, src_signs, dst_idxs, dst_params, dst_signs):
    """Chiral bonds join on (idxs, sign); rows come back flattened as
    (idxs, sign, k_src, k_dst)."""
    rows = outer_join_terms(
        src_idxs,
        [(s, p) for s, p in zip(src_signs, src_params)],
        dst_idxs,
        [(s, p) for s, p in zip(dst_signs, dst_params)],
        soft_off=lambda sp: (sp[0], 0),
        join_key=lambda idxs, sp: (idxs, _freeze(sp[0])),
        key_to_idxs=lambda k: k[0],
    )
    return [(r.idxs, r.src[0], r.src[1], r.dst[1]) for r in rows]


# -- λ schedules --------------------------------------------------------------


def linear_interpolation(src_params, dst_params, lamb):
    """Straight-line blend."""
    return (1 - lamb) * src_params + lamb * dst_params


def log_linear_interpolation(src_params, dst_params, lamb, min_value):
    """Geometric blend, with both endpoints floored at min_value so that a
    zero force constant has a finite log. Endpoint values below min_value are
    therefore NOT recovered at λ∈{0,1}; combine with `pad` for exact pinning."""
    floor = torch.tensor(min_value, dtype=torch.float64)
    lo = torch.log(torch.maximum(as_f64(src_params), floor))
    hi = torch.log(torch.maximum(as_f64(dst_params), floor))
    return torch.exp(linear_interpolation(lo, hi, lamb))


def pad(f, src_params, dst_params, lamb, lambda_min, lambda_max):
    """Run schedule f over the rescaled window [lambda_min, lambda_max];
    outside it, pin EXACTLY to the end-state parameters (not f's endpoint
    values — this is what makes log-space schedules safe for k=0 terms)."""
    src_params, dst_params, lamb = as_f64(src_params), as_f64(dst_params), as_f64(lamb)
    local = (lamb - lambda_min) / (lambda_max - lambda_min)
    inner = f(src_params, dst_params, local)
    return torch.where(lamb <= lambda_min, src_params, torch.where(lamb >= lambda_max, dst_params, inner))


def interp(x, xp, fp):
    """jnp.interp(x, xp, fp) with xp increasing: the same operations in f64."""
    x, xp, fp = as_f64(x), as_f64(xp), as_f64(fp)
    i = torch.clamp(torch.searchsorted(xp, x.reshape(-1), right=True).reshape(x.shape), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
