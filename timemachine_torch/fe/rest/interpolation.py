"""λ-schedules on [0, 1] for REST's energy scaling (counterpart of
timemachine_tpu/fe/rest/interpolation.py).

Every schedule is a linear blend under a monotone warp w,

    f(x) = w^-1((1 - x) w(src) + x w(dst))

with w the identity ("linear"), sqrt ("quadratic") or log ("exponential":
src (dst / src)^x), the endpoints pinned exactly. Symmetric folds λ about
0.5, f(1 - |2λ - 1|): f(0) = f(1) = src and f(0.5) = dst. Its `dst` returns
the inner schedule's src, as the JAX package's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Union

import numpy as np

InterpolationFxnName = Literal["linear", "quadratic", "exponential"]

_WARPS = {
    "linear": (lambda v: v, lambda v: v),
    "quadratic": (np.sqrt, np.square),
    "exponential": (np.log, np.exp),
}


@dataclass(frozen=True)
class Schedule:
    """Warped linear blend from src (x = 0) to dst (x = 1), endpoints exact."""

    shape: InterpolationFxnName
    src: float
    dst: float

    def __post_init__(self):
        if self.shape not in _WARPS:
            raise ValueError(f"{self.shape} is invalid")
        if self.shape in ("quadratic", "exponential") and not (
            np.all(np.asarray(self.src) > 0) and np.all(np.asarray(self.dst) > 0)
        ):
            raise ValueError(f"{self.shape} schedule requires positive endpoints")

    def __call__(self, x):
        warp, unwarp = _WARPS[self.shape]
        x = np.asarray(x)
        blended = unwarp((1.0 - x) * warp(np.asarray(self.src)) + x * warp(np.asarray(self.dst)))
        return np.where(x == 0.0, self.src, np.where(x == 1.0, self.dst, blended))


@dataclass(frozen=True)
class Symmetric:
    """g(x) = f(1 - |2x - 1|): g(0) = g(1) = f(0) and g(0.5) = f(1)."""

    f: "InterpolationFxn"

    @property
    def src(self):
        return self.f.src

    @property
    def dst(self):
        return self.f.src

    def __call__(self, x):
        x = np.asarray(x)
        return self.f(1.0 - np.abs(2.0 * x - 1.0))


InterpolationFxn = Union[Schedule, Symmetric]


def Linear(src, dst) -> Schedule:
    return Schedule("linear", src, dst)


def Quadratic(src, dst) -> Schedule:
    return Schedule("quadratic", src, dst)


def Exponential(src, dst) -> Schedule:
    return Schedule("exponential", src, dst)


def get_interpolation_fxn(name: InterpolationFxnName, src, dst) -> Schedule:
    return Schedule(name, src, dst)
