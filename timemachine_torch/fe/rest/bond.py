"""Canonical interaction-index tuples: bonds, angles, propers (counterpart
of timemachine_tpu/fe/rest/bond.py).

A term's index tuple is canonical when its first index is less than its
last; reversing the whole tuple keeps the interaction (bond (i, j) = (j, i),
angle (i, j, k) = (k, j, i), proper (i, j, k, l) = (l, k, j, i)), so one
frozen dataclass holds every arity and canonicalizes by reversal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Ixn:
    """A canonicalized interaction: idxs[0] < idxs[-1] always holds."""

    idxs: tuple[int, ...]

    def __post_init__(self):
        if self.idxs[0] >= self.idxs[-1]:
            raise ValueError(f"{self.idxs} is not canonical")

    @classmethod
    def of(cls, *idxs: int) -> "Ixn":
        ordered = tuple(int(i) for i in idxs)
        return cls(ordered if ordered[0] < ordered[-1] else ordered[::-1])

    def map(self, f: Callable[[int], int]) -> "Ixn":
        return Ixn.of(*(f(i) for i in self.idxs))

    def translate(self, a_to_b) -> "Ixn":
        """Relabel through an index array or mapping (e.g. mol A -> combined)."""
        return self.map(lambda i: int(a_to_b[i]))

    def __iter__(self):
        return iter(self.idxs)


def mkbond(i, j) -> Ixn:
    return Ixn.of(i, j)


def mkangle(i, j, k) -> Ixn:
    return Ixn.of(i, j, k)


def mkproper(i, j, k, l) -> Ixn:
    return Ixn.of(i, j, k, l)


# the JAX package's arity-named aliases
CanonicalIxn = Ixn
CanonicalBond = Ixn
CanonicalAngle = Ixn
CanonicalProper = Ixn
