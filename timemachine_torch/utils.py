"""Small host-side helpers (the port's copy of what it uses from
timemachine_tpu/utils.py)."""

from __future__ import annotations

from functools import reduce
from itertools import repeat
from typing import Iterator, Sequence


def batches(n: int, batch_size: int) -> Iterator[int]:
    """Sizes of consecutive batches covering n items."""
    assert n >= 0
    assert batch_size > 0
    full, rem = divmod(n, batch_size)
    yield from repeat(batch_size, full)
    if rem:
        yield rem


def not_ragged(xss: Sequence[Sequence]) -> bool:
    """True when every row has the same length."""
    return len({len(xs) for xs in xss}) <= 1


def pairwise_transform_and_combine(xs, transform, combine):
    """Left-fold combine(acc, transform(x)) with xs[0] as the seed."""
    return reduce(lambda acc, x: combine(acc, transform(x)), xs[1:], xs[0])
