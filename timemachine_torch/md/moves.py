"""Monte Carlo move framework (counterpart of the generic moves of
timemachine_tpu/md/moves.py: Move, MonteCarloMove, CompoundMove,
MixtureOfMoves and SequenceOfMoves).

The JAX package draws its Metropolis uniforms and mixture choices from
numpy's global generator; here each move draws from the numpy Generator it
is given, so two moves never share a stream by accident.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Generic, Optional, Sequence, TypeVar

import numpy as np

_State = TypeVar("_State")


class Move(Generic[_State], ABC):
    @abstractmethod
    def move(self, x: _State) -> _State: ...

    def move_n(self, x: _State, n: int) -> _State:
        """n iterated moves."""
        for _ in range(n):
            x = self.move(x)
        return x

    def sample_chain_iter(self, x: _State):
        """Infinite generator over the chain started at x."""
        while True:
            x = self.move(x)
            yield x

    def sample_chain(self, x: _State, n_samples: int) -> list:
        chain = self.sample_chain_iter(x)
        return [next(chain) for _ in range(n_samples)]


class MonteCarloMove(Move[_State], ABC):
    """A Metropolis move: propose, then accept with the proposal's
    probability, drawing the uniform from `rng` (a fresh default_rng()
    when None)."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = np.random.default_rng() if rng is None else rng
        self.n_proposed = 0
        self.n_accepted = 0

    @property
    def acceptance_fraction(self) -> float:
        return self.n_accepted / self.n_proposed if self.n_proposed else np.nan

    @abstractmethod
    def propose(self, x: _State) -> tuple:
        """(proposed state, log acceptance probability)."""

    def move(self, x: _State) -> _State:
        proposal, log_p_accept = self.propose(x)
        # log-space Metropolis: log u < log p  <=>  u < p (u = 0 rejects iff p = 0)
        with np.errstate(divide="ignore"):
            accepted = bool(np.log(self.rng.random()) < log_p_accept)
        self.n_proposed += 1
        self.n_accepted += int(accepted)
        return proposal if accepted else x


class CompoundMove(Move[_State]):
    def __init__(self, moves: Sequence[MonteCarloMove], rng: Optional[np.random.Generator] = None):
        self.moves = moves
        self.rng = np.random.default_rng() if rng is None else rng

    @property
    def n_accepted_by_move(self) -> list:
        return [m.n_accepted for m in self.moves]

    @property
    def n_proposed_by_move(self) -> list:
        return [m.n_proposed for m in self.moves]


class MixtureOfMoves(CompoundMove[_State]):
    """Each step applies one member move drawn uniformly from `rng`."""

    def _drive(self, x: _State, n: int, collect: bool):
        out = []
        for idx in self.rng.choice(len(self.moves), size=n, replace=True):
            x = self.moves[idx].move(x)
            if collect:
                out.append(x)
        return out if collect else x

    def move(self, x: _State) -> _State:
        return self._drive(x, 1, collect=False)

    def move_n(self, x: _State, n: int) -> _State:
        return self._drive(x, n, collect=False)

    def sample_chain(self, x: _State, n_samples: int) -> list:
        return self._drive(x, n_samples, collect=True)


class SequenceOfMoves(CompoundMove[_State]):
    """Each step applies every member move in order."""

    def move(self, x: _State) -> _State:
        for m in self.moves:
            x = m.move(x)
        return x
