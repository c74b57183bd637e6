"""Monte Carlo move framework (the port of timemachine_tpu/md/moves.py):
Move, MonteCarloMove, CompoundMove, MixtureOfMoves and SequenceOfMoves, the
MD moves NVTMove and NPTMove, and the multiple-try Metropolis moves.

The JAX package draws its Metropolis uniforms and mixture choices from
numpy's global generator; here each move draws from the numpy Generator it
is given, so two moves never share a stream by accident. Its MTM moves
draw from jax.random keys; here from a numpy Generator seeded with the same
seed (ROADMAP P26).

An MD move keeps one Context over its own copies of the potentials (the
port's modules) for every move, so nothing is rebuilt or recompiled when a
state or a parameter set is swapped in. Its all-pairs term takes the form
of a Context that no configure_pallas touched (potentials.all_pairs_kernel,
site "fresh": dense on the CPU or below 4,096 atoms, nb_tiles' exact form on
the card from there up). The step counter carries across moves, so the
lists' rebuild schedule and the barostat's interval keep their phase; each
move sets x, v and box, which drops the lists, so they are rebuilt for the
state moved.
"""

from __future__ import annotations

import copy
from abc import ABC, abstractmethod
from typing import Generic, Optional, Sequence, TypeVar

import numpy as np
import torch
from scipy.special import logsumexp

from timemachine_torch.integrators import LangevinIntegrator
from timemachine_torch.md.states import CoordsVelBox

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


class NVTMove(Move[CoordsVelBox]):
    """n_steps Langevin steps at constant temperature as one Move, on copies
    of the modules `bps` (on their device, in their dtype)."""

    def __init__(self, bps, masses, temperature: float, n_steps: int, seed: int, dt: float = 1.5e-3, friction: float = 1.0):
        self.bps = [copy.deepcopy(bp) for bp in bps]
        self.masses = masses
        self.temperature = temperature
        self.n_steps = n_steps
        self.seed = seed
        self.integrator = LangevinIntegrator(temperature, dt, friction, np.asarray(masses), seed)
        self._movers: list = []
        self._step_offset = 0
        self._ctxt = None

    def _context(self, x: CoordsVelBox):
        """The move's one Context, built at the first state moved."""
        from timemachine_torch.md.context import Context
        from timemachine_torch.md.minimizer import configure_nonbonded

        if self._ctxt is None:
            params = self.bps[0].params
            x0 = torch.as_tensor(np.asarray(x.coords), device=params.device, dtype=params.dtype)
            box0 = torch.as_tensor(np.asarray(x.box), device=params.device, dtype=params.dtype)
            configure_nonbonded(self.bps, x0, box0, site="fresh")
            self._ctxt = Context(x0, x.velocities, x.box, self.integrator, self.bps, movers=self._movers,
                                 device=params.device)
        return self._ctxt

    def _run(self, x: CoordsVelBox, n_steps: int) -> CoordsVelBox:
        ctxt = self._context(x)
        ctxt.set_x_t(x.coords)
        ctxt.set_v_t(x.velocities)
        ctxt.set_box(x.box)
        ctxt._step = self._step_offset
        ctxt.multiple_steps(n_steps)
        self._step_offset = ctxt._step
        return CoordsVelBox(ctxt.get_x_t(), ctxt.get_v_t(), ctxt.get_box())

    def set_params(self, params_list):
        """Swap in another parameter set (another λ window), one array per
        potential, without rebuilding the Context."""
        if self._ctxt is not None:
            self._ctxt.set_params(params_list)
        else:
            for bp, p in zip(self.bps, params_list):
                bp.params.copy_(torch.as_tensor(p))

    def move(self, x: CoordsVelBox) -> CoordsVelBox:
        return self._run(x, self.n_steps)


class NPTMove(NVTMove):
    """NVTMove with a Monte Carlo barostat over the bond graph's molecules,
    every barostat_interval steps, seeded with seed + 1."""

    def __init__(
        self,
        bps,
        masses,
        temperature: float,
        pressure: float,
        n_steps: int,
        seed: int,
        dt: float = 1.5e-3,
        friction: float = 1.0,
        barostat_interval: int = 5,
    ):
        super().__init__(bps, masses, temperature, n_steps, seed, dt=dt, friction=friction)
        from timemachine_torch.md.barostat import MonteCarloBarostat
        from timemachine_torch.md.utils import get_group_indices
        from timemachine_torch.potentials import HarmonicBond

        bond = next(bp for bp in self.bps if isinstance(bp, HarmonicBond))
        bond_list = [(int(i), int(j)) for i, j in bond.idxs.cpu().numpy()]
        group_idxs = get_group_indices(bond_list, len(masses))
        self._movers = [
            MonteCarloBarostat(len(masses), pressure, temperature, group_idxs, barostat_interval, seed + 1)
        ]


# -- multiple-try Metropolis ------------------------------------------------------------------


def _categorical(rng, log_w) -> int:
    """One index drawn with probability ∝ exp(log_w)."""
    p = np.exp(log_w - logsumexp(log_w))
    return int(rng.choice(len(p), p=p / p.sum()))


def _mtm_accept(rng, x, K, propose_batch, log_weight_fn):
    """One MTM round (Liang & Wong 2000): draw K proposals from x, select one
    by its weight, then rebuild the reverse ensemble around the selection
    with x swapped in. Returns (y, p_accept). propose_batch(x, K, rng) draws
    from `rng`, as the selection does.

    log_weight_fn(states, ref_state) -> (K,) log selection weights; for a
    symmetric proposal this is log pi alone."""
    ys = propose_batch(x, K, rng)
    log_w_fwd = np.asarray(log_weight_fn(ys, x), dtype=np.float64)
    y = ys[_categorical(rng, log_w_fwd)]

    xs = np.concatenate([np.asarray(propose_batch(y, K, rng))[: K - 1], np.asarray(x)[None]], axis=0)
    log_w_rev = np.asarray(log_weight_fn(xs, y), dtype=np.float64)

    log_ratio = logsumexp(log_w_fwd) - logsumexp(log_w_rev)
    return y, float(np.exp(min(log_ratio, 0.0)))


class DeterministicMTMMove(Move[CoordsVelBox]):
    """MTM base drawing every proposal, selection and uniform from one numpy
    Generator (JAX's draws from a jax.random key)."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.n_proposed = 0
        self.n_accepted = 0

    @property
    def acceptance_fraction(self) -> float:
        return self.n_accepted / self.n_proposed if self.n_proposed else np.nan

    def acceptance_probability(self, x, box, rng) -> tuple:
        """(selected proposal, acceptance probability)."""
        raise NotImplementedError

    def move(self, xvb: CoordsVelBox) -> CoordsVelBox:
        y, p_accept = self.acceptance_probability(xvb.coords, xvb.box, self.rng)
        accepted = bool(self.rng.random() < p_accept)
        self.n_proposed += 1
        self.n_accepted += int(accepted)
        if accepted:
            return CoordsVelBox(np.asarray(y), xvb.velocities, xvb.box)
        return xvb


class OptimizedMTMMove(DeterministicMTMMove):
    """MTM with a symmetric proposal Q and importance weights pi / Q, so the
    proposals are selected by log pi alone."""

    def __init__(self, K, batch_proposal_fn, batched_log_weights_fn, seed):
        super().__init__(np.random.default_rng(seed))
        self.K = K
        self.batch_proposal_fn = batch_proposal_fn
        self.batched_log_weights_fn = batched_log_weights_fn

    def acceptance_probability(self, x, box, rng):
        return _mtm_accept(rng, x, self.K, self.batch_proposal_fn, lambda states, _ref: self.batched_log_weights_fn(states, box))


class ReferenceMTMMove(DeterministicMTMMove):
    """General MTM with a proposal density Q and a symmetric importance
    function lambda; OptimizedMTMMove is its symmetric-Q special case.

    batch_proposal_fn: (state, K, rng) -> K proposed states
    batch_log_Q_fn: (states, ref_state) -> (K,) log proposal densities
    batch_log_pi_fn: (states) -> (K,) log target densities
    batch_log_lambda_a_b_fn: (states, ref_state) -> (K,) symmetric log lambda
    """

    def __init__(self, K, batch_proposal_fn, batch_log_Q_fn, batch_log_pi_fn, batch_log_lambda_a_b_fn, seed):
        super().__init__(np.random.default_rng(seed))
        self.K = K
        self.batch_proposal_fn = batch_proposal_fn
        self.batch_log_Q_fn = batch_log_Q_fn
        self.batch_log_pi_fn = batch_log_pi_fn
        self.batch_log_lambda_fn = batch_log_lambda_a_b_fn

    def _log_weights(self, states, ref):
        return (
            np.asarray(self.batch_log_pi_fn(states))
            + np.asarray(self.batch_log_Q_fn(states, ref))
            + np.asarray(self.batch_log_lambda_fn(states, ref))
        )

    def acceptance_probability(self, x, box, rng):
        return _mtm_accept(rng, x, self.K, self.batch_proposal_fn, self._log_weights)
