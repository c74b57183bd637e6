"""Context: the MD step loop (counterpart of the canonical step of
timemachine_tpu/md/context.py).

`multiple_steps(n_steps, store_x_interval)` advances Langevin BAOAB steps,
or velocity Verlet kick-drift steps between a -1/2 and a +1/2 kick (JAX's
initialize/finalize contract, so each call starts and ends on-step);
movers fire on steps where (t + 1) % interval == 0. Everything stays on the
device: the rebuild and mover schedules read the host's step counter, the
barostat's accept and the list-overflow poison are torch.where on device,
and the one host sync per call is the coordinate/box check at its end.

Potentials with an `md_force_provider` (the nonbonded term) keep list
state that is carried across calls, so how steps are split into calls does
not change the trajectory; set_x_t, set_box and set_params drop it. The
Langevin noise and every mover draw from their own torch.Generator, seeded
from the integrator's and the movers' seeds; reset_for_state reseeds them
from the new state's, so a window run in a reused Context is the same
trajectory as in a fresh one.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from timemachine_torch.device import resolve_device
from timemachine_torch.integrators import LangevinIntegrator, VelocityVerletIntegrator, langevin_step
from timemachine_torch.md.barostat import MonteCarloBarostat


class Context:
    def __init__(
        self,
        x0,
        v0,
        box0,
        integrator: LangevinIntegrator | VelocityVerletIntegrator,
        bps: Sequence,
        movers: Sequence = (),
        device=None,
    ):
        self.device = resolve_device(device)  # None: the card
        self._x = torch.as_tensor(x0, device=self.device)
        dtype = self._x.dtype
        self._v = torch.as_tensor(v0, device=self.device, dtype=dtype)
        self._box = torch.as_tensor(box0, device=self.device, dtype=dtype)
        if self._x.shape != self._v.shape or self._box.shape != (3, 3):
            raise ValueError("x0 and v0 must have one shape and box0 must be (3, 3)")
        self.integrator = integrator
        self.potentials = list(bps)
        self.movers = list(movers)
        self._verlet = isinstance(integrator, VelocityVerletIntegrator)
        ca, cb, cc = integrator.coefficients()
        self._ca = float(ca)
        self._cb = torch.as_tensor(cb, device=self.device, dtype=dtype)
        self._cc = torch.as_tensor(cc, device=self.device, dtype=dtype)
        self._noise = torch.Generator(device=self.device)
        self._noise.manual_seed(getattr(integrator, "seed", 0))
        self._mover_states = [m.init_state(self.device, dtype) for m in self.movers]
        self._step = 0
        self._providers = {}
        for i, pot in enumerate(self.potentials):
            md = getattr(pot, "md_force_provider", None)
            if md is not None:
                self._providers[i] = md()
        self._prov_states = None
        self._move_fns = [self._make_move_fn(m) for m in self.movers]

    def _make_move_fn(self, mover):
        rigid = getattr(mover, "rigid_group_move", False)
        return mover.make_move_fn(lambda x, box: self._mover_energy(x, box, rigid), self.device)

    # -- observers ------------------------------------------------------------

    def get_x_t(self) -> np.ndarray:
        return self._x.cpu().numpy()

    def get_v_t(self) -> np.ndarray:
        return self._v.cpu().numpy()

    def get_box(self) -> np.ndarray:
        return self._box.cpu().numpy()

    def get_mover_states(self) -> list:
        return list(self._mover_states)

    def get_params(self) -> list:
        return [pot.params.cpu().numpy() for pot in self.potentials]

    def get_barostat(self):
        """(barostat, its state), or None without a barostat."""
        for m, st in zip(self.movers, self._mover_states):
            if isinstance(m, MonteCarloBarostat):
                return m, st
        return None

    def set_x_t(self, x):
        self._x = torch.as_tensor(x, device=self.device, dtype=self._x.dtype)
        self._prov_states = None

    def set_v_t(self, v):
        self._v = torch.as_tensor(v, device=self.device, dtype=self._x.dtype)

    def set_box(self, box):
        self._box = torch.as_tensor(box, device=self.device, dtype=self._x.dtype)
        self._prov_states = None

    def set_params(self, params_list):
        """Replace every potential's parameters (copied into its buffer)."""
        if len(params_list) != len(self.potentials):
            raise ValueError("one parameter array per potential")
        for pot, p in zip(self.potentials, params_list):
            pot.params.copy_(torch.as_tensor(p))
        self._prov_states = None

    def reset_for_state(self, initial_state):
        """Point this Context at another compatible InitialState: swap x, v,
        box and every parameter, restart the step count, reseed the noise
        from the state's integrator seed, and rebuild every mover's state,
        the barostat's generator from the state's own barostat seed. The run
        that follows is the one a fresh Context of the state would take."""
        self.set_x_t(initial_state.x0)
        self.set_v_t(initial_state.v0)
        self.set_box(initial_state.box0)
        self.set_params([pot.params for pot in initial_state.potentials])
        self._step = 0
        self._noise.manual_seed(getattr(initial_state.integrator, "seed", 0))
        for i, m in enumerate(self.movers):
            if isinstance(m, MonteCarloBarostat) and initial_state.barostat is not None:
                self.movers[i] = replace(m, seed=initial_state.barostat.seed)
        self._mover_states = [m.init_state(self.device, self._x.dtype) for m in self.movers]
        return self

    def set_barostat_interval(self, interval: int) -> Optional[int]:
        """Fire the barostat every `interval` steps from now on, keeping its
        state and generator; returns the previous interval, or None without
        a barostat."""
        for i, m in enumerate(self.movers):
            if isinstance(m, MonteCarloBarostat):
                if m.interval != interval:
                    self.movers[i] = replace(m, interval=interval)
                    self._move_fns[i] = self._make_move_fn(self.movers[i])
                return m.interval
        return None

    def compute_u_t(self) -> float:
        """The total energy at the current state: the sum of every
        potential's u(x, params, box)."""
        with torch.no_grad():
            return float(sum(pot.u(self._x, pot.params, self._box) for pot in self.potentials))

    # -- stepping -------------------------------------------------------------

    def _mover_energy(self, x, box, rigid: bool):
        """Total energy with the providers reusing their lists (valid within
        skin/2 of the build). A rigid mover skips rigid-invariant terms and
        takes the providers' rigid energy."""
        total = x.new_zeros(())
        for i, pot in enumerate(self.potentials):
            if rigid and getattr(pot, "rigid_group_invariant", False):
                continue
            if i in self._providers:
                total = total + self._providers[i][3 if rigid else 2](self._prov_states[i], x, box)
            else:
                total = total + pot.energy(x, box)
        return total

    def _one_step(self, noise=None):
        """One step; the Langevin noise from the Context's generator unless given."""
        t = self._step
        x, box = self._x, self._box
        force = torch.zeros_like(x)
        for i, pot in enumerate(self.potentials):
            if i in self._providers:
                f, self._prov_states[i] = self._providers[i][1](self._prov_states[i], x, box, t)
            else:
                f = pot.energy_force(x, box)[1]
            force = force + f
        if self._verlet:
            self._v = self._v + self._cb * force
            self._x = x + self.integrator.dt * self._v
        else:
            if noise is None:
                noise = torch.randn(x.shape, generator=self._noise, device=self.device, dtype=x.dtype)
            self._x, self._v = langevin_step(
                x, self._v, force, noise, self._ca, self._cb, self._cc, self.integrator.dt
            )
        for k, (mover, move) in enumerate(zip(self.movers, self._move_fns)):
            if (t + 1) % mover.interval == 0:
                self._mover_states[k], self._x, self._v, self._box = move(
                    self._mover_states[k], self._x, self._v, self._box
                )
        self._step = t + 1

    def multiple_steps(self, n_steps: int, store_x_interval: int = 0):
        """Advance n_steps; return (frames, boxes) as numpy, one frame every
        store_x_interval steps (0: the final frame only)."""
        interval = store_x_interval if store_x_interval > 0 else max(n_steps, 1)
        n_frames = n_steps // interval
        frames, boxes = [], []
        with torch.no_grad():
            if self._prov_states is None:
                self._prov_states = {i: prov[0](self._x, self._box) for i, prov in self._providers.items()}
            if self._verlet:
                self._half_kick(-0.5)
            for s in range(1, n_steps + 1):
                self._one_step()
                if s % interval == 0 and len(frames) < n_frames:
                    frames.append(self._x)  # steps rebind x and box, never write them in place
                    boxes.append(self._box)
            if self._verlet:
                self._half_kick(0.5)
        self._validate_state()
        if not frames:
            return np.zeros((0, *self._x.shape)), np.zeros((0, 3, 3))
        return torch.stack(frames).cpu().numpy(), torch.stack(boxes).cpu().numpy()

    def _half_kick(self, sign: float):
        """v += sign dt/m F(x): the Verlet path's entry and exit kicks."""
        force = sum(pot.energy_force(self._x, self._box)[1] for pot in self.potentials)
        self._v = self._v + sign * self._cb * force

    def step(self):
        """One step, stored nowhere."""
        self.multiple_steps(1)

    def _validate_state(self):
        """Coordinate and box checks, one host sync."""
        x_finite, max_coord, *box_diag = torch.stack(
            [torch.isfinite(self._x).all().to(self._x.dtype), self._x.abs().max(), *torch.diagonal(self._box)]
        ).tolist()
        if not x_finite:
            raise RuntimeError("Context: coordinates are not finite (simulation blew up)")
        if max_coord > 1e5:
            raise RuntimeError(f"Context: coordinates exploded (|x|max = {max_coord})")
        cutoffs = [p.cutoff for p in self.potentials if getattr(p, "cutoff", None) is not None]
        if cutoffs and min(box_diag) < 2 * max(cutoffs):
            raise RuntimeError(f"Context: box {box_diag} smaller than twice the nonbonded cutoff {max(cutoffs)}")


class BatchedContext:
    """K replicas of one Context's system, stepped together over a leading
    replica axis: the counterpart of the JAX Context's step under jax.vmap
    in timemachine_tpu/parallel/replica_exchange.py.

    x, v (K, N, 3), box (K, 3, 3) and every term's parameters (K, ...) are
    stacked. A step evaluates each term for all K at once: the terms with a
    batched MD provider (the RBFE host term: on the card one
    rowscan_sweep_batched launch, its exclusions vmapped; on the CPU the
    dense form under vmap) through it, every other term's closed
    form `u_force` under torch.func.vmap. Langevin BAOAB broadcasts over the
    batch with one (K, N, 3) noise draw a step from one torch.Generator; the
    barostat moves every replica at once, with (K,) volumes, widths and
    counters and (K, 2) uniforms from its own generator. A step that does
    not rebuild the lists runs the same launches whatever K.

    Langevin only (HREX's integrator). set_params drops the providers'
    lists, which the next step rebuilds from the new parameters.
    """

    def __init__(self, context: Context, xs, vs, boxes, params, seed: int):
        if context._verlet:
            raise NotImplementedError("BatchedContext steps Langevin BAOAB only")
        self.device = context.device
        dtype = context._x.dtype
        self.potentials = context.potentials
        self.integrator = context.integrator
        self.movers = list(context.movers)
        self._ca, self._cb, self._cc = context._ca, context._cb, context._cc
        self._x = torch.as_tensor(xs, device=self.device, dtype=dtype)
        self._v = torch.as_tensor(vs, device=self.device, dtype=dtype)
        self._box = torch.as_tensor(boxes, device=self.device, dtype=dtype)
        k = self._x.shape[0]
        if self._x.shape != self._v.shape or self._box.shape != (k, 3, 3):
            raise ValueError("xs and vs must be (K, N, 3) and boxes (K, 3, 3)")
        self._noise = torch.Generator(device=self.device)
        self._noise.manual_seed(seed)
        self._mover_states = [m.init_state(self.device, dtype, shape=(k,)) for m in self.movers]
        self._move_fns = [self._make_move_fn(m) for m in self.movers]
        self._providers = {}
        self._u_force, self._u = {}, {}
        for i, pot in enumerate(self.potentials):
            batched = getattr(pot, "md_force_provider_batched", None)
            if batched is not None:
                self._providers[i] = batched()
            else:
                self._u_force[i] = torch.func.vmap(pot.u_force)
                self._u[i] = torch.func.vmap(pot.u)
        self._prov_states = None
        self._step = 0
        self.set_params(params)

    # the same code over (K, ...) tensors: a barostat's energy is _mover_energy's (K,) energies
    _make_move_fn = Context._make_move_fn
    set_barostat_interval = Context.set_barostat_interval
    get_x_t, get_v_t, get_box, get_mover_states = Context.get_x_t, Context.get_v_t, Context.get_box, Context.get_mover_states

    def set_params(self, params):
        """Every term's parameters, one (K, ...) tensor a term."""
        if len(params) != len(self.potentials):
            raise ValueError("one parameter tensor per potential")
        self._params = [torch.as_tensor(p, device=self.device, dtype=pot.params.dtype) for p, pot in zip(params, self.potentials)]
        self._prov_states = None

    def _ensure_lists(self):
        if self._prov_states is None:
            self._prov_states = {i: prov[0](self._x, self._params[i], self._box) for i, prov in self._providers.items()}

    def _mover_energy(self, xs, boxes, rigid: bool):
        """(K,) energies with the providers reusing their lists; a rigid
        mover skips rigid-invariant terms and takes the providers' rigid
        energy, as Context._mover_energy."""
        total = xs.new_zeros(xs.shape[0])
        for i, pot in enumerate(self.potentials):
            if rigid and getattr(pot, "rigid_group_invariant", False):
                continue
            if i in self._providers:
                total = total + self._providers[i][3 if rigid else 2](self._prov_states[i], xs, self._params[i], boxes)
            else:
                total = total + self._u[i](xs, self._params[i], boxes)
        return total

    def energies_with_params(self, params_sets):
        """(K, S) float64 energy of each replica's coordinates under S
        parameter sets of its own, params_sets one (K, S, ...) tensor a term:
        the providers through their current lists (one U launch of K * S
        systems), the other terms' u in float64 under two nested vmaps. The
        swaps read differences of these energies of a few kT, which float32
        sums of the host term's all-pairs energy (its exclusions cancel it
        to a far smaller net) would round away."""
        self._ensure_lists()
        f64 = torch.float64
        x64, box64 = self._x.to(f64), self._box.to(f64)
        with torch.no_grad():
            total = 0.0
            for i, ps in enumerate(params_sets):
                if i in self._providers:
                    u = self._providers[i][4](self._prov_states[i], self._x, ps, self._box)
                else:
                    u = torch.func.vmap(torch.func.vmap(self.potentials[i].u, in_dims=(None, 0, None)))(x64, ps.to(f64), box64)
                total = total + u
        return total

    def _one_step(self, noise=None):
        """One step of every replica; the (K, N, 3) noise from the generator unless given."""
        t = self._step
        x, box = self._x, self._box
        force = torch.zeros_like(x)
        for i in range(len(self.potentials)):
            if i in self._providers:
                f, self._prov_states[i] = self._providers[i][1](self._prov_states[i], x, self._params[i], box, t)
            else:
                f = self._u_force[i](x, self._params[i], box)[1]
            force = force + f
        if noise is None:
            noise = torch.randn(x.shape, generator=self._noise, device=self.device, dtype=x.dtype)
        self._x, self._v = langevin_step(x, self._v, force, noise, self._ca, self._cb, self._cc, self.integrator.dt)
        for k, (mover, move) in enumerate(zip(self.movers, self._move_fns)):
            if (t + 1) % mover.interval == 0:
                self._mover_states[k], self._x, self._v, self._box = move(
                    self._mover_states[k], self._x, self._v, self._box
                )
        self._step = t + 1

    def multiple_steps(self, n_steps: int):
        """Advance every replica n_steps; one host sync, at the end."""
        with torch.no_grad():
            self._ensure_lists()
            for _ in range(n_steps):
                self._one_step()
        self._validate_state()

    def _validate_state(self):
        """Coordinate and box checks over every replica, one host sync."""
        x_finite, max_coord, min_box = torch.stack([
            torch.isfinite(self._x).all().to(self._x.dtype), self._x.abs().max(),
            torch.diagonal(self._box, dim1=-2, dim2=-1).min(),
        ]).tolist()
        if not x_finite:
            raise RuntimeError("BatchedContext: coordinates are not finite (simulation blew up)")
        if max_coord > 1e5:
            raise RuntimeError(f"BatchedContext: coordinates exploded (|x|max = {max_coord})")
        cutoffs = [p.cutoff for p in self.potentials if getattr(p, "cutoff", None) is not None]
        if cutoffs and min_box < 2 * max(cutoffs):
            raise RuntimeError(f"BatchedContext: a box side {min_box} is smaller than twice the nonbonded cutoff {max(cutoffs)}")
