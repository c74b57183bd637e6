"""Context: the MD step loop (counterpart of the canonical step of
timemachine_tpu/md/context.py).

`multiple_steps(n_steps, store_x_interval)` advances Langevin BAOAB steps,
or velocity Verlet kick-drift steps between a -1/2 and a +1/2 kick (JAX's
initialize/finalize contract, so each call starts and ends on-step);
movers fire on steps where (t + 1) % interval == 0. Everything stays on the
device: the rebuild and mover schedules read the host's step counter, the
barostat's accept and the list-overflow poison are torch.where on device,
and the one host sync per call is the coordinate/box check at its end.

The step splits its potentials into JAX's four tiers once, when the
Context is made: the stateful providers (the nonbonded term's
`md_force_provider`, or its `md_force_provider_split`), one shared
contribution plan for every irregular term list (the bonded terms' tails
past the leading waters and the exclusion tail, `force_contribs`, summed per
atom once by ops/assembly.py), the closed-form terms (`energy_force_fn`),
and the rest, each by its closed-form energy_force (JAX's grad tier). A
step's force is the providers' force plus `residual_force(x, box)`.

Langevin steps take JAX's sorted-state path where JAX's conditions hold (no
Verlet, one stateful provider, no mover that moves atoms nonlocally, and a
provider with a sorted protocol: the rowscan sweep) and the module constant
SORTED_MD is True when the Context is made: x, v and the per-atom
integrator rows are carried in the provider's pad order, the sweep runs on
them with no gather, and the rest of the force (the provider's canonical
force, then `residual_force`) is computed at the un-sorted coordinates and
gathered to pad order. A rebuild and a mover un-sort the carry, act and
re-sort it; frames and the state left at the end are un-sorted. The sorted
step is bitwise the canonical one: the same operands meet in the same
order, the noise is drawn in canonical shape and gathered, and the wrap
commutes with the gather (ROADMAP P39). Local MD and the Verlet path keep
the canonical step.

Providers keep list state that is carried across calls, so how steps are
split into calls does not change the trajectory; set_x_t, set_box and
set_params drop it. The
Langevin noise and every mover draw from their own torch.Generator, seeded
from the integrator's and the movers' seeds; reset_for_state reseeds them
from the new state's, so a window run in a reused Context is the same
trajectory as in a fresh one. A mover that moves atoms nonlocally (the
water sampler, md/exchange/) is followed by a rebuild of every provider's
lists, as in JAX's step.

Local MD (`multiple_steps_local`, `multiple_steps_local_selection`) moves
only a selection of atoms around a reference atom: each step takes the full
force through the same providers (on the card the host term's masked rowscan
launch), adds a flat-bottom restraint of the free atoms to the reference
(and, when the reference moves too, a log-complement restraint that tethers
the frozen shell to it), and masks the Langevin update so that frozen atoms
keep x and v bitwise. The restraint is O(N) and evaluated in float64, its
force added in the working dtype. Movers do not fire, the step count
advances, and the providers' lists are dropped afterwards.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ
from timemachine_torch.device import resolve_device
from timemachine_torch.integrators import LangevinIntegrator, VelocityVerletIntegrator, langevin_step
from timemachine_torch.md.barostat import MonteCarloBarostat
from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove
from timemachine_torch.ops.assembly import assemble_forces, build_contrib_plan
from timemachine_torch.ops.pbc import periodic_delta

# Whether a Context takes the sorted-state step where JAX's conditions hold
# (JAX's TM_SORTED_MD, default on); read when a Context is made.
SORTED_MD = True


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
        self._prov_states = None
        self._build_step()
        self._move_fns = [self._make_move_fn(m) for m in self.movers]
        self._local_md_temperature = None

    def _build_step(self):
        """Split the potentials into JAX's four tiers (md/context.py
        _make_step_fn), build the one contribution plan, and decide the
        sorted-state step under JAX's conditions."""
        self._providers = {}
        self._contrib_entries, self._fused, self._grad = [], [], []
        groups = []
        for i, pot in enumerate(self.potentials):
            split_m = getattr(pot, "md_force_provider_split", None)
            split = split_m() if split_m is not None else None
            if split is not None:
                self._providers[i], pot_groups, fn = split
                groups.extend(pot_groups)
                self._contrib_entries.append((i, fn))
                continue
            md = getattr(pot, "md_force_provider", None)
            if md is not None:
                self._providers[i] = md()
                continue
            fc_m = getattr(pot, "force_contribs", None)
            fc = fc_m() if fc_m is not None else None
            if fc is not None:
                pot_groups, fn = fc
                groups.extend(pot_groups)
                self._contrib_entries.append((i, fn))
                continue
            ef_m = getattr(pot, "energy_force_fn", None)
            ef = ef_m() if ef_m is not None else None
            if ef is not None:
                self._fused.append((i, ef))
            else:
                self._grad.append(i)
        self._plan = build_contrib_plan(groups, self._x.shape[0], self.device) if groups else None
        self._sorted_info = self._tail = None
        if (
            SORTED_MD
            and not self._verlet
            and len(self._providers) == 1
            and not any(getattr(m, "moves_atoms_nonlocally", False) for m in self.movers)
        ):
            (i,) = self._providers
            sorted_m = getattr(self.potentials[i], "md_force_provider_sorted", None)
            info = sorted_m() if sorted_m is not None else None
            if info is not None:
                self._sorted_info = (i, info)

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

    def reset_for_state(self, initial_state, seed: Optional[int] = None):
        """Point this Context at another compatible InitialState: swap x, v,
        box and every parameter, restart the step count, reseed the noise
        from the state's integrator seed, and rebuild every mover's state,
        the barostat's generator from the state's own barostat seed, the
        water sampler's from the seed get_context derives from the state's
        integrator seed. The run that follows is the one a fresh Context of
        the state would take, but for the water sampler's parameters, which
        restart from the mover's own, as JAX's do (ROADMAP R11).

        With `seed`, all three streams are reseeded from it as a state built
        with integrator seed `seed` seeds them (ROADMAP P38): the noise from
        seed, the barostat from seed + 1, the water sampler from
        water_sampler_seed(seed)."""
        self.set_x_t(initial_state.x0)
        self.set_v_t(initial_state.v0)
        self.set_box(initial_state.box0)
        self.set_params([pot.params for pot in initial_state.potentials])
        self._step = 0
        integrator_seed = getattr(initial_state.integrator, "seed", 0) if seed is None else seed
        self._noise.manual_seed(integrator_seed)
        for i, m in enumerate(self.movers):
            if isinstance(m, MonteCarloBarostat) and seed is not None:
                self.movers[i] = replace(m, seed=seed + 1)
            elif isinstance(m, MonteCarloBarostat) and initial_state.barostat is not None:
                self.movers[i] = replace(m, seed=initial_state.barostat.seed)
            elif isinstance(m, TIBDExchangeMove):
                self.movers[i] = m.reseeded(integrator_seed)
        self._mover_states = [m.init_state(self.device, self._x.dtype) for m in self.movers]
        return self

    def set_water_sampler_params(self, params):
        """The water sampler's nonbonded parameters from now on, in its
        state ((N, 4), or (K, N, 4) in a BatchedContext); its counters and
        generator go on."""
        for i, m in enumerate(self.movers):
            if isinstance(m, TIBDExchangeMove):
                st = self._mover_states[i]
                self._mover_states[i] = replace(st, params=torch.as_tensor(params, device=self.device, dtype=st.params.dtype))

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

    def residual_force(self, x, box):
        """The force of everything but the stateful providers, in JAX's
        order: the grad tier's terms (each by its closed form), the
        closed-form tier, then the strided water forces of the plan's
        entries and the one plan's assembly of every contribution."""
        force = torch.zeros_like(x)
        for i in self._grad:
            force = force + self.potentials[i].energy_force(x, box)[1]
        for i, ef in self._fused:
            force = force + ef(x, self.potentials[i].params, box)[1]
        if self._plan is not None:
            contribs = []
            for i, fn in self._contrib_entries:
                cs, extra = fn(x, self.potentials[i].params, box)
                contribs.extend(cs)
                if extra is not None:
                    force = force + extra
            force = force + assemble_forces(self._plan, contribs)
        return force

    def _force(self, x, box, t: int):
        """The total force at x, the providers at step t: the residual, then
        each provider's force."""
        force = self.residual_force(x, box)
        for i, prov in self._providers.items():
            f, self._prov_states[i] = prov[1](self._prov_states[i], x, box, t)
            force = force + f
        return force

    def _one_step(self, noise=None):
        """One step; the Langevin noise from the Context's generator unless given."""
        t = self._step
        x, box = self._x, self._box
        force = self._force(x, box, t)
        if self._verlet:
            self._v = self._v + self._cb * force
            self._x = x + self.integrator.dt * self._v
        else:
            if noise is None:
                noise = torch.randn(x.shape, generator=self._noise, device=self.device, dtype=x.dtype)
            self._x, self._v = langevin_step(
                x, self._v, force, noise, self._ca, self._cb, self._cc, self.integrator.dt
            )
        self._fire_movers(t)
        self._step = t + 1

    def _fire_movers(self, t: int):
        """Each mover due after step t, in order (the barostat, then the
        water sampler); after one that moves atoms nonlocally every
        provider's lists are rebuilt from the moved coordinates, as JAX's
        step does, since a teleported water's new pairs are in no list."""
        for k, (mover, move) in enumerate(zip(self.movers, self._move_fns)):
            if (t + 1) % mover.interval == 0:
                self._mover_states[k], self._x, self._v, self._box = move(
                    self._mover_states[k], self._x, self._v, self._box
                )
                if getattr(mover, "moves_atoms_nonlocally", False) and self._providers:
                    self._prov_states = None
                    self._ensure_lists()

    def _ensure_lists(self):
        if self._prov_states is None:
            self._prov_states = {i: prov[0](self._x, self._box) for i, prov in self._providers.items()}

    def multiple_steps(self, n_steps: int, store_x_interval: int = 0):
        """Advance n_steps; return (frames, boxes) as numpy, one frame every
        store_x_interval steps (0: the final frame only)."""
        interval = store_x_interval if store_x_interval > 0 else max(n_steps, 1)
        n_frames = n_steps // interval
        frames, boxes = [], []
        with torch.no_grad():
            self._ensure_lists()
            if self._sorted_info is not None:
                self._run_sorted(n_steps, interval, n_frames, frames, boxes)
            else:
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

    # -- the sorted-state step ---------------------------------------------------

    def _pad_tail(self, n_pad: int):
        """(Npad, 1) bool, True at the pad slots (the last Npad - N), made once."""
        if self._tail is None or self._tail.shape[0] != n_pad:
            self._tail = (torch.arange(n_pad, device=self.device) >= self._x.shape[0])[:, None]
        return self._tail

    def _to_sorted(self, x, v, state):
        """(x_s, v_s, cb_s, cc_s): canonical x, v and the per-atom integrator
        rows in the state's pad order, the pad slots' v, cb and cc zero so
        that they never move."""
        _, info = self._sorted_info
        po = info.pad_order(state)
        tail = self._pad_tail(po.shape[0])
        return (
            x[po], torch.where(tail, 0.0, v[po]), torch.where(tail, 0.0, self._cb[po]),
            torch.where(tail, 0.0, self._cc[po]),
        )

    def _sorted_step(self, carry):
        """One Langevin step on the sorted carry (x_s, v_s, cb_s, cc_s);
        returns the next carry. The lists are rebuilt at t %
        rebuild_interval == 0 from the un-sorted coordinates, and the carry
        re-sorted; the pad slots track atom 0 every step, as the canonical
        sweep's rows do; the force is the sweep's plus the provider's
        canonical force and the residual, both gathered to pad order; the
        noise is drawn in canonical shape from the Context's generator and
        gathered; each mover due runs on the un-sorted state."""
        x_s, v_s, cb_s, cc_s = carry
        t, box = self._step, self._box
        i, info = self._sorted_info
        state = self._prov_states[i]
        if t % info.rebuild_interval == 0:
            inv = info.inv(state)
            x_c, v_c = x_s[inv], v_s[inv]
            state = self._prov_states[i] = self._providers[i][0](x_c, box)
            x_s, v_s, cb_s, cc_s = self._to_sorted(x_c, v_c, state)
        po, inv = info.pad_order(state), info.inv(state)
        tail = self._pad_tail(po.shape[0])
        x_s = torch.where(tail, x_s[inv[:1]], x_s)
        f_s = -info.sweep(state, x_s, box)[:, 1:4]
        x_c = x_s[inv]
        if info.canonical_force is not None:
            f_s = f_s + info.canonical_force(x_c, self.potentials[i].params, box)[po]
        f_s = torch.where(tail, 0.0, f_s + self.residual_force(x_c, box)[po])
        noise = torch.randn(x_c.shape, generator=self._noise, device=self.device, dtype=x_c.dtype)
        x_s, v_s = langevin_step(x_s, v_s, f_s, noise[po], self._ca, cb_s, cc_s, self.integrator.dt)
        for k, (mover, move) in enumerate(zip(self.movers, self._move_fns)):
            if (t + 1) % mover.interval == 0:
                self._mover_states[k], x_c, v_c, self._box = move(self._mover_states[k], x_s[inv], v_s[inv], self._box)
                x_s, v_s = x_c[po], torch.where(tail, 0.0, v_c[po])
        self._step = t + 1
        return x_s, v_s, cb_s, cc_s

    def _run_sorted(self, n_steps: int, interval: int, n_frames: int, frames: list, boxes: list):
        """n_steps sorted steps from the canonical state, frames un-sorted
        into `frames` and `boxes`, the canonical state set at the end."""
        i, info = self._sorted_info
        carry = self._to_sorted(self._x, self._v, self._prov_states[i])
        for s in range(1, n_steps + 1):
            carry = self._sorted_step(carry)
            if s % interval == 0 and len(frames) < n_frames:
                frames.append(carry[0][info.inv(self._prov_states[i])])
                boxes.append(self._box)
        inv = info.inv(self._prov_states[i])
        self._x, self._v = carry[0][inv], carry[1][inv]

    def _half_kick(self, sign: float):
        """v += sign dt/m F(x): the Verlet path's entry and exit kicks."""
        force = sum(pot.energy_force(self._x, self._box)[1] for pot in self.potentials)
        self._v = self._v + sign * self._cb * force

    def step(self):
        """One step, stored nowhere."""
        self.multiple_steps(1)

    # -- local MD ---------------------------------------------------------------

    def setup_local_md(self, temperature: Optional[float] = None, freeze_reference: bool = True):
        """Local MD's settings: `temperature` sets the restraints' kT (None:
        the integrator's). Nothing is built ahead: the selection is an input
        of each local segment, and so is freeze_reference, which this takes
        for the JAX package's signature only."""
        self._local_md_temperature = temperature

    def multiple_steps_local(
        self,
        n_steps: int,
        local_idxs,
        k: float = 10_000.0,
        radius: float = 1.0,
        seed: int = 0,
        store_x_interval: int = 0,
        temperature: Optional[float] = None,
        freeze_reference: bool = True,
    ):
        """Advance n_steps moving only a region selected at random around a
        reference atom drawn from local_idxs: atom i is free with probability
        exp(-U_fb(d_i) / kT), U_fb = k/4 max(d_i - radius, 0)^4, d_i its
        minimum-image distance from the reference at the segment's start.
        The draws come from numpy's default_rng(seed), the reference first
        (`integers`), then one uniform an atom (`random`), and the distances
        from a float64 copy of x, so the selection is the JAX package's for
        the same x and seed. The reference is frozen with freeze_reference,
        else free. Returns (frames, boxes) as multiple_steps."""
        reference_idx, free = self.local_selection(local_idxs, k, radius, seed, temperature, freeze_reference)
        return self._run_local(n_steps, reference_idx, free, k, radius, store_x_interval, freeze_reference)

    def local_selection(self, local_idxs, k: float, radius: float, seed: int, temperature=None, freeze_reference=True):
        """(reference index, free mask (N,) bool) of multiple_steps_local."""
        assert len(local_idxs) > 0
        n_atoms = self._x.shape[0]
        temperature = temperature if temperature is not None else getattr(self.integrator, "temperature", 300.0)
        kBT = BOLTZ * temperature
        rng = np.random.default_rng(seed)
        reference_idx = int(np.asarray(local_idxs)[rng.integers(len(local_idxs))])
        x = self._x.cpu().numpy().astype(np.float64)
        diff = x - x[reference_idx]
        box_diag = np.diagonal(self._box.cpu().numpy().astype(np.float64))
        diff -= box_diag * np.floor(diff / box_diag + 0.5)
        d = np.linalg.norm(diff, axis=1)
        over = np.maximum(d - radius, 0.0)
        p_sel = np.exp(-(k / 4.0) * over**4 / kBT)
        free = rng.random(n_atoms) < p_sel
        free[reference_idx] = not freeze_reference
        return reference_idx, free

    def multiple_steps_local_selection(
        self,
        n_steps: int,
        reference_idx: int,
        selection_idxs,
        store_x_interval: int = 0,
        radius: float = 1.2,
        k: float = 10_000.0,
        freeze_reference: bool = True,
    ):
        """Advance n_steps moving only the atoms of selection_idxs, each
        flat-bottom restrained (radius, k) to reference_idx, which must not be
        among them; the reference is frozen unless freeze_reference is False.
        Returns (frames, boxes) as multiple_steps."""
        selection_idxs = np.asarray(selection_idxs, dtype=np.int64)
        assert selection_idxs.ndim == 1 and len(selection_idxs) > 0
        n_atoms = self._x.shape[0]
        if np.any((selection_idxs < 0) | (selection_idxs >= n_atoms)):
            raise ValueError("selection_idxs out of range")
        if reference_idx in selection_idxs:
            raise ValueError("reference_idx must not be part of selection_idxs")
        free = np.zeros(n_atoms, dtype=bool)
        free[selection_idxs] = True
        free[reference_idx] = not freeze_reference
        return self._run_local(n_steps, int(reference_idx), free, k, radius, store_x_interval, freeze_reference)

    def local_restraint(self, x, box, reference_idx: int, free, k: float, radius: float, freeze_reference: bool):
        """(u, force) of local MD's restraints in float64: k/4 max(d_i -
        radius, 0)^4 on each free atom i, d_i its distance from the reference;
        with freeze_reference False also -kT log(1 - (1 - 1e-12) exp(-U_fb /
        kT)) on each frozen atom other than the reference (kT of
        setup_local_md's temperature, else the integrator's)."""
        f64 = torch.float64
        x64, box64 = x.to(f64), box.to(f64)
        free = torch.as_tensor(free, device=x.device)
        diff = periodic_delta(x64, x64[reference_idx], box64)
        d = torch.linalg.vector_norm(diff, dim=-1)
        over = torch.clamp(d - radius, min=0.0)
        u_fb = (k / 4.0) * over**4
        du_fb = k * over**3  # dU_fb/dd
        w_free = free.to(f64)
        u = torch.sum(w_free * u_fb)
        g = w_free * du_fb
        if not freeze_reference:
            temperature = self._local_md_temperature or getattr(self.integrator, "temperature", 300.0)
            inv_kT = 1.0 / (BOLTZ * temperature)
            shell = (~free).to(f64)
            shell[reference_idx] = 0.0
            e = torch.exp(-inv_kT * u_fb) * (1.0 - 1e-12)
            u = u + torch.sum(shell * -torch.log1p(-e)) / inv_kT
            g = g + shell * (-e / (1.0 - e)) * du_fb
        unit = diff / torch.where(d > 0, d, 1.0)[:, None]
        grad = g[:, None] * unit  # dU/dx_i
        force = -grad
        force[reference_idx] = force[reference_idx] + grad.sum(0)
        return u, force

    def _run_local(self, n_steps, reference_idx, free, k, radius, store_x_interval, freeze_reference):
        if self._verlet:
            raise NotImplementedError("local MD steps Langevin BAOAB only")
        if not np.any(free):
            raise RuntimeError("local MD selection has no free particles")
        interval = store_x_interval if store_x_interval > 0 else max(n_steps, 1)
        n_frames = n_steps // interval
        free_t = torch.as_tensor(free, device=self.device)
        free3 = free_t[:, None]
        frames, boxes = [], []
        with torch.no_grad():
            self._ensure_lists()
            for s in range(1, n_steps + 1):
                t, x, box = self._step, self._x, self._box
                restraint = self.local_restraint(x, box, reference_idx, free_t, k, radius, freeze_reference)[1]
                force = self._force(x, box, t) + restraint.to(x.dtype)
                noise = torch.randn(x.shape, generator=self._noise, device=self.device, dtype=x.dtype)
                x_new, v_new = langevin_step(x, self._v, force, noise, self._ca, self._cb, self._cc, self.integrator.dt)
                self._x = torch.where(free3, x_new, x)  # frozen atoms keep x and v bitwise
                self._v = torch.where(free3, v_new, self._v)
                self._step = t + 1
                if s % interval == 0 and len(frames) < n_frames:
                    frames.append(self._x)
                    boxes.append(self._box)
        # the local steps moved atoms outside the lists' schedule: the next call rebuilds
        self._prov_states = None
        self._validate_state()
        if not frames:
            return np.zeros((0, *self._x.shape)), np.zeros((0, 3, 3))
        return torch.stack(frames).cpu().numpy(), torch.stack(boxes).cpu().numpy()

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

    draw_rows = (rows, n_total), where given, says that these K replicas are
    the rows `rows` (a slice) of a batch of n_total, the rest on other
    ranks of a mesh (parallel/replica_exchange.py): every draw, the noise,
    the barostat's uniforms and the water sampler's draws, is then made for
    the whole batch from the generator and sliced, and the terms without a
    batched provider are evaluated over a batch of n_total rows (these
    replicas at their rows, the others repeats of them) and sliced: an
    elementwise or reduction kernel rounds a row by where it lies in the
    batch (the CPU's vectorized math, a reduction's launch shape), so each
    row meets the arithmetic it meets in the whole batch and the rows step
    bitwise as they would there. The providers' sweeps are per system.
    """

    def __init__(self, context: Context, xs, vs, boxes, params, seed: int, draw_rows=None):
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
        self._draw_rows = draw_rows
        self._layout = None  # the whole batch's rows, as indices of these replicas
        if draw_rows is not None:
            rows, total = draw_rows
            self._layout = (torch.arange(total, device=self.device) - rows.start) % k
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

    def _make_move_fn(self, mover):
        """Context's move over (K, ...) tensors (a barostat's energy is
        _mover_energy's (K,) energies); under draw_rows, the same move with
        its draws made for the whole batch and sliced."""
        move = Context._make_move_fn(self, mover)
        if self._draw_rows is None:
            return move
        rows, total = self._draw_rows
        if isinstance(mover, MonteCarloBarostat):
            rigid = getattr(mover, "rigid_group_move", False)
            move_with = mover.make_move_with_uniforms(lambda x, box: self._mover_energy(x, box, rigid), self.device)

            def barostat_rows(state, x, v, box):
                u = torch.rand((total, 2), generator=state.generator, device=box.device, dtype=box.dtype)[rows]
                return move_with(state, x, v, box, u[:, 0], u[:, 1])

            return barostat_rows
        if isinstance(mover, TIBDExchangeMove):

            def sampler_rows(state, x, v, box):
                uniforms, normals = mover.draw(state.generator, total, x.device)
                return move.with_draws(state, x, v, box, uniforms[:, rows], normals[:, rows])

            return sampler_rows
        raise NotImplementedError(f"BatchedContext: {type(mover).__name__} cannot draw for a batch split over ranks")

    def _whole(self, t):
        """t (K, ...) laid out as the whole batch under draw_rows (t itself without)."""
        return t if self._layout is None else t[self._layout]

    def _own(self, t):
        """These replicas' rows of a whole-batch result."""
        return t if self._draw_rows is None else t[self._draw_rows[0]]

    # the same code over (K, ...) tensors
    _fire_movers = Context._fire_movers
    set_barostat_interval = Context.set_barostat_interval
    set_water_sampler_params = Context.set_water_sampler_params
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
                total = total + self._own(self._u[i](self._whole(xs), self._whole(self._params[i]), self._whole(boxes)))
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
                    u = self._own(torch.func.vmap(torch.func.vmap(self.potentials[i].u, in_dims=(None, 0, None)))(
                        self._whole(x64), self._whole(ps.to(f64)), self._whole(box64)
                    ))
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
                f = self._own(self._u_force[i](self._whole(x), self._whole(self._params[i]), self._whole(box))[1])
            force = force + f
        if noise is None:
            if self._draw_rows is None:
                noise = torch.randn(x.shape, generator=self._noise, device=self.device, dtype=x.dtype)
            else:
                rows, total = self._draw_rows
                noise = torch.randn((total, *x.shape[1:]), generator=self._noise, device=self.device, dtype=x.dtype)[rows]
        self._x, self._v = langevin_step(x, self._v, force, noise, self._ca, self._cb, self._cc, self.integrator.dt)
        self._fire_movers(t)
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
