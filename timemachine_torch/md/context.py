"""Context: the MD step loop (counterpart of the canonical step of
timemachine_tpu/md/context.py).

`multiple_steps(n_steps, store_x_interval)` advances Langevin BAOAB steps;
movers fire on steps where (t + 1) % interval == 0. Everything stays on the
device: the rebuild and mover schedules read the host's step counter, the
barostat's accept and the list-overflow poison are torch.where on device,
and the one host sync per call is the coordinate/box check at its end.

Potentials with an `md_force_provider` (the nonbonded term) keep list
state that is carried across calls, so how steps are split into calls does
not change the trajectory; set_x_t, set_box and set_params drop it. The
Langevin noise and every mover draw from their own torch.Generator, seeded
from the integrator's and the movers' seeds.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from timemachine_torch.integrators import LangevinIntegrator, langevin_step


class Context:
    def __init__(
        self,
        x0,
        v0,
        box0,
        integrator: LangevinIntegrator,
        bps: Sequence,
        movers: Sequence = (),
        device=None,
    ):
        self.device = torch.device(device if device is not None else "cpu")
        self._x = torch.as_tensor(x0, device=self.device)
        dtype = self._x.dtype
        self._v = torch.as_tensor(v0, device=self.device, dtype=dtype)
        self._box = torch.as_tensor(box0, device=self.device, dtype=dtype)
        if self._x.shape != self._v.shape or self._box.shape != (3, 3):
            raise ValueError("x0 and v0 must have one shape and box0 must be (3, 3)")
        self.integrator = integrator
        self.potentials = list(bps)
        self.movers = list(movers)
        ca, cb, cc = integrator.coefficients()
        self._ca = float(ca)
        self._cb = torch.as_tensor(cb, device=self.device, dtype=dtype)
        self._cc = torch.as_tensor(cc, device=self.device, dtype=dtype)
        self._noise = torch.Generator(device=self.device)
        self._noise.manual_seed(integrator.seed)
        self._mover_states = [m.init_state(self.device, dtype) for m in self.movers]
        self._step = 0
        self._providers = {}
        for i, pot in enumerate(self.potentials):
            md = getattr(pot, "md_force_provider", None)
            if md is not None:
                self._providers[i] = md()
        self._prov_states = None
        self._move_fns = [
            m.make_move_fn(
                lambda x, box, _rigid=getattr(m, "rigid_group_move", False): self._mover_energy(x, box, _rigid),
                self.device,
            )
            for m in self.movers
        ]

    # -- observers ------------------------------------------------------------

    def get_x_t(self) -> np.ndarray:
        return self._x.cpu().numpy()

    def get_v_t(self) -> np.ndarray:
        return self._v.cpu().numpy()

    def get_box(self) -> np.ndarray:
        return self._box.cpu().numpy()

    def get_mover_states(self) -> list:
        return list(self._mover_states)

    def set_x_t(self, x):
        self._x = torch.as_tensor(x, device=self.device, dtype=self._x.dtype)
        self._prov_states = None

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

    def _one_step(self):
        t = self._step
        x, box = self._x, self._box
        force = torch.zeros_like(x)
        for i, pot in enumerate(self.potentials):
            if i in self._providers:
                f, self._prov_states[i] = self._providers[i][1](self._prov_states[i], x, box, t)
            else:
                f = pot.energy_force(x, box)[1]
            force = force + f
        noise = torch.randn(x.shape, generator=self._noise, device=self.device, dtype=x.dtype)
        self._x, self._v = langevin_step(x, self._v, force, noise, self._ca, self._cb, self._cc, self.integrator.dt)
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
            for s in range(1, n_steps + 1):
                self._one_step()
                if s % interval == 0 and len(frames) < n_frames:
                    frames.append(self._x)  # steps rebind x and box, never write them in place
                    boxes.append(self._box)
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
