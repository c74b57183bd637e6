"""NVT segment move: a few steps of unadjusted Langevin dynamics (the port
of timemachine_tpu/md/thermostat/moves.py)."""

import copy

import numpy as np
import torch

from timemachine_torch.md.context import Context
from timemachine_torch.md.moves import Move
from timemachine_torch.md.states import CoordsVelBox


class UnadjustedLangevinMove(Move[CoordsVelBox]):
    """n_steps of Langevin dynamics applied as a (non-Metropolized) move,
    on copies of the modules, on their device and in their dtype. One
    Context is built at the first move, its all-pairs terms in the form of a
    fresh JAX Context (potentials.all_pairs_kernel's "fresh"), and reset to
    each state moved, as in JAX's; its noise stream runs on from move to
    move."""

    def __init__(self, integrator, bound_potentials, n_steps: int = 5):
        self.integrator = integrator
        self.bound_potentials = [copy.deepcopy(bp) for bp in bound_potentials]
        self.n_steps = n_steps
        self._ctxt = None

    def move(self, x: CoordsVelBox) -> CoordsVelBox:
        if self._ctxt is None:
            from timemachine_torch.md.minimizer import configure_nonbonded

            params = self.bound_potentials[0].params
            x0 = torch.as_tensor(np.asarray(x.coords), device=params.device, dtype=params.dtype)
            box0 = torch.as_tensor(np.asarray(x.box), device=params.device, dtype=params.dtype)
            configure_nonbonded(self.bound_potentials, x0, box0, site="fresh")
            self._ctxt = Context(x0, x.velocities, x.box, self.integrator, self.bound_potentials, device=params.device)
        else:
            self._ctxt.set_x_t(x.coords)
            self._ctxt.set_v_t(x.velocities)
            self._ctxt.set_box(x.box)
        self._ctxt.multiple_steps(self.n_steps)
        return CoordsVelBox(self._ctxt.get_x_t(), self._ctxt.get_v_t(), x.box.copy())
