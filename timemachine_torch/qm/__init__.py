"""Native semi-empirical QM (AM1) for base partial charges.

The port's copy of timemachine_tpu/qm/__init__.py (numpy and scipy).

The reference framework obtains AM1-family charges from the proprietary
OpenEye backend (`timemachine/ff/handlers/nonbonded.py:343-520`); this
package implements the published AM1 model directly so that AM1/AM1BCC
base charges are computed natively, with no licensed backend and no
network access. Host-side numpy only — charge generation is a one-shot
system-build step, never part of the MD hot path.
"""

from timemachine_torch.qm.scf import AM1Result, AM1System, SCFConvergenceError, am1

__all__ = ["AM1Result", "AM1System", "SCFConvergenceError", "am1"]
