"""Simulation state container (counterpart of timemachine_tpu/md/states.py)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CoordsVelBox(NamedTuple):
    coords: np.ndarray
    velocities: np.ndarray
    box: np.ndarray
