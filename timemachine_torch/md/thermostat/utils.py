"""(the port of timemachine_tpu/md/thermostat/utils.py)"""

from timemachine_torch.md.utils import sample_velocities

__all__ = ["sample_velocities"]
