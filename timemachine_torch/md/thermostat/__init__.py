"""Thermostat moves (the port of timemachine_tpu/md/thermostat/)."""
