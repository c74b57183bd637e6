"""Invertible configuration maps for precision-boosted estimators (the port
of timemachine_tpu/maps/)."""
