"""Protocol optimization (the port of timemachine_tpu/optimize/)."""
