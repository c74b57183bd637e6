"""REST2-style enhanced sampling of the intermediate states (counterpart of
timemachine_tpu/fe/rest/)."""
