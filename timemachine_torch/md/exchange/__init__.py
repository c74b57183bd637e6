"""Water exchange moves: biased deletion and targeted insertion (the
counterpart of timemachine_tpu/md/exchange/)."""
