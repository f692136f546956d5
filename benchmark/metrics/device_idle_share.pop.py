"""``device_idle_share.train``, read in the population cells, which report
``pop_trial_steps_per_s``."""

from benchmark.harness import reader

read = reader("device_idle_share.train")
