"""Trial-steps of a population step completed in the window (steps × K)
over the whole window's seconds, as ``trial_steps_per_s`` reads them. A
metric of its own: a device-bound population step spreads far less from
run to run than a host-bound single-trial step, and so takes its own,
tighter bound."""

from benchmark.harness import reader

read = reader("trial_steps_per_s")
