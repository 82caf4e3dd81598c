"""Run tooling: the metrics logger, checkpoints and profiling."""
