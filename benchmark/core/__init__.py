"""What every cell of the benchmark shares: loading by name, seeds, the
solver recipes, the profiler's reading and the result line."""
