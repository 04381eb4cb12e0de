"""What every cell of the benchmark shares: loading cells by name, making
inputs and weights from the seed, counting operations and bytes from shapes,
reading the profiler's trace and comparing outputs with the reference."""
