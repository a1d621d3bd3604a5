"""The general parts of the benchmark: registry, window, trace, products."""
