"""Utilities of the port: spans, counters and stage timers (profiling),
the build directory and CPU devices (env)."""
