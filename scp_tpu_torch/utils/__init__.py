"""Utilities of the port: stage timers and profiler annotations
(profiling), the build directory and CPU devices (env)."""
