"""Utilities of the port: stage timers and profiler annotations."""
