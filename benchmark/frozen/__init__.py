"""Copies that the yardstick needs, kept here so that a change to the
program cannot move them: the synthetic premixed opacity table, the bytes
and operations of one call of each CUDA kernel, and the profiler's busy
and idle arithmetic."""
