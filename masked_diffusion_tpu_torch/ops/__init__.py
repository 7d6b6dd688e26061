"""Schedules, shifts and the hand-written kernels of the sampling path."""
