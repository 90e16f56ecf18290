"""Operators and the hand-written kernels of the port."""
