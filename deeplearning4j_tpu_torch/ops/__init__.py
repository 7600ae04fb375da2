"""Tensor-level helpers and the hand-written kernels of the port."""
