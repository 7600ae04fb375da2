"""Checkpoint I/O and numerical gradient checks of the port."""
