"""Atomic checkpoints of the port (the layout of repro/checkpoint)."""
