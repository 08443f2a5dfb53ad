"""Synthetic inputs of the port (numpy only)."""
