"""Serving of the port: LM generation (engine.py)."""
