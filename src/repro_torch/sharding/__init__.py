"""Sharding rules for the LM on a device grid (rules.py; port of
repro/sharding/)."""
