"""Workload configurations of the port."""
