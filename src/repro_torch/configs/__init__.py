"""Workload configurations of the port: the HOG presets (hog_svm.py) and
the LM architectures (registry.py)."""
from .registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "get_config"]
