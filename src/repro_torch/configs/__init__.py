"""Workload configurations of the port: the HOG presets (hog_svm.py) and
the LM architectures, with the assigned shape set (registry.py)."""
from .registry import (ARCH_IDS, SHAPE_BY_NAME, SHAPES, ShapeSpec,
                       cache_specs, get_config, input_specs,
                       shape_applicable)

__all__ = ["ARCH_IDS", "SHAPES", "SHAPE_BY_NAME", "ShapeSpec", "get_config",
           "input_specs", "cache_specs", "shape_applicable"]
