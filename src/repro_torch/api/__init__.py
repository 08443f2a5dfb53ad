"""The port's detection API: one config tree, one typed result, one
session facade (single-frame path in this slice)."""
from .config import PipelineConfig, presets
from .results import Detections
from .session import DetectionSession
