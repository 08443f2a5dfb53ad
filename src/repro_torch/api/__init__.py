"""The port's detection API: one config tree, one typed result, one
session facade (training, checkpoints, frames, batches and clips)."""
from .config import PipelineConfig, presets
from .results import Detections
from .session import DetectionSession
