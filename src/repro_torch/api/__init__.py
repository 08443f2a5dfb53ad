"""The port's detection API: one config tree, one typed result, one
session facade (training, checkpoints, frames, batches, clips and the
service)."""
from .config import PipelineConfig, ServiceConfig, presets, register_preset
from .results import Detections
from .session import DetectionSession
