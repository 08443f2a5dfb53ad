"""The port's detection API: one config tree, one typed result, one
session facade (training, checkpoints, frames, batches, clips, stacked
heads, the cascade and the service)."""
from .config import PipelineConfig, ServiceConfig, presets, register_preset
from .results import Detections
from .session import DetectionSession
from ..core.cascade import CascadeConfig, CascadeDetector
from ..core.heads import HeadRegistry, SVMHead
