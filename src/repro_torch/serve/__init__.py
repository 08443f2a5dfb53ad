"""Serving of the port: the detection service and LM generation
(engine.py), with the resilience primitives (resilience.py) and fault
injection (faults.py) it composes."""
from .engine import (CircuitOpen, DetectionRequest, DetectionService,
                     FrameRequest, ServiceOverloaded, ServiceStopped,
                     generate)
