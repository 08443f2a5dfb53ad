"""The paper's own workload config: the HOG+SVM detection co-processor
(a copy of repro/configs/hog_svm.py). QUANT, the fixed-point datapath,
arrives with slice 2; the training schedule rides in PipelineConfig.train
as a plain dict (api/config.py)."""
import dataclasses

from ..core.hog import HOGConfig

# faithful: fp32 datapath, CORDIC magnitude/angle, NR rsqrt
FAITHFUL = HOGConfig(mode="cordic")

# default: sector-compare binning, hardware rsqrt
CONFIG = HOGConfig(mode="sector")

# perf: bf16 descriptors + bf16 SVM weights (f32 accumulation)
PERF = dataclasses.replace(CONFIG, feat_dtype="bf16")
