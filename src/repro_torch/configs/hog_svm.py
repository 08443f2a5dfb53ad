"""The paper's own workload config: the HOG+SVM detection co-processor
(a copy of repro/configs/hog_svm.py). The training schedule rides in
PipelineConfig.train as a plain dict (api/config.py)."""
import dataclasses

from ..core.hog import HOGConfig

# faithful: fp32 datapath, CORDIC magnitude/angle, NR rsqrt
FAITHFUL = HOGConfig(mode="cordic")

# default: sector-compare binning, hardware rsqrt
CONFIG = HOGConfig(mode="sector")

# perf: bf16 descriptors + bf16 SVM weights (f32 accumulation)
PERF = dataclasses.replace(CONFIG, feat_dtype="bf16")

# the paper's actual datapath: integer CORDIC gradients, int16 cell
# histograms, int8 block descriptors, int8 scoring matmul
# (repro/configs/hog_svm.py:24)
QUANT = HOGConfig(mode="cordic", numerics="fixed")
