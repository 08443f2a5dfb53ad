"""The paper's own workload config: the HOG+SVM detection co-processor
(a copy of repro/configs/hog_svm.py; the window set's split is
data/synth_pedestrian.py:PedestrianDataConfig's default)."""
import dataclasses

from ..core.hog import HOGConfig
from ..core.svm import SVMTrainConfig

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

# the paper presets' training schedule (repro/configs/hog_svm.py:26)
TRAIN = SVMTrainConfig(steps=4000, neg_weight=6.0)
