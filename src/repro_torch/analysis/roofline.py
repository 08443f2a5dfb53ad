"""Three-term roofline of one step on the H100 (port of
repro/analysis/roofline.py, whose constants are the TPU v5e's).

H100 SXM per-card constants, NVIDIA H100 Tensor Core GPU data sheet; the
one copy in the package (chip_smoke.py's bounds read them from here):
    989.4 TFLOP/s dense bf16 | 3.35 TB/s HBM3 | 450 GB/s NVLink a direction

Terms (seconds, per step, per device):
    T_compute = FLOPs_dev / PEAK_FLOPS
    T_memory  = HBM_bytes_dev / HBM_BW
    T_coll    = collective_bytes_dev / NVLINK_BW

The counts come from a step traced on the meta device
(analysis/op_count.py); launch/dryrun.py says how they become per-device
numbers. MODEL_FLOPS = 6*N*D (active N for MoE; 2*N*D for inference)
cross-checks how much counted compute is useful.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989.4e12     # dense bf16 tensor-core FLOP/s, a card
HBM_BW = 3.35e12          # HBM3 bytes/s, a card
NVLINK_BW = 450e9         # NVLink bytes/s a direction, a card
F32_FLOPS = 67e12         # f32 CUDA-core FLOP/s (an FMA counted as two)
INT8_OPS = 1979e12        # dense int8 tensor-core OP/s


@dataclasses.dataclass
class Roofline:
    name: str
    flops_dev: float
    mem_bytes_dev: float
    coll_bytes_dev: float
    model_flops_dev: float = 0.0
    cost_flops: float = 0.0           # the reference's raw cost_analysis;
    cost_bytes: float = 0.0           # the port reports its trace's

    @property
    def t_compute(self) -> float:
        return self.flops_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.mem_bytes_dev / HBM_BW

    @property
    def t_coll(self) -> float:
        return self.coll_bytes_dev / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_coll}
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """Roofline step time (perfect overlap: max of the three)."""
        return max(self.t_compute, self.t_memory, self.t_coll)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat/padding/capacity waste)."""
        if self.flops_dev <= 0:
            return 0.0
        return self.model_flops_dev / self.flops_dev

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        if self.step_time <= 0:
            return 0.0
        return (self.model_flops_dev / PEAK_FLOPS) / self.step_time

    def row(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_coll_s": self.t_coll,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time,
            "flops_dev": self.flops_dev,
            "mem_bytes_dev": self.mem_bytes_dev,
            "coll_bytes_dev": self.coll_bytes_dev,
            "model_flops_dev": self.model_flops_dev,
            "useful_flops_frac": self.useful_flops_frac,
            "mfu": self.mfu,
        }


def model_flops(cfg, shape, n_chips: int, batch: int = 0) -> float:
    """6ND train / 2ND forward (active params for MoE), per device;
    ``batch`` in place of the shape's global batch where given."""
    n_active = cfg.param_count(active_only=True)
    b = batch or shape.global_batch
    if shape.kind == "train":
        total = 6.0 * n_active * b * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n_active * b * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n_active * b
    return total / n_chips
