"""olmoe-1b-7b [moe] -- 16L d=2048 16H (kv 16) d_ff=1024 vocab=50304,
MoE 64 experts top-8. [arXiv:2409.02060; hf]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, n_experts=64, top_k=8, qk_norm=True, rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
    vocab=512, n_experts=8, top_k=2, capacity_factor=8.0)
