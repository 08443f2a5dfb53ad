"""llama4-scout-17b-a16e [moe] -- 48L d=5120 40H (kv 8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, n_experts=16, top_k=1, shared_expert=True,
    rope_theta=5e5,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=512, head_dim=16, n_experts=4, top_k=1, capacity_factor=8.0)
