"""qwen3-14b [dense] -- 40L d=5120 40H (kv 8) d_ff=17408 vocab=151936,
qk_norm + GQA. [hf:Qwen/Qwen3-8B; hf]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16)
