"""hymba-1.5b [hybrid] -- 32L d=1600 25H (kv 5) d_ff=5504 vocab=32001,
parallel attention + Mamba heads per block, ssm_state=16, sliding-window
attention (1024) with 3 full-attention layers {first, mid, last}, and 128
learnable meta tokens (attention sinks). [arXiv:2411.13676; hf]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64, ssm_state=16, ssm_expand=2, ssm_headdim=64,
    ssm_groups=1, ssm_conv=4, sliding_window=1024,
    global_attn_layers=(0, 15, 31), meta_tokens=128, rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, ssm_state=8, ssm_headdim=16, ssm_chunk=16,
    sliding_window=16, global_attn_layers=(0,), meta_tokens=8)
