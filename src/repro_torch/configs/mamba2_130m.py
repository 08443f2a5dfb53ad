"""mamba2-130m [ssm] -- 24L d=768, attention-free, vocab=50280,
SSD (state-space duality), d_state=128, expand=2, headdim=64.
[arXiv:2405.21060; unverified]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_groups=1, ssm_conv=4, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab=512, ssm_state=16,
    ssm_headdim=16, ssm_chunk=16)
