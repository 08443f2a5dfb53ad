"""internlm2-20b [dense] -- 48L d=6144 48H (kv 8) d_ff=16384 vocab=92544,
GQA. [arXiv:2403.17297; hf]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544, rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512)
