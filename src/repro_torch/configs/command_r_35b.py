"""command-r-35b [dense] -- 40L d=8192 64H (kv 8) d_ff=22528 vocab=256000,
GQA, no-bias (all projections bias-free, as everywhere in this repo).
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
    vocab=256000, rope_theta=1e4, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512)
