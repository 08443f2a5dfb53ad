"""whisper-large-v3 [audio] -- enc-dec, 32+32L d=1280 20H (kv 20)
d_ff=5120 vocab=51866. Conv/audio frontend is a STUB: the encoder takes
precomputed (B, 1500, 1280) frame embeddings. [arXiv:2212.04356;
unverified]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, mlp="gelu", norm="layernorm",
    encoder_layers=32, encoder_ctx=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, encoder_layers=2, encoder_ctx=32)
