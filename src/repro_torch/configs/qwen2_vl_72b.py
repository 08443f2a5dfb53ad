"""qwen2-vl-72b [vlm] -- 80L d=8192 64H (kv 8) d_ff=29568 vocab=152064,
M-RoPE + dynamic resolution. The vision frontend (ViT patch encoder) is a
STUB: the model takes token ids plus (B, S, 3) M-RoPE (t, h, w) position
streams; image patches arrive as precomputed embeddings merged upstream.
[arXiv:2409.12191; hf]
"""
import dataclasses
from ..models.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, mrope_sections=(2, 3, 3))
