"""The LM configuration (port of repro/models/configs.py).

One dataclass with the reference's fields and defaults; the family
selects features:
  dense   -- GQA transformer (internlm2, phi3, qwen3, command-r)
  moe     -- + mixture-of-experts FFN (llama4-scout, olmoe)
  ssm     -- attention-free Mamba-2 SSD stack (mamba2-130m)
  hybrid  -- parallel attention + SSM heads per block (hymba)
  encdec  -- encoder-decoder with cross-attention (whisper)
  vlm     -- decoder with M-RoPE positions (qwen2-vl)

The port runs all six (``models/model.py``); ``dtype`` is a torch dtype
here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False
    mlp: str = "swiglu"             # swiglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    rope_theta: float = 1e6
    mrope: bool = False             # M-RoPE (t/h/w sections, qwen2-vl)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False     # llama4-style always-on shared expert
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0              # d_state (N)
    ssm_expand: int = 2
    ssm_headdim: int = 64           # P
    ssm_groups: int = 1             # G (B/C groups)
    ssm_conv: int = 4               # causal conv width
    ssm_chunk: int = 256            # SSD chunk length

    # --- attention variants ---
    sliding_window: int = 0         # 0 = full; hymba uses 1024
    global_attn_layers: Tuple[int, ...] = ()   # layers that stay full-attn
    meta_tokens: int = 0            # hymba learnable prefix tokens

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_ctx: int = 0            # 1500 audio frames after conv stub

    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:     # H_ssm = d_inner / P
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:      # conv runs over [x, B, C]
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid w/ sliding attn)."""
        return self.family == "ssm" or (self.family == "hybrid"
                                        and self.sliding_window > 0)

    # ---- parameter counting (for 6ND roofline cross-check) ----
    def param_count(self, active_only: bool = False) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab
        nrm = 2 * D if self.norm == "layernorm" else D  # scale (+ bias)
        n = V * D                                   # embed
        if not self.tie_embeddings:
            n += D * V                              # lm_head
        n += nrm                                    # final norm

        def attn_params() -> int:
            hd = self.hd
            p = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
                + self.n_heads * hd * D
            if self.qk_norm:
                p += 2 * hd
            return p

        def dense_ffn() -> int:
            return 3 * D * F if self.mlp == "swiglu" else 2 * D * F

        def ssm_params() -> int:
            di, G, N, H = (self.d_inner, self.ssm_groups, self.ssm_state,
                           self.ssm_heads)
            p = D * (2 * di + 2 * G * N + H)        # in_proj [z,x,B,C,dt]
            p += self.conv_dim * (self.ssm_conv + 1)  # conv w + bias
            p += 3 * H + di                         # A_log, D, dt_bias, norm
            p += di * D                             # out_proj
            return p

        per_layer = 2 * nrm                         # ln1, ln2
        if self.has_attention:
            per_layer += attn_params()
        if self.has_ssm:
            per_layer += ssm_params()
            if self.family == "hybrid":
                per_layer += 2 * nrm                # branch norms
        if self.family in ("dense", "encdec", "vlm", "hybrid"):
            per_layer += dense_ffn()
        if self.is_moe:
            e = (self.top_k if active_only else self.n_experts)
            per_layer += D * self.n_experts         # router (always dense)
            per_layer += e * 3 * D * F
            if self.shared_expert:
                per_layer += 3 * D * F
        n += self.n_layers * per_layer
        if self.encoder_layers:
            enc_per = 2 * nrm + attn_params() + dense_ffn()
            n += self.encoder_layers * enc_per + nrm   # + enc final norm
            n += self.n_layers * (attn_params() + nrm)  # dec cross-attn + ln_x
        if self.meta_tokens:
            n += self.meta_tokens * D
        return n
