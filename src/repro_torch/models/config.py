"""Model configuration shared by every architecture family.

Port of `repro/models/config.py`: one frozen dataclass with the same
fields, defaults and analytic parameter count; `pdtype` and `cdtype`
return torch dtypes.  The port runs the hybrid, dense, moe and vlm
families so far (ROADMAP item 15); the other families' fields are kept so
that a config compares field by field with the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    window: int = 0                  # sliding-window attention size; 0 = full causal
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE (deepseek-moe / deepseek-v2) ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    first_dense_layers: int = 1
    dense_ff: int = 0
    capacity_factor: float = 1.25
    moe_seq_chunk: int = 4096
    router_aux_coef: float = 0.001

    # --- MLA (deepseek-v2) ---
    kv_lora: int = 0
    q_lora: int = 0
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- hybrid (recurrentgemma / griffin) ---
    lru_width: int = 0               # RG-LRU hidden width
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 2048         # local attention window in hybrid family
    conv1d_width: int = 4

    # --- ssm (xlstm) ---
    slstm_layers: Tuple[int, ...] = ()
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333333
    mlstm_chunk: int = 256

    # --- encdec (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 1500
    max_target_positions: int = 0

    # --- vlm (qwen2-vl) ---
    mrope_sections: Tuple[int, ...] = ()
    n_vision_tokens: int = 0

    # --- numerics / training ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_unroll: int = 1
    kv_quant: bool = False
    moe_dispatch_axes: Tuple[str, ...] = ()

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (the reference's formula)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.kv_lora:  # MLA
                q_in = self.q_lora or D
                p = 0
                if self.q_lora:
                    p += D * self.q_lora
                p += q_in * self.n_heads * (self.nope_head_dim +
                                            self.rope_head_dim)
                p += D * (self.kv_lora + self.rope_head_dim)
                p += self.kv_lora * self.n_heads * (self.nope_head_dim +
                                                    self.v_head_dim)
                p += self.n_heads * self.v_head_dim * D
                return p
            qp = D * self.n_heads * hd
            kp = D * self.n_kv_heads * hd
            return qp + 2 * kp + self.n_heads * hd * D

        def ffn_dense(f) -> int:
            return 3 * D * f  # SwiGLU

        if self.family in ("dense", "vlm"):
            return emb + L * (attn_params() + ffn_dense(F))
        if self.family == "moe":
            e_act = (self.top_k if active_only else self.n_experts) + \
                self.n_shared_experts
            moe_layer = attn_params() + e_act * 3 * D * self.d_expert + \
                D * self.n_experts
            dense_layer = attn_params() + ffn_dense(self.dense_ff or 4 * D)
            n_moe = L - self.first_dense_layers
            return emb + n_moe * moe_layer + \
                self.first_dense_layers * dense_layer
        if self.family == "hybrid":
            W = self.lru_width or D
            lru_layer = D * W * 2 + W * D + 4 * W + W * self.conv1d_width + \
                ffn_dense(F)
            attn_layer = attn_params() + ffn_dense(F)
            n_attn = sum(1 for i in range(L) if self._block_kind(i) == "attn")
            return emb + n_attn * attn_layer + (L - n_attn) * lru_layer
        if self.family == "ssm":
            up = int(D * self.mlstm_proj_factor)
            m_layer = D * up * 2 + 3 * up * up // 1 + up * D
            return emb + L * m_layer
        if self.family == "encdec":
            enc_layer = attn_params() + 2 * D * F
            dec_layer = 2 * attn_params() + 2 * D * F
            return emb + self.n_enc_layers * enc_layer + L * dec_layer
        raise ValueError(self.family)

    def _block_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]
