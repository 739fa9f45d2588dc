"""qwen2-vl-7b [arXiv:2409.12191] — VLM backbone with M-RoPE.

Port of `repro/configs/qwen2_vl_7b.py`.  The ViT encoder + projector is a
stub (the batch carries patch embeddings); the 28-layer language backbone
with GQA (kv=4), QKV bias and 3D M-RoPE (head_dim 128 -> sections
16/24/24 over t/h/w) is real.  Sequences are [1024 vision tokens | text]
at train / prefill; decode is text-only.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18_944, vocab=152_064, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), n_vision_tokens=1024,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab=256, mrope_sections=(4, 6, 6),
                          n_vision_tokens=16, remat=False,
                          compute_dtype="float32")
