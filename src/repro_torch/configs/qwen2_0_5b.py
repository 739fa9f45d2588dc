"""qwen2-0.5b [arXiv:2407.10671] — dense, GQA kv=2, QKV bias.

Port of `repro/configs/qwen2_0_5b.py`.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151_936, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab=256, remat=False,
                          compute_dtype="float32")
