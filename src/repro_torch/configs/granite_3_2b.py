"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base] — dense, GQA kv=8.

Port of `repro/configs/granite_3_2b.py`.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49_155, rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab=256, remat=False,
                          compute_dtype="float32")
