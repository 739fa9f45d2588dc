"""recurrentgemma-9b [arXiv:2402.19427] — Griffin: RG-LRU + local attention 1:2.

38 layers, pattern (RG-LRU, RG-LRU, local-attn); MQA (kv=1) with a 2048-token
window; lru_width=4096.  Port of `repro/configs/recurrentgemma_9b.py`.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12_288, vocab=256_000,
    lru_width=4096, local_window=2048, conv1d_width=4,
    block_pattern=("rglru", "rglru", "attn"),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    # 5 layers = 1 full period (lru,lru,attn) + 2 tail lru layers
    return CONFIG.replace(n_layers=5, d_model=128, n_heads=4, n_kv_heads=1,
                          d_ff=256, vocab=256, lru_width=128, local_window=16,
                          remat=False, compute_dtype="float32")
