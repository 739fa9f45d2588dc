"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE.

Port of `repro/configs/deepseek_moe_16b.py`: 64 routed experts (top-6) +
2 shared experts, d_expert=1408; layer 0 keeps a dense FFN of 11,264
(8 x 1408, where the model card has 10,944).  GQA with kv=16 (MHA at 16
heads).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102_400,
    n_experts=64, n_shared_experts=2, top_k=6, d_expert=1408,
    first_dense_layers=1, dense_ff=11_264,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          d_ff=64, vocab=256, n_experts=4, n_shared_experts=1,
                          top_k=2, d_expert=64, dense_ff=256, remat=False,
                          compute_dtype="float32")
