"""deepseek-v2-236b [arXiv:2405.04434] — MLA + fine-grained MoE.

Port of `repro/configs/deepseek_v2_236b.py`.  MLA: kv_lora=512,
q_lora=1536, per-head nope=128 / rope=64 / v=128.  MoE: 160 routed
experts (top-6) + 2 shared, d_expert=1536; layer 0 dense.  236 B
parameters do not fit one card: the port runs it at `reduced()`.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102_400,
    n_experts=160, n_shared_experts=2, top_k=6, d_expert=1536,
    first_dense_layers=1, dense_ff=12_288,
    kv_lora=512, q_lora=1536, nope_head_dim=128, rope_head_dim=64,
    v_head_dim=128,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          d_ff=64, vocab=256, n_experts=4, n_shared_experts=1,
                          top_k=2, d_expert=64, dense_ff=256,
                          kv_lora=32, q_lora=48, nope_head_dim=16,
                          rope_head_dim=8, v_head_dim=16, remat=False,
                          compute_dtype="float32")
