"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] — dense qwen1.5 arch, MHA kv=32.

Port of `repro/configs/codeqwen1_5_7b.py`.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13_440, vocab=92_416, qkv_bias=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          d_ff=256, vocab=256, remat=False,
                          compute_dtype="float32")
