"""h2o-danube-1.8b [arXiv:2401.16818] — llama+mistral mix, GQA kv=8, SWA.

Port of `repro/configs/h2o_danube_1_8b.py`.  Sliding-window attention
(window 4096, mistral-style) makes this the one *dense* arch that runs the
long_500k decode shape (cache bounded by window).  hd = 2560 / 32 = 80.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32_000, window=4096, rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab=256, window=16, remat=False,
                          compute_dtype="float32")
