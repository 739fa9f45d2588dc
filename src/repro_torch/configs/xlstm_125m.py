"""xlstm-125m [arXiv:2405.04517] — sLSTM + mLSTM blocks.

Port of `repro/configs/xlstm_125m.py`.  12 layers, d_model=768, 4 heads;
sLSTM at layers (3, 9) (≈5:1 m:s ratio, the paper's xLSTM[a:b]
notation), the rest chunkwise-parallel mLSTM.  d_ff=0: the blocks carry
their own up / down projections.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304,
    slstm_layers=(3, 9), mlstm_proj_factor=2.0, mlstm_chunk=256,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          vocab=256, slstm_layers=(1,), mlstm_chunk=16,
                          remat=False, compute_dtype="float32")
