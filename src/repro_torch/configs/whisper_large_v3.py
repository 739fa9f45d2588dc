"""whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio backbone.

Port of `repro/configs/whisper_large_v3.py`.  The conv / mel frontend is
a stub (the batch carries 1,500 frame embeddings); 32 encoder + 32
decoder layers, d_model=1280, 20 heads, GELU MLPs, LayerNorm + bias.
Decoder positions are sinusoidal (the reference's deviation: real
whisper learns a 448-entry table, too short for decode_32k).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51_866,
    n_enc_layers=32, n_frames=1500,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
                          n_kv_heads=4, d_ff=256, vocab=256, n_frames=24,
                          remat=False, compute_dtype="float32")
