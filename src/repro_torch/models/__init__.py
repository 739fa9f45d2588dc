"""Models of the port: the FL simulation CNN (`cnn`), the hybrid LM family
(`hybrid`, Griffin / RecurrentGemma), the dense decoder-only LM family
(`dense`: qwen2, granite, codeqwen, h2o-danube), the mixture-of-experts
family (`moe`: deepseek-moe, deepseek-v2's MLA), the Qwen2-VL backbone
(`vlm`, M-RoPE), the xLSTM family (`ssm`), the Whisper encoder-decoder
(`encdec`) and their layers.

Registry counterpart of `repro/models/__init__.py`: one `ModelApi` per
family, all six of the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from . import dense, encdec, hybrid, moe, ssm, vlm
from .config import ModelConfig


class ModelApi(NamedTuple):
    init_params: Callable[..., Any]      # (generator, cfg, device) -> params
    loss_fn: Callable[..., Any]          # (params, batch, cfg) -> scalar
    init_cache: Callable[..., Any]       # (cfg, batch, cache_len, device)
    decode_step: Callable[..., Any]      # (params, cache, tokens, pos, cfg)


_FAMILIES = {
    "dense": ModelApi(dense.init_params, dense.loss_fn, dense.init_cache,
                      dense.decode_step),
    "hybrid": ModelApi(hybrid.init_params, hybrid.loss_fn, hybrid.init_cache,
                       hybrid.decode_step),
    "moe": ModelApi(moe.init_params, moe.loss_fn, moe.init_cache,
                    moe.decode_step),
    "vlm": ModelApi(vlm.init_params, vlm.loss_fn, vlm.init_cache,
                    vlm.decode_step),
    "ssm": ModelApi(ssm.init_params, ssm.loss_fn, ssm.init_cache,
                    ssm.decode_step),
    "encdec": ModelApi(encdec.init_params, encdec.loss_fn, encdec.init_cache,
                       encdec.decode_step),
}


def _check_family(fam: str) -> None:
    if fam not in _FAMILIES:
        raise ValueError(f"unknown model family {fam!r}")


def get_model(cfg: ModelConfig) -> ModelApi:
    _check_family(cfg.family)
    return _FAMILIES[cfg.family]


def prefill_logits(params: dict, batch: dict, cfg: ModelConfig):
    """Inference prefill: the full forward, lm_head on the LAST position
    only (the next-token sample point).  The moe forward's logits without
    its aux loss; the vlm and encdec forwards take the whole batch
    (tokens and vision embeddings, or frames)."""
    _check_family(cfg.family)
    fam = cfg.family
    if fam == "moe":
        return moe.forward_train(params, batch["tokens"], cfg,
                                 last_only=True)[0]
    mod = {"dense": dense, "hybrid": hybrid, "ssm": ssm, "vlm": vlm,
           "encdec": encdec}[fam]
    inputs = batch if fam in ("vlm", "encdec") else batch["tokens"]
    return mod.forward_train(params, inputs, cfg, last_only=True)


__all__ = ["ModelConfig", "ModelApi", "get_model", "prefill_logits", "dense",
           "encdec", "hybrid", "moe", "ssm", "vlm"]
