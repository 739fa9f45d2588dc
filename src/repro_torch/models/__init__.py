"""Models of the port: the FL simulation CNN (`cnn`), the hybrid LM family
(`hybrid`, Griffin / RecurrentGemma), the dense decoder-only LM family
(`dense`: qwen2, granite, codeqwen, h2o-danube) and their layers.

Registry counterpart of `repro/models/__init__.py`: one `ModelApi` per
family the port runs.  The reference's other LM families (moe, ssm,
encdec, vlm) are still to port (ROADMAP item 15) and raise.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from . import dense, hybrid
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
}
_UNPORTED = ("moe", "ssm", "encdec", "vlm")


def _check_family(fam: str) -> None:
    if fam in _UNPORTED:
        raise NotImplementedError(
            f"model family {fam!r} is not ported yet (ROADMAP item 15); "
            f"ported: {sorted(_FAMILIES)}")
    if fam not in _FAMILIES:
        raise ValueError(f"unknown model family {fam!r}")


def get_model(cfg: ModelConfig) -> ModelApi:
    _check_family(cfg.family)
    return _FAMILIES[cfg.family]


def prefill_logits(params: dict, batch: dict, cfg: ModelConfig):
    """Inference prefill: the full forward, lm_head on the LAST position
    only (the next-token sample point)."""
    _check_family(cfg.family)
    fam = dense if cfg.family == "dense" else hybrid
    return fam.forward_train(params, batch["tokens"], cfg, last_only=True)


__all__ = ["ModelConfig", "ModelApi", "get_model", "prefill_logits", "dense",
           "hybrid"]
