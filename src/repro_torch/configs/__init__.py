"""Architecture config registry: arch id -> ModelConfig, for the archs the
port runs so far.  The reference's other archs raise a KeyError naming
ROADMAP item 15 (the LM architectures still to port)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES, InputShape

_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
}
# the reference's archs whose family the port does not run yet
_UNPORTED = ("deepseek-moe-16b", "xlstm-125m", "whisper-large-v3",
             "codeqwen1.5-7b", "h2o-danube-1.8b", "deepseek-v2-236b",
             "qwen2-0.5b", "granite-3-2b", "qwen2-vl-7b")


def _module(arch_id: str):
    if arch_id in _UNPORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP item "
                       f"15); ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


__all__ = ["SHAPES", "InputShape", "get_config", "get_reduced"]
