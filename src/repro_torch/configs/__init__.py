"""Architecture config registry: arch id -> ModelConfig, for every arch of
the reference (the hybrid recurrentgemma-9b, the four dense archs, the
moe deepseek-moe-16b and deepseek-v2-236b, the vlm qwen2-vl-7b, the ssm
xlstm-125m and the encdec whisper-large-v3).  An unknown arch raises a
KeyError."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES, InputShape

_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-3-2b": "granite_3_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "xlstm-125m": "xlstm_125m",
    "whisper-large-v3": "whisper_large_v3",
}

# every arch of the reference, in its registry's order
ARCH_IDS = ("deepseek-moe-16b", "recurrentgemma-9b", "xlstm-125m",
            "whisper-large-v3", "codeqwen1.5-7b", "h2o-danube-1.8b",
            "deepseek-v2-236b", "qwen2-0.5b", "granite-3-2b", "qwen2-vl-7b")

# archs allowed to run the long_500k decode shape (sub-quadratic or
# windowed attention)
LONG_CONTEXT_ARCHS = ("recurrentgemma-9b", "xlstm-125m", "h2o-danube-1.8b")


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


def shape_applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True


__all__ = ["ARCH_IDS", "SHAPES", "InputShape", "LONG_CONTEXT_ARCHS",
           "get_config", "get_reduced", "shape_applicable"]
