"""Architecture config registry: arch id -> ModelConfig, for the archs the
port runs so far (the hybrid recurrentgemma-9b, the four dense archs, the
moe deepseek-moe-16b and deepseek-v2-236b, and the vlm qwen2-vl-7b).
The reference's other archs (ssm, encdec) raise a KeyError naming ROADMAP
item 15 (the LM architectures still to port)."""
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
}
# the reference's archs whose family the port does not run yet
_UNPORTED = ("xlstm-125m", "whisper-large-v3")

# every arch of the reference, in its registry's order
ARCH_IDS = ("deepseek-moe-16b", "recurrentgemma-9b", "xlstm-125m",
            "whisper-large-v3", "codeqwen1.5-7b", "h2o-danube-1.8b",
            "deepseek-v2-236b", "qwen2-0.5b", "granite-3-2b", "qwen2-vl-7b")

# archs allowed to run the long_500k decode shape (sub-quadratic or
# windowed attention)
LONG_CONTEXT_ARCHS = ("recurrentgemma-9b", "xlstm-125m", "h2o-danube-1.8b")


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


def shape_applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True


__all__ = ["ARCH_IDS", "SHAPES", "InputShape", "LONG_CONTEXT_ARCHS",
           "get_config", "get_reduced", "shape_applicable"]
