"""Config registry + the assignment's input-shape table.

Every architecture module exports CONFIG (exact public config) and
smoke_config() (reduced same-family config for CPU tests).  ``get_config``
resolves --arch ids.  The modules are pure data, the same as the
reference's ``repro.configs``.  Eight run on the ported blocks: the
``attn_mlp`` stacks (qwen2-0.5b, qwen2.5-14b, glm4-9b, command-r-plus-104b,
musicgen-large), mixtral-8x22b (``attn_moe``), deepseek-v2-lite-16b
(``mla_dense``, ``mla_moe``) and llama-3.2-vision-11b (``attn_mlp``,
``cross_attn_mlp``); hymba-1.5b and xlstm-1.3b name the recurrent blocks
that ROADMAP Queue 1 item 7d ports next.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from . import (command_r_plus_104b, deepseek_v2_lite_16b, glm4_9b,
               hymba_1_5b, llama_3_2_vision_11b, mixtral_8x22b,
               musicgen_large, qwen2_0_5b, qwen2_5_14b, xlstm_1_3b)

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke_config", "ShapeSpec",
           "cells"]

ARCHS = [
    "command-r-plus-104b",
    "qwen2.5-14b",
    "glm4-9b",
    "qwen2-0.5b",
    "mixtral-8x22b",
    "deepseek-v2-lite-16b",
    "musicgen-large",
    "hymba-1.5b",
    "xlstm-1.3b",
    "llama-3.2-vision-11b",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


_MODULES = {
    "command-r-plus-104b": command_r_plus_104b,
    "qwen2.5-14b": qwen2_5_14b,
    "glm4-9b": glm4_9b,
    "qwen2-0.5b": qwen2_0_5b,
    "mixtral-8x22b": mixtral_8x22b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "musicgen-large": musicgen_large,
    "hymba-1.5b": hymba_1_5b,
    "xlstm-1.3b": xlstm_1_3b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k dense KV out of scope "
                       "(DESIGN.md §Arch-applicability)")
    return True, ""


def cells():
    """All 40 (arch, shape) cells with applicability flags."""
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
