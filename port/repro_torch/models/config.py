"""Model configuration + the stage/pattern abstraction.

A model is: embedding -> [prologue blocks] -> (pattern of stages) x n_units
-> final norm -> lm head.  Each stage is a homogeneous run of one block type
with stacked ``(L, ...)`` params; heterogeneous stacks (xLSTM's mLSTM/sLSTM
mix, llama-vision's interleaved cross-attn) are patterns with several stages
per unit.  The configuration is pure data, the fields of the reference's
``repro.models.config``; ``param_count`` walks this package's own shape
tree.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["ModelConfig", "StageSpec"]


@dataclasses.dataclass(frozen=True)
class StageSpec:
    block: str      # attn_mlp | attn_moe | mla_moe | hybrid | mlstm | slstm | cross_attn_mlp
    layers: int     # layers of this block per pattern unit


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | audio | hybrid | ssm | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[StageSpec, ...]  # one unit
    n_units: int
    prologue: tuple[StageSpec, ...] = ()   # fixed depth (e.g. deepseek dense L0)

    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int | None = None           # sliding-window attention (tokens)
    global_attn_every: int = 0          # hymba: every k-th layer full attn
    norm_type: str = "rms"              # rms | ln
    act: str = "silu"                   # silu | gelu
    glu: bool = True                    # gated MLP (False = plain 2-matrix)
    parallel_block: bool = False        # command-r: attn + mlp in parallel
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_aux_coef: float = 0.01

    # SSM / mamba (hymba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                    # 0 -> d_model // 16

    # xLSTM
    mlstm_pf: int = 2                   # up-projection factor
    slstm_heads: int = 4

    # VLM
    n_image_tokens: int = 0
    # audio (musicgen): frontend stub feeds embeddings directly
    inputs_embeds: bool = False
    n_codebooks: int = 0

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # ---------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        per_unit = sum(s.layers for s in self.pattern)
        return sum(s.layers for s in self.prologue) + per_unit * self.n_units

    @property
    def sub_quadratic(self) -> bool:
        """Can this config serve 500k-token contexts? (window/SSM only)"""
        blocks = {s.block for s in self.pattern}
        if blocks <= {"mlstm", "slstm"}:
            return True
        if "hybrid" in blocks:
            return True
        return self.window is not None

    def scaled(self, n_units: int) -> "ModelConfig":
        """Depth-scaled copy (the roofline's depth-delta method)."""
        return dataclasses.replace(self, n_units=n_units)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D)."""
        from .layers import tree_leaves  # local import to avoid cycle
        from .model import param_shapes
        return sum(math.prod(s.shape)
                   for s in tree_leaves(param_shapes(self)))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        # subtract inactive expert params
        per_expert = 3 * self.d_model * self.moe_d_ff
        n_moe_layers = sum(s.layers for s in self.pattern
                           if s.block in ("attn_moe", "mla_moe")) * self.n_units
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return full - inactive
