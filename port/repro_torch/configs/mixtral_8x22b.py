"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
    pattern=(StageSpec("attn_moe", 1),), n_units=56,
    n_experts=8, top_k=2, moe_d_ff=16384,
    window=4096, rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        n_units=2, n_experts=4, top_k=2, moe_d_ff=256, window=64,
        dtype="float32")
