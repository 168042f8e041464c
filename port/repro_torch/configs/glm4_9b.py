"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552; RoPE, GQA, QKV bias (per HF config).  [hf:THUDM/glm-4-9b; hf]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552,
    pattern=(StageSpec("attn_mlp", 1),), n_units=40,
    qkv_bias=True, rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        n_units=2, dtype="float32")
