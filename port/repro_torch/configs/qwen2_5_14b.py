"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; GQA with QKV bias, RMSNorm, SwiGLU.  [hf:Qwen/Qwen2.5; hf]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064,
    pattern=(StageSpec("attn_mlp", 1),), n_units=48,
    qkv_bias=True, rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        n_units=2, dtype="float32")
