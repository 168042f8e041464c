"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936; GQA, QKV bias, tied embeddings.  [arXiv:2407.10671; hf]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151936,
    pattern=(StageSpec("attn_mlp", 1),), n_units=24,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=112, n_heads=14, n_kv_heads=2, d_ff=256, vocab=512,
        n_units=2, dtype="float32")
