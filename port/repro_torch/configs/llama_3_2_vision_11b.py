"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; gated cross-attention image layers every 5th layer (8 total).
The vision tower is a STUB: input_specs() provides precomputed patch
embeddings (B, 1600, d_model).  [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256,
    pattern=(StageSpec("attn_mlp", 4), StageSpec("cross_attn_mlp", 1)),
    n_units=8,
    rope_theta=500_000.0, n_image_tokens=1600,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        pattern=(StageSpec("attn_mlp", 2), StageSpec("cross_attn_mlp", 1)),
        n_units=2, n_image_tokens=16, dtype="float32")
