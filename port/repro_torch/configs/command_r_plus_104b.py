"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000; GQA, no-bias, parallel attn+FFN block, LayerNorm,
tied embeddings.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000,
    pattern=(StageSpec("attn_mlp", 1),), n_units=64,
    norm_type="ln", parallel_block=True, tie_embeddings=True,
    rope_theta=75_000_000.0, qkv_bias=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        n_units=2, dtype="float32")
