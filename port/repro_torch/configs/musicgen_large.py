"""musicgen-large [audio] — 48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048;
decoder-only over EnCodec tokens.  The EnCodec frontend is a STUB:
input_specs() provides precomputed frame embeddings (4 codebooks summed
upstream); the head predicts one 2048-way codebook distribution.
[arXiv:2306.05284; hf]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048,
    pattern=(StageSpec("attn_mlp", 1),), n_units=48,
    norm_type="ln", act="gelu", glu=False,
    inputs_embeds=True, n_codebooks=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=128, n_heads=8, n_kv_heads=8, d_ff=256, vocab=128,
        n_units=2, dtype="float32")
