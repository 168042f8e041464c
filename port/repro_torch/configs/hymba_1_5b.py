"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads per block,
sliding-window attention (1024) so 500k decode is O(window + state).
Meta-tokens from the paper are omitted (DESIGN.md).  [arXiv:2411.13676; hf]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001,
    pattern=(StageSpec("hybrid", 1),), n_units=32,
    ssm_state=16, ssm_expand=2, window=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=100, n_heads=5, n_kv_heads=5, d_ff=256, vocab=512,
        n_units=2, ssm_state=8, window=32, dtype="float32")
