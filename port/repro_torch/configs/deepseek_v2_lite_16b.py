"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff(moe)=1408
vocab=102400; MLA kv_lora=512 (rope 64, nope 128, v 128); first layer dense
(d_ff 10944), then 26 MoE layers: 64 routed experts top-6 + 2 shared.
[arXiv:2405.04434; hf]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944, vocab=102400,
    prologue=(StageSpec("mla_dense", 1),),
    pattern=(StageSpec("mla_moe", 1),), n_units=26,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        n_units=2, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=64,
        dtype="float32")
