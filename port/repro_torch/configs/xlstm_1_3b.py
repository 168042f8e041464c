"""xlstm-1.3b [ssm] — 48 blocks d_model=2048 4H vocab=50304; xLSTM[7:1]
(7 mLSTM : 1 sLSTM per unit, 6 units), mLSTM projection factor 2, d_ff=0
(the cells carry their own up/down projections).  Recurrent O(1) decode
state => long_500k runs.  [arXiv:2405.04517; unverified]"""

import dataclasses
from repro_torch.models.config import ModelConfig, StageSpec

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    pattern=(StageSpec("mlstm", 7), StageSpec("slstm", 1)), n_units=6,
    mlstm_pf=2, slstm_heads=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, d_model=64, n_heads=4, n_kv_heads=4, vocab=256,
        pattern=(StageSpec("mlstm", 2), StageSpec("slstm", 1)), n_units=2,
        dtype="float32")
