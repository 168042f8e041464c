"""Composable model stack for the assigned architectures (the port of
``repro.models``; ``loss_fn`` comes with the training slice)."""

from .config import ModelConfig, StageSpec
from .model import (Model, decode_step, execution_runs, forward,
                    init_caches, init_params, param_shapes)

__all__ = ["ModelConfig", "StageSpec", "Model", "param_shapes",
           "init_params", "forward", "decode_step", "init_caches",
           "execution_runs"]
