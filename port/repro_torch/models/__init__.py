"""Composable model stack for the assigned architectures (the port of
``repro.models``)."""

from .config import ModelConfig, StageSpec
from .model import (Model, decode_step, execution_runs, forward,
                    init_caches, init_params, loss_fn, param_shapes)

__all__ = ["ModelConfig", "StageSpec", "Model", "param_shapes",
           "init_params", "forward", "loss_fn", "decode_step", "init_caches",
           "execution_runs"]
