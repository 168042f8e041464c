"""Optimizer substrate (the port of ``repro.optim``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_state_shapes,
                    adamw_update, global_norm)
from .grad_compress import compressed_psum, dequantize_int8, quantize_int8
from .schedule import lr_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_state_shapes",
           "global_norm", "lr_schedule", "quantize_int8", "dequantize_int8",
           "compressed_psum"]
