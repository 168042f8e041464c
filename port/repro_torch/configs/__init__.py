"""Per-architecture configs (exact public dims) + registry."""

from .base import ARCHS, SHAPES, get_config, get_smoke_config, cells

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke_config", "cells"]
