"""Checkpoints (the port of ``repro.checkpoint``)."""
