"""Deterministic host data pipeline (the port of ``repro.data``)."""
