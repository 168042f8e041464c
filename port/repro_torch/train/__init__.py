"""Training loop (the port of ``repro.train``)."""
