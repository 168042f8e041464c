"""repro_torch.launch — launchers, step functions, layouts and the dry run
(the port of ``repro.launch``; see README.md)."""
