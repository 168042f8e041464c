"""repro_torch.launch — launchers (the port of ``repro.launch``; this
slice ports ``serve``)."""
