"""repro_torch.serving — the LM serving engine and its Bourbon session
index (the port of ``repro.serving``)."""
