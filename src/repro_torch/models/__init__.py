"""repro_torch.models — the dense LM on the paged serving path."""
