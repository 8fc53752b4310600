"""Core H^2 data model, construction, matvec and recompression (PyTorch)."""
