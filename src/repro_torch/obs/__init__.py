"""Observability for the PyTorch port (phase annotation only)."""
