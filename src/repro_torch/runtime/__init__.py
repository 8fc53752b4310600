"""Fault tolerance of the PyTorch port: ``fault`` (injection, retry,
breaker, straggler monitor, restart loop) and ``chaos`` (the elastic
solve's fault schedule and report)."""
