"""Observability for the PyTorch port: phase annotation (``trace``) and
Chrome-trace export (``export``)."""
