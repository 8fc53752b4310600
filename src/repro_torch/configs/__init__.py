"""Model configurations (``base.get_config``): shapes only, no weights."""
