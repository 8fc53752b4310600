"""Runners of the benchmark's cells, one per operation of the port; a
traffic file's ``op`` names its runner.  Only these modules call
``repro_torch``."""
