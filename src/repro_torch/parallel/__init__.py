"""Parallelism of the port: the sharding rules (``sharding``)."""
