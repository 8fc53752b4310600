"""Parallelism of the port: the sharding rules and the sharded model
run's context (``sharding``) and the collectives autograd can
differentiate (``collectives``)."""
