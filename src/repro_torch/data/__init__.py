"""The port's token pipeline (``pipeline``): deterministic, shardable
batches, plain numpy as the reference's."""
