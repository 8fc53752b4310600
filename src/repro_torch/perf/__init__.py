"""Cost models: a dispatch-mode flop/byte walk and the collectives' counted
bytes (the reference's ``repro/perf``).

``op_cost.analyze`` models flops/bytes of one eager run (this rank's);
``comm_cost.collective_bytes`` measures the per-kind bytes this rank
received.  ``obs.metrics`` joins the two per phase.
"""
from repro_torch.perf import comm_cost, op_cost
from repro_torch.perf.comm_cost import collective_bytes
from repro_torch.perf.op_cost import analyze, count_ops

__all__ = ["op_cost", "comm_cost", "analyze", "count_ops",
           "collective_bytes"]
