"""Flop and byte model of an eager PyTorch function, the port's
counterpart of the reference's ``repro/perf/jaxpr_cost.py``.

``count_ops(fn, *args)`` runs ``fn`` once under a ``TorchDispatchMode``
and charges every operator call it dispatches by the reference's rules:

  * flops -- ``2*M*N*K`` for the matrix products (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``matmul``, ``mv``, ``dot``; batch dimensions
    included: ``2 * numel(out) * K``); transcendentals
    ``TRANSCENDENTAL_WEIGHT`` per output element; reductions 1 per input
    element; ``sort``/``cumsum`` and the other scans 4 per input element;
    any other operation 1 per output element;
  * bytes -- operand bytes plus result bytes per call: an *unfused upper
    bound* on the memory traffic, as the reference's.

Copies, gathers, concatenations, comparisons, selects and fills cost bytes
only.  Views cost nothing (they move no bytes in eager PyTorch, where the
reference's reshapes are separate ops); ``empty`` allocations and the
``profiler::`` marks of ``obs.trace.phase`` cost nothing; ``c10d::``
collectives cost their buffers' bytes and no flops (``perf.comm_cost``
counts what crossed the wire).

Eager execution dispatches every iteration of a Python loop, so no
trip-count correction is needed: the counts are those of the run.  They are
this process's, i.e. one rank's; ``obs.metrics`` sums them over the ranks.

The hand-written kernels are called through ``ctypes`` and never reach the
dispatcher, so a kernel's work would count as zero.  ``analyze`` therefore
walks the plain backend (``backend="torch"``) and raises if the launch
tally of ``kernels/ops.py`` moves during the walk.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

TRANSCENDENTAL_WEIGHT = 4      # exp/log/tanh/erf cost in flop units

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "matmul", "mv", "dot", "addmv",
           "vdot", "addbmm"}
# the operand whose last axis is contracted: the first matrix argument
_MATMUL_LHS = {"addmm": 1, "baddbmm": 1, "addmv": 1, "addbmm": 1}
_TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "erf", "rsqrt", "sqrt",
                   "sin", "cos", "pow", "log1p", "expm1", "exp2", "log2",
                   "log10"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "any", "all", "prod", "norm", "linalg_vector_norm", "nansum",
           "std", "var", "logsumexp", "count_nonzero"}
_SCAN = {"sort", "cumsum", "cumprod", "cummax", "cummin", "topk", "argsort",
         "logcumsumexp"}
# views the dispatcher does not flag as such
_VIEWS = {"_unsafe_view", "_reshape_alias"}
_BYTES_ONLY = {
    "copy", "clone", "_to_copy", "cat", "stack", "index_select", "gather",
    "scatter", "scatter_add", "index", "index_put", "index_add",
    "index_copy", "slice_scatter", "select_scatter", "constant_pad_nd",
    "flip", "roll", "repeat", "repeat_interleave", "eq", "ne", "lt", "gt",
    "le", "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "where", "sign", "fill",
    "zero", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "arange", "masked_fill",
    "contiguous", "lift_fresh", "detach", "alias"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _numel(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def op_cost(func, args, kwargs, out) -> Dict[str, float]:
    """Flops and bytes of one dispatched call ``func(*args, **kwargs) ->
    out`` (the module docstring's rules)."""
    ns = func.namespace
    name = func.overloadpacket.__name__.rstrip("_")
    if ns == "profiler" or (ns == "aten" and (
            func.is_view or name in _VIEWS or name.startswith("empty"))):
        return {"flops": 0.0, "bytes": 0.0}
    io = float(_nbytes((args, kwargs)) + _nbytes(out))
    if ns == "c10d" or name in _BYTES_ONLY:
        return {"flops": 0.0, "bytes": io}
    if name in _MATMUL:
        lhs = args[_MATMUL_LHS.get(name, 0)]
        return {"flops": 2.0 * _numel(out) * lhs.shape[-1], "bytes": io}
    if name in _TRANSCENDENTAL:
        return {"flops": float(TRANSCENDENTAL_WEIGHT * _numel(out)),
                "bytes": io}
    if name in ("max", "min") and func._overloadname == "other":
        return {"flops": float(_numel(out)), "bytes": io}
    if name in _REDUCE:
        return {"flops": float(args[0].numel()), "bytes": io}
    if name in _SCAN:
        return {"flops": 4.0 * args[0].numel(), "bytes": io}
    return {"flops": float(_numel(out)), "bytes": io}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.per_op: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cost = op_cost(func, args, kwargs, out)
        key = f"{func.namespace}::{func.overloadpacket.__name__}"
        rec = self.per_op.setdefault(key, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += cost["flops"]
        rec["bytes"] += cost["bytes"]
        return out


def _launches() -> int:
    from repro_torch.kernels import ops
    return sum(ops.launch_counts().values())


def count_ops(fn: Callable, *args) -> Dict[str, Dict[str, float]]:
    """Run ``fn(*args)`` once; per dispatched operator
    (``namespace::name``) its ``calls``, ``flops`` and ``bytes``.  Raises
    ``RuntimeError`` when ``fn`` launched a hand-written kernel (its work
    would be missing): call it on the plain backend."""
    before = _launches()
    counter = _Counter()
    with counter:
        fn(*args)
    moved = _launches() - before
    if moved:
        raise RuntimeError(
            f"{moved} hand-written kernel launch(es) during the cost walk: "
            f"their work never reaches the dispatcher and would count as "
            f"zero; walk the plain backend (backend='torch')")
    return counter.per_op


def analyze(fn: Callable, *args) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of one run of ``fn(*args)`` on this process
    (``count_ops`` summed)."""
    per_op = count_ops(fn, *args)
    return {"flops": sum(r["flops"] for r in per_op.values()),
            "bytes": sum(r["bytes"] for r in per_op.values())}


def matmul_flops(per_op: Dict[str, Dict[str, float]]) -> float:
    """The matrix products' share of ``count_ops``'s flops (the
    reference's ``dot_general`` flops)."""
    return sum(r["flops"] for k, r in per_op.items()
               if k.split("::")[-1] in _MATMUL)
