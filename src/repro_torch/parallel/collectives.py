"""Collectives over ``core.comm.Comm`` that autograd can differentiate:
the explicit form of the reference's sharding constraints, placed where
XLA's SPMD partitioner places a collective.

Every tensor of a sharded model run is held by each rank in one of two
gradient conventions:

* *full*: the rank's gradient is the whole gradient of its value (a
  replicated value computed the same way on every rank, or a rank's own
  block of a sharded value);
* *partial*: the rank's gradient is its own share, and the true gradient
  is the sum over the group (a replicated value that the ranks consume
  in split work, such as column-parallel products).

Each function converts between the two, and its backward is the
transposed collective:

==============================  ===============  =====================
function                        forward          backward
==============================  ===============  =====================
``all_gather(grad="sum")``      all-gather       reduce-scatter
``all_gather(grad="slice")``    all-gather       this rank's block
``reduce_scatter``              reduce-scatter   all-gather
``scatter``                     this rank's      all-gather
                                block
``copy_to``                     identity         psum
``reduce_from``                 psum             identity
``psum``                        psum             psum
==============================  ===============  =====================

A ``comm`` of one rank (or ``None``) makes each of them the identity.
``pmax`` carries no gradient.  The sums run in rank order
(``Comm.psum``), so a replicated result has the same bits on every rank
and every rank takes the same decisions from it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.comm import Comm


def _trivial(comm: Optional[Comm]) -> bool:
    return comm is None or comm.p == 1


def _gather(x: torch.Tensor, dim: int, comm: Comm) -> torch.Tensor:
    """The tiled gather of ``x`` along ``dim``, blocks in rank order."""
    out = comm.all_gather(x.movedim(dim, 0).contiguous())
    return out.movedim(0, dim)


def block(x: torch.Tensor, dim: int, p: int, r: int) -> torch.Tensor:
    """Block ``r`` of ``p`` equal blocks of ``x`` along ``dim``."""
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} ({n}) does not "
                         f"split into {p} blocks")
    return x.narrow(dim, r * (n // p), n // p)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm, rs):
        ctx.dim, ctx.comm, ctx.rs = dim, comm, rs
        return _gather(x, dim, comm)

    @staticmethod
    def backward(ctx, g):
        if ctx.rs:
            g = ctx.comm.reduce_scatter(g.contiguous(), ctx.dim)
        else:
            g = block(g, ctx.dim, ctx.comm.p, ctx.comm.rank).contiguous()
        return g, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm = dim, comm
        return comm.reduce_scatter(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.comm), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, comm):
        ctx.dim, ctx.comm = dim, comm
        return block(x, dim, comm.p, comm.rank).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.comm), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.psum(g.contiguous()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.psum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, dim: int, comm: Optional[Comm],
               grad: str = "sum") -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, gathered in rank order.
    ``grad="sum"``: the gathered value is consumed in split work, so its
    gradient is partial and the backward reduce-scatters it;
    ``grad="slice"``: its gradient is full and the backward keeps this
    rank's block."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice', got {grad!r}")
    if _trivial(comm):
        return x
    return _AllGather.apply(x, dim % x.dim(), comm, grad == "sum")


def reduce_scatter(x: torch.Tensor, dim: int, comm: Optional[Comm]
                   ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``
    (partial sums in, a sharded value out); backward: all-gather."""
    if _trivial(comm):
        return x
    return _ReduceScatter.apply(x, dim % x.dim(), comm)


def scatter(x: torch.Tensor, dim: int, comm: Optional[Comm]
            ) -> torch.Tensor:
    """This rank's block along ``dim`` of a replicated ``x`` whose
    gradient is full; backward: all-gather."""
    if _trivial(comm):
        return x
    return _Scatter.apply(x, dim % x.dim(), comm)


def copy_to(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """``x`` itself, entering split work: backward, the ranks' partial
    gradients are summed (Megatron's ``f``)."""
    if _trivial(comm):
        return x
    return _CopyTo.apply(x, comm)


def reduce_from(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """The sum of the ranks' partial ``x``, a replicated value whose
    gradient is full: backward, the identity (Megatron's ``g``)."""
    if _trivial(comm):
        return x
    return _ReduceFrom.apply(x, comm)


def psum(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """The sum of the ranks' partial ``x``, consumed in split work: psum
    forward and backward (``copy_to(reduce_from(x))``)."""
    return copy_to(reduce_from(x, comm), comm)


def pmax(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """The elementwise maximum over the ranks, detached."""
    x = x.detach()
    return x if _trivial(comm) else comm.pmax(x.contiguous())
