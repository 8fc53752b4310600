"""Collectives of the distributed H^2 operations over ``torch.distributed``.

The port's counterpart of ``shard_map``'s collectives: ``Comm`` wraps one
process group and offers the three the distributed HGEMV and
recompression use -- a tiled ``all_gather`` (``lax.all_gather(...,
tiled=True)``), ``ppermute`` (``lax.ppermute``) and ``all_to_all`` on the
``[p, capmax]`` row layout (``lax.all_to_all``, split and concat on axis
0) -- each also in an async form that returns a ``Pending`` handle, so the
§4.2 schedule can issue every exchange, compute, and only then wait; and
the distributed solvers' ``psum`` (``lax.psum``), a sum in rank order that
gives every rank the same bits; and ``broadcast`` and ``scatter``, with
which the threaded solver service's rank 0 hands every rank its boundary
decision and the admitted right-hand sides' rows; and the sharded
language models' ``reduce_scatter`` (``lax.psum_scatter``) and ``pmax``.
``rank`` is the counterpart of ``lax.axis_index``.

The transport is chosen once, from the group's backend:

- ``nccl`` moves device tensors as they are;
- ``gloo`` moves host tensors, so a CUDA payload is copied to a pinned host
  buffer before the collective and back to the card after it
  (``staged_bytes`` counts both copies).  On one card the distributed
  phase runs on gloo: NCCL refuses two ranks on one device.

``recv_bytes`` counts the bytes each collective brought to this rank over
the wire (a rank's own slice of a gather or all-to-all is not counted),
the quantity ``dist.matvec_comm_bytes`` models; ``recv_by_kind`` splits
them by collective kind under the reference's HLO names (``all-gather``,
``collective-permute``, ``all-to-all``, ``reduce-scatter``, and
``all-reduce`` for ``psum`` and ``pmax``),
which ``perf.comm_cost`` reads; ``broadcast`` and ``scatter`` count under
the kind their caller names.  ``out_by_kind`` counts, by the same kinds,
the bytes of each collective's OUTPUT on this rank, the reference's
``hlo_cost.collective_bytes`` measure: an all-gather's gathered tensor,
an all-reduce's reduced tensor (not the gathered partials), a
reduce-scatter's block, an all-to-all's buffer, a permute's landed
tensor, a broadcast's tensor and a scatter's part.

``DryComm`` is a ``Comm`` with no process group: rank ``r`` of ``p``,
whose collectives return uninitialised tensors of the landed shapes
(``meta`` ones in a dry run) and count both measures exactly as ``Comm``
does, so one rank's program can be walked without the others.

``mesh_comm`` lays the world out as the reference's 2D ``(blk, nv)`` mesh
(``make_dist_matvec(..., nv_axis=)``) and gives a rank its ``Comm`` over
its block-row group: the collectives of the distributed HGEMV run along
``blk`` alone.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Pending:
    """An issued collective; ``wait()`` returns the landed tensor on the
    payload's device."""

    def __init__(self, works: List, landed: torch.Tensor,
                 finish: Callable[[torch.Tensor], torch.Tensor],
                 sent: Optional[torch.Tensor] = None):
        self._works = works
        self._landed = landed
        self._finish = finish
        self._sent = sent          # the send buffer lives until the wait

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._finish(self._landed)


class Comm:
    """One process group: ``rank``, ``p`` and byte-counted collectives."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.p = dist.get_world_size(self.group)
        self.backend = str(dist.get_backend(self.group))
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"unsupported process-group backend "
                             f"{self.backend!r}")
        self.host_staged = self.backend == "gloo"
        # point-to-point ops name their peer by its rank in the world
        self._world_rank = (lambda r: r) if self.group is dist.group.WORLD \
            else (lambda r: dist.get_global_rank(self.group, r))
        self.reset_counts()

    def reset_counts(self) -> None:
        self.recv_bytes = 0
        self.recv_by_kind: Dict[str, int] = {}
        self.out_by_kind: Dict[str, int] = {}
        self.staged_bytes = 0

    def _count(self, kind: str, nbytes: int) -> None:
        self.recv_bytes += nbytes
        self.recv_by_kind[kind] = self.recv_by_kind.get(kind, 0) + nbytes

    def _count_out(self, kind: str, nbytes: int) -> None:
        self.out_by_kind[kind] = self.out_by_kind.get(kind, 0) + nbytes

    def _gathered(self, x: torch.Tensor, kind: str) -> None:
        """The counts of a tiled gather of ``x``; under ``all-reduce``
        (``psum``, ``pmax``: one partial per rank) the output is the
        reduced tensor, one partial's size."""
        n = x.numel() * x.element_size()
        self._count(kind, (self.p - 1) * n)
        self._count_out(kind, n if kind == "all-reduce" else self.p * n)

    def _exchanged(self, buf: torch.Tensor, kind: str) -> None:
        """The counts of an all-to-all of ``[p, ...]`` rows; under
        ``reduce-scatter`` the output is one block."""
        row = buf[0].numel() * buf.element_size()
        self._count(kind, (self.p - 1) * row)
        self._count_out(kind, row if kind == "reduce-scatter"
                        else self.p * row)

    # -- transport -------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend moves: a pinned host copy of a CUDA
        payload under gloo, the payload itself otherwise."""
        if self.host_staged and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            self.staged_bytes += t.numel() * t.element_size()
            return host
        return t.contiguous()

    def _empty_wire(self, shape: Tuple[int, ...], like: torch.Tensor
                    ) -> torch.Tensor:
        if self.host_staged and like.is_cuda:
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _finisher(self, like: torch.Tensor
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
        if self.host_staged and like.is_cuda:
            def back(t: torch.Tensor) -> torch.Tensor:
                self.staged_bytes += t.numel() * t.element_size()
                return t.to(like.device)
            return back
        return lambda t: t

    # -- collectives -------------------------------------------------------

    def all_gather_async(self, x: torch.Tensor, kind: str = "all-gather"
                         ) -> Pending:
        """Tiled gather along axis 0: ``[n, ...] -> [p*n, ...]``, rank
        order.  ``kind``: the name its bytes are counted under."""
        src = self._wire(x)
        out = self._empty_wire((self.p * x.shape[0], *x.shape[1:]), x)
        with warnings.catch_warnings():
            # torch >= 2.13 names it all_gather_single; the card's 2.11
            # has only this name
            warnings.simplefilter("ignore", FutureWarning)
            work = dist.all_gather_into_tensor(out, src, group=self.group,
                                               async_op=True)
        self._gathered(x, kind)
        return Pending([work], out, self._finisher(x), src)

    def all_gather(self, x: torch.Tensor, kind: str = "all-gather"
                   ) -> torch.Tensor:
        return self.all_gather_async(x, kind).wait()

    def ppermute_async(self, x: torch.Tensor,
                       perm: Sequence[Tuple[int, int]], tag: int = 0
                       ) -> Pending:
        """``lax.ppermute``: rank ``src`` of each ``(src, dst)`` pair sends
        ``x`` to ``dst``; a rank that no pair sends to receives zeros.
        ``tag`` tells apart permutes in flight between the same pair."""
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        out = self._empty_wire(tuple(x.shape), x)
        if not src:
            out.zero_()
        sent = self._wire(x) if dst else None
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, sent, self._world_rank(dst[0]),
                                  group=self.group, tag=tag))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, self._world_rank(src[0]),
                                  group=self.group, tag=tag))
        self._permuted(x, bool(src))
        works = dist.batch_isend_irecv(ops) if ops else []
        return Pending(works, out, self._finisher(x), sent)

    def _permuted(self, x: torch.Tensor, received: bool) -> None:
        n = x.numel() * x.element_size()
        if received:
            self._count("collective-permute", n)
        self._count_out("collective-permute", n)

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]],
                 tag: int = 0) -> torch.Tensor:
        return self.ppermute_async(x, perm, tag).wait()

    def all_to_all_async(self, buf: torch.Tensor, kind: str = "all-to-all"
                         ) -> Pending:
        """``[p, capmax]`` rows: row ``q`` goes to rank ``q``; landed row
        ``s`` came from rank ``s``.  ``kind``: the name its bytes are
        counted under."""
        if buf.shape[0] != self.p:
            raise ValueError(f"all_to_all buffer has {buf.shape[0]} rows, "
                             f"group has {self.p} ranks")
        src = self._wire(buf)
        out = self._empty_wire(tuple(buf.shape), buf)
        work = dist.all_to_all_single(out, src, group=self.group,
                                      async_op=True)
        self._exchanged(buf, kind)
        return Pending([work], out, self._finisher(buf), src)

    def all_to_all(self, buf: torch.Tensor, kind: str = "all-to-all"
                   ) -> torch.Tensor:
        return self.all_to_all_async(buf, kind).wait()

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum of every rank's ``x``, of which this rank keeps block
        ``rank`` of ``p`` along ``dim`` (``lax.psum_scatter(...,
        tiled=True)``).  Gloo has no reduce-scatter of CUDA tensors, so
        the blocks travel all-to-all and each rank adds the ``p`` landed
        blocks in rank order; its bytes count as ``reduce-scatter``."""
        if self.p == 1:
            return x
        n = x.shape[dim]
        if n % self.p:
            raise ValueError(f"reduce_scatter: dim {dim} ({n}) does not "
                             f"split over {self.p} ranks")
        xt = x.movedim(dim, 0)
        buf = xt.reshape(self.p, n // self.p, *xt.shape[1:])
        parts = self.all_to_all(buf, "reduce-scatter")
        out = parts[0]
        for q in range(1, self.p):
            out = out + parts[q]
        return out.movedim(0, dim)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.pmax``: the elementwise maximum over the ranks, the same
        bits on every rank; its bytes count as ``all-reduce``."""
        if self.p == 1:
            return t
        return self.all_gather(t.reshape(1, *t.shape), "all-reduce").amax(0)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the sum of every rank's ``t``, the same bits on
        every rank.  Each rank gathers all partials and adds them in rank
        order itself: a solver's host reads a flag computed from such sums
        once a segment, and ranks that read different flags would leave
        the loop at different segments and hang (an ``all_reduce``
        promises no bitwise agreement across ranks).  Its bytes count as
        ``all-reduce``: the ``(p-1)`` partials are the reference's
        all-reduce wire factor."""
        if self.p == 1:
            return t
        parts = self.all_gather(t.reshape(1, *t.shape), "all-reduce")
        out = parts[0]
        for q in range(1, self.p):
            out = out + parts[q]
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0,
                  kind: str = "broadcast") -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (every rank passes a tensor
        of the same shape and dtype; only ``src``'s values are read).  Its
        bytes count under ``kind`` on the ranks that received them."""
        wire = self._wire(t)
        dist.broadcast(wire, self._world_rank(src), group=self.group)
        self._broadcast_counts(t, src, kind)
        return self._finisher(t)(wire)

    def _broadcast_counts(self, t: torch.Tensor, src: int, kind: str
                          ) -> None:
        n = t.numel() * t.element_size()
        if self.rank != src:
            self._count(kind, n)
        self._count_out(kind, n)

    def scatter(self, t: Optional[torch.Tensor], shape: Tuple[int, ...],
                like: torch.Tensor, src: int = 0, kind: str = "scatter"
                ) -> torch.Tensor:
        """Rank ``src``'s ``t[q]`` on rank ``q``: ``src`` passes ``t`` of
        shape ``[p, *shape]``, the other ranks None.  Returns this rank's
        part, of ``like``'s dtype and on its device.  Its bytes count under
        ``kind`` on the ranks that received them."""
        out = self._empty_wire(tuple(shape), like)
        parts = None
        if self.rank == src:
            self._check_scatter(t, shape)
            parts = list(self._wire(t.to(like.dtype)).unbind(0))
        dist.scatter(out, parts, src=self._world_rank(src), group=self.group)
        self._broadcast_counts(out, src, kind)
        return self._finisher(like)(out)

    def _check_scatter(self, t: torch.Tensor, shape: Tuple[int, ...]
                       ) -> None:
        if tuple(t.shape) != (self.p, *shape):
            raise ValueError(f"scatter of {tuple(t.shape)}, expected "
                             f"{(self.p, *shape)}")

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class DryComm(Comm):
    """A ``Comm`` with no process group: rank ``rank`` of ``p``.  Every
    collective returns an uninitialised tensor of the landed shape on the
    payload's device (``meta`` in a dry run) and counts ``recv_by_kind``
    and ``out_by_kind`` under the same kinds and rules as ``Comm``;
    ``psum``, ``pmax`` and ``reduce_scatter`` run ``Comm``'s own code over
    these.  Nothing is sent, so one rank's program can be walked alone."""

    def __init__(self, rank: int, p: int):
        if not 0 <= rank < p:
            raise ValueError(f"rank {rank} outside a group of {p}")
        self.group = None
        self.rank, self.p = int(rank), int(p)
        self.backend = "dry"
        self.host_staged = False
        self.reset_counts()

    @staticmethod
    def _landed(t: torch.Tensor) -> Pending:
        return Pending([], t, lambda x: x)

    def all_gather_async(self, x, kind: str = "all-gather") -> Pending:
        self._gathered(x, kind)
        return self._landed(x.new_empty((self.p * x.shape[0],
                                         *x.shape[1:])))

    def ppermute_async(self, x, perm: Sequence[Tuple[int, int]],
                       tag: int = 0) -> Pending:
        received = any(d == self.rank for _, d in perm)
        self._permuted(x, received)
        return self._landed(x.new_empty(x.shape) if received
                            else x.new_zeros(x.shape))

    def all_to_all_async(self, buf, kind: str = "all-to-all") -> Pending:
        if buf.shape[0] != self.p:
            raise ValueError(f"all_to_all buffer has {buf.shape[0]} rows, "
                             f"group has {self.p} ranks")
        self._exchanged(buf, kind)
        return self._landed(buf.new_empty(buf.shape))

    def broadcast(self, t, src: int = 0, kind: str = "broadcast"):
        self._broadcast_counts(t, src, kind)
        return t.new_empty(t.shape)

    def scatter(self, t, shape: Tuple[int, ...], like, src: int = 0,
                kind: str = "scatter"):
        if self.rank == src:
            self._check_scatter(t, shape)
        out = like.new_empty(tuple(shape))
        self._broadcast_counts(out, src, kind)
        return out

    def barrier(self) -> None:
        pass


def mesh_comm(p_blk: int, p_nv: int) -> Tuple[Comm, int]:
    """This rank's place in a ``p_blk x p_nv`` mesh of the world's ranks.

    The ranks are laid out as ``jax.make_mesh((p_blk, p_nv))`` lays out
    devices: rank ``blk * p_nv + nv``.  The operator is replicated across
    ``nv`` and the vector batch sharded over it, so the ``p_blk`` ranks of
    one nv column form a block-row group.  Returns ``(comm, nv)``: this
    rank's ``Comm`` over its group (``comm.rank`` is its ``blk``) and its
    nv index.  Every rank creates every group, in the same order, as
    ``torch.distributed.new_group`` requires (a rank that skipped one
    would hang the others)."""
    world = dist.get_world_size()
    if world != p_blk * p_nv:
        raise ValueError(f"a {p_blk} x {p_nv} mesh needs {p_blk * p_nv} "
                         f"ranks, the world has {world}")
    nv = dist.get_rank() % p_nv
    groups = [dist.new_group([b * p_nv + c for b in range(p_blk)])
              for c in range(p_nv)]
    return Comm(groups[nv]), nv
