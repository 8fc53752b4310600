"""Elastic re-sharding of a distributed H^2 operator (DESIGN.md §10), the
port of the reference's ``repro/core/repartition.py``.

When a rank is lost mid-solve the surviving ranks still hold every block
of the operator — the block-row partition is a pure reorganization of the
single-device ``H2Data``, so recovery is "invert the partition, partition
again onto the shrunk group":

    ``unpartition_h2``: ``(DistH2Shape, DistH2Data) -> (H2Shape, H2Data)``
    ``repartition_h2``: ``unpartition_h2`` then ``partition_h2`` at ``p'``

``repartition_h2`` therefore *reuses* ``partition_h2``'s plan
construction wholesale — per-level ``HaloPlan``s, marshaled slot
layouts, offsets/caps and the comm model for the new rank count all come
out of the same code path as a fresh partition, and the result is
bit-identical to ``partition_h2(shape, data, p')`` on the original
operator (``tests/test_torch_repartition.py`` asserts this).

The inversion leans on two invariants of ``halo.partition_level``:

  * the per-rank slab ``[p * nbmax, k, k]`` stores each rank's blocks as
    a prefix (``fill`` counts up from 0) in the original list order, and
    the original lists are (row, col)-sorted with block-row ownership
    monotone in the row index — so concatenating the rank prefixes
    reproduces the global (row, col)-sorted block list exactly;
  * the padded slot maps carry an explicit sentinel (``nbmax`` for the
    branch levels' ``pb_blk``, ``dense_count`` for the dense halo plan's
    ``diag_blk``/``off_blk``, of which every real block occupies exactly
    one slot), so the per-rank valid-prefix lengths are recoverable from
    the data itself — no side channel.

The int32 index arrays go through numpy on the host; the value slabs are
gathered on their own device (``index_select``), and every tensor of the
result is new: the stacked partition may be shared by other processes
(CUDA IPC) and is never written.  Top levels, transfer matrices and leaf
bases are copied verbatim; a symmetric operator keeps its one basis tree.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .dist import DistH2Data, DistH2Shape, partition_h2
from .structure import (H2Data, H2Shape, build_coupling_plan, remarshal,
                        shape_of)


def _slab_lists(sv: torch.Tensor, sr: np.ndarray, sc: np.ndarray,
                counts: np.ndarray, p: int, nloc: int, stride: int
                ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Concatenate per-rank slab prefixes back into the global
    (row, col)-sorted block list: local rows are rebased to global node
    indices (``+ d * nloc``); columns are already global.  The values are
    gathered on ``sv``'s device."""
    rows, cols, pos = [], [], []
    for d in range(p):
        sl = slice(d * stride, d * stride + int(counts[d]))
        rows.append(sr[sl].astype(np.int64) + d * nloc)
        cols.append(sc[sl].astype(np.int64))
        pos.append(np.arange(sl.start, sl.stop, dtype=np.int64))
    idx = torch.as_tensor(np.concatenate(pos), device=sv.device)
    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(cols).astype(np.int32),
            sv.index_select(0, idx))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def unpartition_h2(dshape: DistH2Shape, ddata: DistH2Data
                   ) -> Tuple[H2Shape, H2Data]:
    """Invert ``partition_h2``: gather the stacked ``[p*...]`` operator
    back into a single-device ``H2Data`` on the device it lies on.

    The returned data is fully usable — block lists, ``CouplingPlan`` and
    marshaled buffers are rebuilt, and the ``H2Shape`` is recovered via
    ``shape_of`` — so it can drive a single-device matvec directly or be
    re-partitioned onto any valid rank count.
    """
    p, lc, depth = dshape.p, dshape.lc, dshape.depth
    device = ddata.u_leaf.device
    sym = ddata.v_leaf is ddata.u_leaf and \
        all(a is b for a, b in zip(ddata.f_br, ddata.e_br)) and \
        all(a is b for a, b in zip(ddata.f_top, ddata.e_top))

    e: List[torch.Tensor] = []
    f: List[torch.Tensor] = []
    for l in range(depth + 1):
        src = (ddata.e_top, ddata.f_top) if l <= lc else \
            (ddata.e_br, ddata.f_br)
        i = l if l <= lc else l - lc
        e.append(src[0][i].clone())
        f.append(e[-1] if sym else src[1][i].clone())

    s: List[torch.Tensor] = []
    s_rows: List[np.ndarray] = []
    s_cols: List[np.ndarray] = []
    for l in range(lc):
        s.append(ddata.s_top[l].clone())
        s_rows.append(_host(ddata.s_top_rows[l]))
        s_cols.append(_host(ddata.s_top_cols[l]))
    for l in range(lc, depth + 1):
        i = l - lc
        nbmax = dshape.br_counts[i]
        pb = _host(ddata.pb_blk[i]).reshape(p, -1)
        counts = (pb != nbmax).sum(axis=1)
        r, c, v = _slab_lists(ddata.s_br[i], _host(ddata.s_br_rows[i]),
                              _host(ddata.s_br_cols[i]), counts, p,
                              dshape.nodes_local(l), nbmax)
        s.append(v)
        s_rows.append(r)
        s_cols.append(c)

    nbd = dshape.dense_count
    counts_d = (_host(ddata.hp_dense.diag_blk).reshape(p, -1)
                != nbd).sum(axis=1)
    off = _host(ddata.hp_dense.off_blk)
    if off.size:
        counts_d = counts_d + (off.reshape(p, -1) != nbd).sum(axis=1)
    d_rows, d_cols, dense = _slab_lists(
        ddata.dense, _host(ddata.d_rows), _host(ddata.d_cols), counts_d, p,
        dshape.leaves_per_dev, nbd)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    plan = build_coupling_plan(depth, s_rows, s_cols, d_rows, d_cols,
                               device=device)
    u_leaf = ddata.u_leaf.clone()
    data = H2Data(
        u_leaf=u_leaf, v_leaf=u_leaf if sym else ddata.v_leaf.clone(),
        e=e, f=f, s=s,
        s_rows=[i32(x) for x in s_rows], s_cols=[i32(x) for x in s_cols],
        dense=dense, d_rows=i32(d_rows), d_cols=i32(d_cols), plan=plan)
    data = remarshal(data)
    shape = shape_of(data, dshape.leaf_size, dshape.symmetric)
    return shape, data


def repartition_h2(dshape: DistH2Shape, ddata: DistH2Data, p_new: int,
                   device="cuda") -> Tuple[DistH2Shape, DistH2Data]:
    """Re-shard a distributed operator onto ``p_new`` ranks on ``device``.

    The shrink-remesh step of the elastic solve: on a rank loss the
    survivors call this with the scheduled surviving count (any power of
    two with ``log2(p_new) <= depth`` works, growth included) and get back
    a partition with freshly built ``HaloPlan``s, marshaled layouts, and
    comm-model statics for the new group — all via ``partition_h2``, so
    the remeshed operator is indistinguishable from one partitioned at
    ``p_new`` from scratch.
    """
    shape, data = unpartition_h2(dshape, ddata)
    return partition_h2(shape, data, p_new, device=device)
