"""Distributed H^2 HGEMV and recompression over ``torch.distributed``
(paper §2.2–§5), port of the matvec and compression parts of
``repro/core/dist.py``.

Every tree level is a block-sparse matrix decomposed into block rows; rank
``r`` owns a contiguous branch of the cluster tree below the C-level
``lc = log2(p)``.  As in the reference, the (tiny) top tree is replicated:
branch roots are gathered at the C-level and every rank computes the top
sweeps itself, instead of a master rank owning them.

``partition_h2`` lays the operator out as stacked ``[p*...]`` arrays on
one device; ``local_shard`` gives rank ``r`` its views (the counterpart of
``shard_map``'s in_specs).  ``make_dist_matvec`` and
``make_dist_compress`` return per-rank callables over a ``Comm``.

Communication modes of the off-diagonal coupling phase (paper §4.1):
  - ``allgather``: gather the whole level (baseline, maximal volume)
  - ``ppermute``: broadcast halo -- every rank's entire level ``2*rad``
    times
  - ``halo-plan`` (default): the compressed-plan exchange (``halo.py``):
    only the nodes remote coupling rows reference, packed by one
    ``halo_pack`` launch into one payload per neighbour offset, one
    permute each, all issued before the diagonal products (§4.2 overlap).
    ``hide_flops > 0`` merges every offset into ONE all-to-all (the
    solver lowering).  ``-bf16`` suffixes halve the payload.

The products are plain PyTorch (the reference leaves them to XLA as
einsums); the send packing runs the ``halo_pack`` kernel and the
compression's QRs and SVDs the ``batched_qr``/``batched_svd`` kernels when
``backend="cuda"`` and the tensors are on the card.

The 2D mesh (the reference's ``nv_axis``): ``p_blk * p_nv`` ranks, the
vector batch sharded over ``nv`` and the operator replicated across it
(``comm.mesh_comm`` gives a rank its block-row ``Comm``).  A rank runs
``make_dist_matvec`` over that ``Comm`` on its ``[n_local, nv / p_nv]``
slice (``mesh_slice``); ``mesh_join`` puts the result back together.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.halo_pack import PackPlan, Segment
from repro_torch.obs.trace import phase

from . import halo as _halo
from .comm import Comm
from .compression import truncation_inner_factors, truncation_leaf_factors, \
    truncation_project
from .halo import HaloPlan, partition_level
from .structure import H2Data, H2Shape, build_slot_plan, marshal_blocks

COMMS = ("allgather", "ppermute", "halo-plan", "ppermute-bf16",
         "halo-plan-bf16")
SCHEDULES = ("auto", "overlap", "fused")


# ---------------------------------------------------------------------------
# static distributed shape + runtime data
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistH2Shape:
    """Static description of a block-row-partitioned H^2 matrix."""
    n: int
    leaf_size: int
    depth: int
    ranks: Tuple[int, ...]
    p: int                                # number of block rows (ranks)
    lc: int                               # C-level = log2(p)
    # branch levels lc..depth: per-rank padded block count and halo radius
    br_counts: Tuple[int, ...]            # indexed l-lc
    br_radius: Tuple[int, ...]            # rank-distance halo radius
    # top levels 0..lc-1: replicated global block counts
    top_counts: Tuple[int, ...]
    dense_count: int                      # per-rank padded dense blocks
    dense_radius: int
    row_maxb: Tuple[int, ...]             # max blocks/row (levels 0..depth)
    symmetric: bool = True
    dense_maxb: int = 1                   # max dense blocks per leaf row
    # compressed halo plan statics: per branch level, the sorted nonzero
    # rank offsets of the block list and the packed send-row caps
    br_offsets: Tuple[Tuple[int, ...], ...] = ()
    br_caps: Tuple[Tuple[int, ...], ...] = ()
    dense_offsets: Tuple[int, ...] = ()
    dense_caps: Tuple[int, ...] = ()

    @property
    def leaves_per_dev(self) -> int:
        return (1 << self.depth) // self.p

    def nodes_local(self, l: int) -> int:
        return (1 << l) // self.p if l >= self.lc else (1 << l)

    def n_local(self) -> int:
        return self.n // self.p


@dataclasses.dataclass
class DistH2Data:
    """Runtime tensors; the leading axis of the sharded fields is ``p*``
    (rank-major), the top-level fields are replicated.

    Branch lists are indexed ``l - lc``; top lists are indexed ``l``.
    ``pb_blk``/``pb_col`` are the branch levels' ``slot -> local slab
    block`` / ``slot -> GLOBAL source node`` plans over the local ``nloc x
    maxb`` slot layout and ``s_br_mar`` the row-marshaled blocks
    ``[p*nloc, k, maxb*k]``; ``hp_br``/``hp_dense`` the compressed halo
    plans with the diag/off marshaled twins.  A symmetric operator keeps
    one basis tree: ``v_leaf is u_leaf`` and ``f_br[i] is e_br[i]``.
    """
    u_leaf: torch.Tensor                  # [p*nl_loc, m, k]
    v_leaf: torch.Tensor
    e_br: List[torch.Tensor]              # l=lc..depth; e_br[0] is empty
    f_br: List[torch.Tensor]
    s_br: List[torch.Tensor]              # [p*nbmax_l, k, k]
    s_br_rows: List[torch.Tensor]         # local row node index  [p*nbmax_l]
    s_br_cols: List[torch.Tensor]         # GLOBAL col node index [p*nbmax_l]
    e_top: List[torch.Tensor]             # l=0..lc (replicated); [0] empty
    f_top: List[torch.Tensor]
    s_top: List[torch.Tensor]             # l=0..lc-1 (replicated)
    s_top_rows: List[torch.Tensor]
    s_top_cols: List[torch.Tensor]
    dense: torch.Tensor                   # [p*nbd_max, m, m]
    d_rows: torch.Tensor
    d_cols: torch.Tensor
    pb_blk: List[torch.Tensor]            # [p*nloc_l*maxb_l] int32, pad nbmax
    pb_col: List[torch.Tensor]            # [p*nloc_l*maxb_l] int32 global col
    s_br_mar: List[torch.Tensor]          # [p*nloc_l, k, maxb_l*k]
    pt_blk: List[torch.Tensor]            # l=0..lc-1 (replicated)
    pt_col: List[torch.Tensor]
    s_top_mar: List[torch.Tensor]         # [2**l, k, maxb_l*k]
    pd_col: torch.Tensor                  # [p*nl_loc*dmaxb] int32 global col
    dense_mar: torch.Tensor               # [p*nl_loc, m, dmaxb*m]
    hp_br: List[HaloPlan]                 # l=lc..depth
    hp_dense: HaloPlan
    s_br_mar_diag: List[torch.Tensor]     # [p*nloc_l, k, maxb_d_l*k]
    s_br_mar_off: List[torch.Tensor]      # [p*n_bnd_cap_l, k, maxb_o_l*k]
    dense_mar_diag: torch.Tensor          # [p*nl_loc, m, dmaxb_d*m]
    dense_mar_off: torch.Tensor           # [p*doff_cap, m, dmaxb_o*m]


# fields of DistH2Data that are replicated (every other field is sharded)
REPLICATED = ("e_top", "f_top", "s_top", "s_top_rows", "s_top_cols",
              "pt_blk", "pt_col", "s_top_mar")


def _shard(t: torch.Tensor, rank: int, p: int) -> torch.Tensor:
    n = t.shape[0] // p
    return t[rank * n:(rank + 1) * n]


def local_shard(dshape: DistH2Shape, ddata: DistH2Data, rank: int
                ) -> DistH2Data:
    """Rank ``rank``'s views of the stacked layout (no copies): sharded
    fields cut to the rank's block rows, replicated fields whole."""
    p = dshape.p

    def cut(x):
        if isinstance(x, HaloPlan):
            return HaloPlan(send=[_shard(s, rank, p) for s in x.send],
                            **{f: _shard(getattr(x, f), rank, p)
                               for f in _halo.PLAN_FIELDS})
        if isinstance(x, list):
            return [cut(v) for v in x]
        return _shard(x, rank, p)

    out = {}
    for f in dataclasses.fields(DistH2Data):
        v = getattr(ddata, f.name)
        out[f.name] = v if f.name in REPLICATED else cut(v)
    d = DistH2Data(**out)
    if ddata.v_leaf is ddata.u_leaf:                 # keep the alias
        d.v_leaf = d.u_leaf
    if all(a is b for a, b in zip(ddata.f_br, ddata.e_br)):
        d.f_br = list(d.e_br)
    return d


def mesh_slice(x: torch.Tensor, dshape: DistH2Shape, rank: int, p_nv: int
               ) -> torch.Tensor:
    """Rank ``rank``'s ``[n_local, nv / p_nv]`` slice of ``x`` ``[N, nv]``
    on a ``p x p_nv`` mesh (rank ``blk * p_nv + nv``, ``P("blk", "nv")``)."""
    blk, c = divmod(rank, p_nv)
    nloc, w = dshape.n_local(), x.shape[-1] // p_nv
    if w * p_nv != x.shape[-1]:
        raise ValueError(f"nv={x.shape[-1]} is not a multiple of "
                         f"p_nv={p_nv}")
    return x[blk * nloc:(blk + 1) * nloc, c * w:(c + 1) * w]


def mesh_join(parts: Sequence[torch.Tensor], p_nv: int) -> torch.Tensor:
    """Inverse of ``mesh_slice``: ``[N, nv]`` from every rank's slice, in
    rank order."""
    return torch.cat([torch.cat(list(parts[b:b + p_nv]), dim=-1)
                      for b in range(0, len(parts), p_nv)], dim=0)


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

def partition_h2(shape: H2Shape, data: H2Data, p: int, device="cuda"
                 ) -> Tuple[DistH2Shape, DistH2Data]:
    """Reorganize a single-device operator into the block-row layout on
    ``device``.  Host numpy builds the int32 plans; the value buffers are
    gathered on the device from the operator's blocks."""
    lc = int(np.log2(p))
    if (1 << lc) != p:
        raise ValueError("rank count must be a power of two")
    if shape.depth < lc:
        raise ValueError(f"tree depth {shape.depth} < log2(P)={lc}")
    device = torch.device(device)
    depth, m = shape.depth, shape.leaf_size
    sym = data.v_leaf is data.u_leaf and all(
        a is b for a, b in zip(data.f, data.e))

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    def host(t):
        return t.detach().cpu().numpy()

    def dev(t):
        return t.to(device)

    lps = [partition_level(host(data.s_rows[l]), host(data.s_cols[l]),
                           dev(data.s[l]), p, l - lc)
           for l in range(lc, depth + 1)]
    ld = partition_level(host(data.d_rows), host(data.d_cols),
                         dev(data.dense), p, depth - lc)

    # replicated top levels: the global slot plan + marshaled blocks
    pt_blk, pt_col, s_top_mar = [], [], []
    for l in range(lc):
        b_, c_, _, _ = build_slot_plan(host(data.s_rows[l]),
                                       host(data.s_cols[l]), 1 << l)
        pt_blk.append(i32(b_))
        pt_col.append(i32(c_))
        s_top_mar.append(marshal_blocks(dev(data.s[l]), pt_blk[-1], 1 << l))

    dshape = DistH2Shape(
        n=shape.n, leaf_size=m, depth=depth, ranks=shape.ranks, p=p, lc=lc,
        br_counts=tuple(lp.nbmax for lp in lps),
        br_radius=tuple(lp.rad for lp in lps),
        top_counts=tuple(shape.coupling_counts[:lc]),
        dense_count=ld.nbmax, dense_radius=ld.rad,
        row_maxb=shape.row_maxb or tuple([0] * (depth + 1)),
        symmetric=shape.symmetric, dense_maxb=ld.pc.shape[0] >> depth,
        br_offsets=tuple(lp.offsets for lp in lps),
        br_caps=tuple(lp.caps for lp in lps),
        dense_offsets=ld.offsets, dense_caps=ld.caps)

    dtype = data.u_leaf.dtype
    e_br = [torch.zeros((p, 0, 0), dtype=dtype, device=device)] + \
        [dev(data.e[l]) for l in range(lc + 1, depth + 1)]
    f_br = list(e_br) if sym else \
        [e_br[0]] + [dev(data.f[l]) for l in range(lc + 1, depth + 1)]
    empty = torch.zeros((0, 0, 0), dtype=dtype, device=device)
    e_top = [empty] + [dev(data.e[l]) for l in range(1, lc + 1)]
    f_top = list(e_top) if sym else \
        [empty] + [dev(data.f[l]) for l in range(1, lc + 1)]
    u_leaf = dev(data.u_leaf)
    ddata = DistH2Data(
        u_leaf=u_leaf, v_leaf=u_leaf if sym else dev(data.v_leaf),
        e_br=e_br, f_br=f_br,
        s_br=[lp.sv for lp in lps],
        s_br_rows=[i32(lp.sr) for lp in lps],
        s_br_cols=[i32(lp.sc) for lp in lps],
        e_top=e_top, f_top=f_top,
        s_top=[dev(data.s[l]) for l in range(lc)],
        s_top_rows=[dev(data.s_rows[l]) for l in range(lc)],
        s_top_cols=[dev(data.s_cols[l]) for l in range(lc)],
        dense=ld.sv, d_rows=i32(ld.sr), d_cols=i32(ld.sc),
        pb_blk=[i32(lp.pb) for lp in lps],
        pb_col=[i32(lp.pc) for lp in lps],
        s_br_mar=[lp.sv_mar for lp in lps],
        pt_blk=pt_blk, pt_col=pt_col, s_top_mar=s_top_mar,
        pd_col=i32(ld.pc), dense_mar=ld.sv_mar,
        hp_br=[lp.plan(device) for lp in lps], hp_dense=ld.plan(device),
        s_br_mar_diag=[lp.sv_mar_diag for lp in lps],
        s_br_mar_off=[lp.sv_mar_off for lp in lps],
        dense_mar_diag=ld.sv_mar_diag, dense_mar_off=ld.sv_mar_off)
    return dshape, ddata


# ---------------------------------------------------------------------------
# distributed matvec (per rank)
# ---------------------------------------------------------------------------

def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``[n, k, j] @ [n, j, v]``."""
    return torch.matmul(a, b)


def _pair_sum(t: torch.Tensor) -> torch.Tensor:
    """Children-to-parent sum over sibling pairs along axis 0."""
    return t.reshape(t.shape[0] // 2, 2, *t.shape[1:]).sum(dim=1)


def _halo_exchange(x: torch.Tensor, comm: Comm, rad: int) -> torch.Tensor:
    """``[(2*rad+1) * n_loc, ...]``: neighbours' blocks, own block centred;
    chunk ``i`` holds rank ``rank - rad + i``'s block (2*rad permutes)."""
    if rad == 0:
        return x
    pend = {delta: comm.ppermute_async(x, _halo.perm_of(delta, comm.p),
                                       tag=delta + comm.p)
            for delta in range(-rad, rad + 1) if delta != 0}
    return torch.cat([x if delta == 0 else pend[delta].wait()
                      for delta in range(-rad, rad + 1)], dim=0)


def _local_upsweep(dshape: DistH2Shape, d: DistH2Data, x_leaves, comm: Comm):
    """Branch upsweep -> xhat for levels lc..depth, then replicated top."""
    depth, lc = dshape.depth, dshape.lc
    with phase("hgemv/upsweep"):
        xhat: Dict[int, torch.Tensor] = {
            depth: _bmm(d.v_leaf.transpose(-1, -2), x_leaves)}
        for l in range(depth, lc, -1):
            xhat[l - 1] = _pair_sum(_bmm(d.f_br[l - lc].transpose(-1, -2),
                                         xhat[l]))
        with phase("hgemv/root-gather"):
            gathered = comm.all_gather(xhat[lc])          # [2**lc, k, nv]
        xhat_top: Dict[int, torch.Tensor] = {lc: gathered}
        for l in range(lc, 0, -1):
            xhat_top[l - 1] = _pair_sum(_bmm(d.f_top[l].transpose(-1, -2),
                                             xhat_top[l]))
    return xhat, xhat_top


def _marshaled(s_mar: torch.Tensor, src: torch.Tensor, idx: torch.Tensor
               ) -> torch.Tensor:
    """One marshaled block-sparse MV: gather the sources by the slot plan
    into ``[rows, maxb*width, nv]`` and contract against the row-marshaled
    blocks (the slot reduction rides the contraction)."""
    xg = src.index_select(0, idx).to(s_mar.dtype)
    return _bmm(s_mar, xg.reshape(s_mar.shape[0], s_mar.shape[-1],
                                  src.shape[-1]))


def _coupling_phase(dshape: DistH2Shape, d: DistH2Data, xhat, xhat_top,
                    comm: Comm, mode: str, gathered: Optional[Dict] = None):
    """yhat at branch levels (local) + top levels (replicated), for the
    ``allgather`` and broadcast ``ppermute`` modes.  ``gathered``
    (allgather mode only) optionally supplies the already gathered levels
    ``{l: [2**l, k, nv]}``, so the exchange can be cut into a stage of its
    own (``obs.profile_solve``)."""
    depth, lc, p = dshape.depth, dshape.lc, dshape.p
    nv = xhat[depth].shape[-1]
    yhat: Dict[int, torch.Tensor] = {}
    for l in range(lc, depth + 1):
        i = l - lc
        nloc = dshape.nodes_local(l)
        k = dshape.ranks[l]
        if k == 0:
            yhat[l] = xhat[depth].new_zeros((nloc, k, nv))
            continue
        cols = d.pb_col[i]                    # [nloc*maxb] global col plan
        if mode == "allgather" and p > 1:
            with phase("hgemv/exchange"):
                src = gathered[l] if gathered is not None else \
                    comm.all_gather(xhat[l])
            idx = cols
        else:
            rad = dshape.br_radius[i] if p > 1 else 0
            src = xhat[l]
            if mode == "ppermute-bf16":
                src = src.to(torch.bfloat16)
            with phase("hgemv/exchange"):
                src = _halo_exchange(src, comm, rad)
            idx = cols - comm.rank * nloc + rad * nloc
        with phase("hgemv/coupling-gemm"):
            yhat[l] = _marshaled(d.s_br_mar[i], src, idx)
    with phase("hgemv/coupling-gemm"):
        yhat_top = _top_coupling(dshape, d, xhat_top, nv)
    return yhat, yhat_top


def _top_coupling(dshape: DistH2Shape, d: DistH2Data, xhat_top, nv: int
                  ) -> Dict[int, torch.Tensor]:
    """Replicated top-level coupling products (no communication)."""
    yhat_top: Dict[int, torch.Tensor] = {}
    for l in range(dshape.lc):
        k = dshape.ranks[l]
        if dshape.top_counts[l] == 0 or k == 0:
            yhat_top[l] = xhat_top[dshape.lc].new_zeros((1 << l, k, nv))
            continue
        yhat_top[l] = _marshaled(d.s_top_mar[l], xhat_top[l], d.pt_col[l])
    return yhat_top


def _use_split(schedule: str, nloc: int, maxb: int, maxb_d: int,
               n_bnd: int, maxb_o: int, hide_flops: int = 0,
               level_flops: int = 0) -> bool:
    """Static per-level schedule policy: ``overlap`` always splits into the
    §4.2 diag/off twins, ``fused`` never does (one combined product from
    the landed buffer), ``auto`` splits only where the split's padded
    volume is smaller -- and not when the caller's hideable solver compute
    (``hide_flops``) already dwarfs this level's product."""
    if schedule == "overlap":
        return True
    if schedule == "fused":
        return False
    if hide_flops and hide_flops >= level_flops:
        return False
    return nloc * maxb_d + n_bnd * maxb_o < nloc * maxb


def _hp_payload_layout(dshape: DistH2Shape, nv: int):
    """Host-static layout of the fused per-offset halo payloads, in the
    pack order of ``_hp_pack_exchange`` (branch levels ``lc+1..depth``
    ascending, then the dense leaves, key ``depth + 1``): ``seg[(key,
    delta)] = (lo, sz)`` is level ``key``'s flat slice of offset
    ``delta``'s payload (elements) and ``tot[delta]`` its length."""
    depth, lc = dshape.depth, dshape.lc
    seg: Dict[Tuple[int, int], Tuple[int, int]] = {}
    tot: Dict[int, int] = {}

    def add(key, offsets, caps, width):
        for delta, cap in zip(offsets, caps):
            sz = cap * width * nv
            seg[(key, delta)] = (tot.get(delta, 0), sz)
            tot[delta] = tot.get(delta, 0) + sz

    if dshape.p > 1:
        for l in range(lc + 1, depth + 1):
            i = l - lc
            if dshape.ranks[l] == 0 or not dshape.br_offsets[i]:
                continue
            add(l, dshape.br_offsets[i], dshape.br_caps[i], dshape.ranks[l])
        add(depth + 1, dshape.dense_offsets, dshape.dense_caps,
            dshape.leaf_size)
    return seg, tot


def _hp_merged_layout(tot: Dict[int, int], p: int):
    """Residue-class layout merging every per-offset payload into one
    ``[p, capmax]`` all-to-all buffer: chunk ``delta`` travels sender row
    ``(rank - delta) % p`` -> receiver row ``(rank + delta) % p``; offsets
    whose residues collide share a row at cumulative column offsets.
    Returns ``(capmax, pos)`` with ``pos[delta] = (residue, col_lo)``."""
    by_res: Dict[int, int] = {}
    pos: Dict[int, Tuple[int, int]] = {}
    for delta in sorted(tot):
        res = delta % p
        pos[delta] = (res, by_res.get(res, 0))
        by_res[res] = by_res.get(res, 0) + tot[delta]
    capmax = max(by_res.values()) if by_res else 1
    return max(capmax, 1), pos


class _HpPack(NamedTuple):
    """Host-static segment table of one rank's whole halo-plan exchange.

    ``pack`` holds one segment per (branch level, offset) and per dense
    offset; its source slots are ``levels`` (the packed branch levels, in
    order) and then the dense leaves.  ``shape`` is the send buffer's:
    ``(n,)`` with the per-offset payloads end to end, or the merged
    ``(p, capmax)`` rows; ``dest[delta] = (first, length)`` is offset
    ``delta``'s payload in the flattened buffer; ``pos`` is the merged
    layout (``_hp_merged_layout``), None per offset."""
    pack: PackPlan
    levels: Tuple[int, ...]
    shape: Tuple[int, ...]
    dest: Dict[int, Tuple[int, int]]
    pos: Optional[Dict[int, Tuple[int, int]]]


def _hp_pack_table(dshape: DistH2Shape, d: DistH2Data, nv: int, rank: int,
                   merged: bool, bf16: bool) -> _HpPack:
    """The segment table of ``_hp_pack_exchange``: destination offsets
    from ``_hp_payload_layout`` (and ``_hp_merged_layout`` when
    ``merged``), index lists from the rank's halo plans."""
    depth, lc, p = dshape.depth, dshape.lc, dshape.p
    seg, tot = _hp_payload_layout(dshape, nv)
    pos = None
    if merged:
        capmax, pos = _hp_merged_layout(tot, p)
        shape: Tuple[int, ...] = (p, capmax)
        base = {delta: ((rank - res) % p) * capmax + lo
                for delta, (res, lo) in pos.items()}
    else:
        base, n = {}, 0
        for delta, sz in tot.items():
            base[delta], n = n, n + sz
        shape = (n,)
    levels = tuple(l for l in range(lc + 1, depth + 1)
                   if dshape.ranks[l] and dshape.br_offsets[l - lc])
    groups = [(slot, l, d.hp_br[l - lc], dshape.br_offsets[l - lc],
               dshape.ranks[l]) for slot, l in enumerate(levels)]
    groups.append((len(levels), depth + 1, d.hp_dense, dshape.dense_offsets,
                   dshape.leaf_size))
    segs = [Segment(slot, idx, base[delta] + seg[(key, delta)][0],
                    width * nv)
            for slot, key, plan, offsets, width in groups
            for delta, idx in zip(offsets, plan.send)]
    return _HpPack(PackPlan(segs, bf16=bf16), levels, shape,
                   {delta: (base[delta], tot[delta]) for delta in tot}, pos)


def _hp_pack_table_for(tables: Optional[dict], dshape: DistH2Shape,
                       d: DistH2Data, nv: int, rank: int, merged: bool,
                       bf16: bool) -> _HpPack:
    """``_hp_pack_table``, kept in ``tables`` (a matvec's own cache, whose
    shape, rank and mode are fixed: ``id(d) -> {nv: table}``) when given.
    An entry goes when ``d`` is collected: it holds views of ``d``'s plans,
    and the id may be reused."""
    if tables is None:
        return _hp_pack_table(dshape, d, nv, rank, merged, bf16)
    per_d = tables.get(id(d))
    if per_d is None:
        per_d = tables[id(d)] = {}
        weakref.finalize(d, tables.pop, id(d), None)
    if nv not in per_d:
        per_d[nv] = _hp_pack_table(dshape, d, nv, rank, merged, bf16)
    return per_d[nv]


def _hp_pack_exchange(dshape: DistH2Shape, d: DistH2Data, xhat, x_leaves,
                      comm: Comm, mode: str, backend: str = "cuda",
                      merged: bool = False, tables: Optional[dict] = None):
    """Phase A of the §4.2 schedule: pack every level's planned send rows
    (branch levels and dense leaves) straight into the send buffer -- one
    flat payload per neighbour offset, or, ``merged``, the
    ``_hp_merged_layout`` rows of ONE all-to-all -- in one ``halo_pack``
    launch over the rank's segment table (``_hp_pack_table``, cached in
    ``tables`` when given), and issue one permute per offset (or the
    all-to-all).  Returns a callable that waits and gives the landed flat
    payloads ``{delta: [tot]}``.

    Level ``lc`` never exchanges: the branch-root gather that feeds the
    replicated top sweep already delivered every rank's ``xhat[lc]``.
    """
    p = dshape.p
    nv = x_leaves.shape[-1]
    bf16 = mode.endswith("-bf16")
    hp = _hp_pack_table_for(tables, dshape, d, nv, comm.rank, merged, bf16)
    if not hp.dest:
        return lambda: {}
    dtype = torch.bfloat16 if bf16 else x_leaves.dtype
    with phase("halo/pack"):
        buf = (torch.zeros if merged else torch.empty)(
            hp.shape, dtype=dtype, device=x_leaves.device)
        kops.halo_pack_segments(
            hp.pack, [xhat[l] for l in hp.levels] + [x_leaves],
            buf.view(-1), backend)

    with phase("halo/round"):
        if merged:
            pend = comm.all_to_all_async(buf)
        else:
            pend = {delta: comm.ppermute_async(
                buf[lo:lo + n], _halo.perm_of(delta, p), tag=delta + p)
                for delta, (lo, n) in hp.dest.items()}

    def land() -> Dict[int, torch.Tensor]:
        with phase("halo/round"):
            if not merged:
                return {delta: w.wait() for delta, w in pend.items()}
            landed = pend.wait()
        return {delta: landed[(comm.rank + res) % p,
                              lo:lo + hp.dest[delta][1]]
                for delta, (res, lo) in hp.pos.items()}
    return land


def _coupling_phase_overlap(dshape: DistH2Shape, d: DistH2Data, xhat,
                            xhat_top, x_leaves, comm: Comm, mode: str,
                            backend: str = "cuda", schedule: str = "auto",
                            hide_flops: int = 0,
                            tables: Optional[dict] = None,
                            chunks: Optional[Dict[int, torch.Tensor]] = None):
    """Compressed-halo coupling + dense phases on the §4.2 schedule:
    (A) pack and issue the whole matvec's exchange; (B) every diagonal
    (own-column) product, the dense diagonal block and the replicated top
    levels while the permutes are in flight (level ``lc`` sources from the
    C-level gather); (C) wait, slice the landed payloads into per-level
    halo buffers and finish the off-diagonal products (or, for levels the
    policy left fused, the whole level's combined product).  Returns
    ``(yhat, yhat_top, y_dense)``.  ``chunks`` optionally supplies the
    already landed payloads (``_hp_pack_exchange``'s), so the exchange can
    be cut into a stage of its own (``obs.profile_solve``)."""
    depth, lc, p = dshape.depth, dshape.lc, dshape.p
    m = dshape.leaf_size
    nl = dshape.leaves_per_dev
    nv = xhat[depth].shape[-1]
    DENSE = depth + 1                          # key of the dense payload
    seg, _ = _hp_payload_layout(dshape, nv)

    if chunks is not None:
        land = lambda: chunks                     # noqa: E731
    else:
        with phase("hgemv/exchange"):
            land = _hp_pack_exchange(dshape, d, xhat, x_leaves, comm, mode,
                                     backend, merged=hide_flops > 0,
                                     tables=tables)

    def _split(i, k):
        rows = d.s_br_mar[i].shape[0]
        maxb = d.s_br_mar[i].shape[-1] // k
        return _use_split(schedule, rows, maxb,
                          d.s_br_mar_diag[i].shape[-1] // k,
                          d.s_br_mar_off[i].shape[0],
                          d.s_br_mar_off[i].shape[-1] // k,
                          hide_flops, 2 * rows * k * maxb * k * nv)

    dmaxb_full = d.dense_mar.shape[-1] // m
    d_split = _use_split(schedule, d.dense_mar.shape[0], dmaxb_full,
                         d.dense_mar_diag.shape[-1] // m,
                         d.dense_mar_off.shape[0],
                         d.dense_mar_off.shape[-1] // m,
                         hide_flops, 2 * nl * m * dmaxb_full * m * nv)

    # --- phase B: diagonal products + dense diagonal + replicated top
    yhat: Dict[int, Optional[torch.Tensor]] = {}
    with phase("hgemv/diag-gemm"):
        for l in range(lc, depth + 1):
            i = l - lc
            k = dshape.ranks[l]
            if k == 0:
                yhat[l] = xhat[depth].new_zeros((dshape.nodes_local(l), k,
                                                 nv))
            elif l == lc and p > 1:
                yhat[l] = _marshaled(d.s_br_mar[i], xhat_top[lc],
                                     d.pb_col[i])
            elif not _split(i, k):
                yhat[l] = None
            else:
                yhat[l] = _marshaled(d.s_br_mar_diag[i], xhat[l],
                                     d.hp_br[i].diag_col)
        y_de = _marshaled(d.dense_mar_diag, x_leaves,
                          d.hp_dense.diag_col) if d_split else None
        yhat_top = _top_coupling(dshape, d, xhat_top, nv)

    # --- phase C: finish from the landed payloads
    landed_chunks = land()

    def _landed(src, key, offsets, caps, width):
        """``[nloc + sum(caps), width, nv]`` buffer in plan layout."""
        with phase("halo/land"):
            pieces = [src]
            for delta, cap in zip(offsets, caps):
                lo, sz = seg[(key, delta)]
                pieces.append(landed_chunks[delta][lo:lo + sz]
                              .reshape(cap, width, nv).to(src.dtype))
            return torch.cat(pieces, dim=0)

    def _off_merge(y, src, key, plan: HaloPlan, offsets, caps, s_off,
                   width):
        """Add the off-diagonal correction of the boundary rows and merge
        it back scatter-free through ``rowpos``."""
        maxb_o = s_off.shape[-1] // width
        if maxb_o == 0 or s_off.shape[0] == 0 or p == 1:
            return y
        buf = _landed(src, key, offsets, caps, width)
        off = _marshaled(s_off, buf, plan.off_idx)
        corrected = y.index_select(0, plan.bnd_rows) + off
        return torch.cat([y, corrected], dim=0).index_select(0, plan.rowpos)

    def _fused_level(src, key, plan: HaloPlan, offsets, caps, s_mar, width):
        buf = _landed(src, key, offsets, caps, width) if p > 1 else src
        return _marshaled(s_mar, buf, plan.comb_idx)

    with phase("hgemv/off-gemm"):
        for l in range(lc, depth + 1):
            i = l - lc
            k = dshape.ranks[l]
            if k == 0 or (l == lc and p > 1):  # lc rode the C-level gather
                continue
            args = (xhat[l], l, d.hp_br[i], dshape.br_offsets[i],
                    dshape.br_caps[i])
            if yhat[l] is None:
                yhat[l] = _fused_level(*args, d.s_br_mar[i], k)
            else:
                yhat[l] = _off_merge(yhat[l], *args, d.s_br_mar_off[i], k)
        args = (x_leaves, DENSE, d.hp_dense, dshape.dense_offsets,
                dshape.dense_caps)
        if y_de is None:
            y_de = _fused_level(*args, d.dense_mar, m)
        else:
            y_de = _off_merge(y_de, *args, d.dense_mar_off, m)
    return yhat, yhat_top, y_de


def _local_downsweep(dshape: DistH2Shape, d: DistH2Data, yhat, yhat_top,
                     comm: Comm):
    with phase("hgemv/downsweep"):
        depth, lc = dshape.depth, dshape.lc
        if lc > 0:
            acc = yhat_top[0]
            for l in range(1, lc + 1):
                step = _bmm(d.e_top[l], acc.repeat_interleave(2, dim=0))
                acc = step + yhat_top[l] if l < lc else step
            acc = yhat[lc] + acc[comm.rank:comm.rank + 1]
        else:
            acc = yhat[lc]
        for l in range(lc + 1, depth + 1):
            acc = yhat[l] + _bmm(d.e_br[l - lc],
                                 acc.repeat_interleave(2, dim=0))
        return _bmm(d.u_leaf, acc)


def _dense_phase(dshape: DistH2Shape, d: DistH2Data, x_leaves, comm: Comm,
                 mode: str, gathered: Optional[torch.Tensor] = None):
    """Dense leaves for the ``allgather`` and broadcast ``ppermute``
    modes.  ``gathered`` (allgather mode only) optionally supplies the
    already gathered leaves, as ``_coupling_phase``'s."""
    p = dshape.p
    nloc = dshape.leaves_per_dev
    m = dshape.leaf_size
    if mode == "allgather" and p > 1:
        with phase("hgemv/exchange"):
            src = gathered if gathered is not None else \
                comm.all_gather(x_leaves)
        idx = d.pd_col
    else:
        rad = dshape.dense_radius if p > 1 else 0
        src = x_leaves.to(torch.bfloat16) if mode == "ppermute-bf16" \
            else x_leaves
        with phase("hgemv/exchange"):
            src = _halo_exchange(src, comm, rad)
        idx = d.pd_col - comm.rank * nloc + rad * nloc
    with phase("hgemv/dense"):
        return _marshaled(d.dense_mar, src, idx)


def dist_h2_matvec_local(dshape: DistH2Shape, d: DistH2Data, x: torch.Tensor,
                         comm: Comm, mode: str = "halo-plan",
                         backend: str = "cuda", schedule: str = "auto",
                         hide_flops: int = 0,
                         tables: Optional[dict] = None) -> torch.Tensor:
    """One rank's part of ``y = A x``: ``x``, ``y`` are the rank's
    ``[n_local, nv]`` rows.  ``hide_flops > 0`` marks a solver-embedded
    call: the halo-plan exchange merges into one all-to-all and the auto
    schedule accounts for the solver compute to hide it under.
    ``tables`` caches the halo-plan exchange's pack table across calls
    with the same arguments but ``d`` and ``x`` (``make_dist_matvec``)."""
    if mode not in COMMS:
        raise ValueError(f"unknown comm mode {mode!r}; expected {COMMS}")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    nv = x.shape[-1]
    x_leaves = x.reshape(dshape.leaves_per_dev, dshape.leaf_size,
                         nv).contiguous()
    xhat, xhat_top = _local_upsweep(dshape, d, x_leaves, comm)
    if mode.startswith("halo-plan"):
        yhat, yhat_top, y_de = _coupling_phase_overlap(
            dshape, d, xhat, xhat_top, x_leaves, comm, mode, backend,
            schedule, hide_flops, tables)
    else:
        yhat, yhat_top = _coupling_phase(dshape, d, xhat, xhat_top, comm,
                                         mode)
        y_de = _dense_phase(dshape, d, x_leaves, comm, mode)
    y_lr = _local_downsweep(dshape, d, yhat, yhat_top, comm)
    return (y_lr + y_de).reshape(dshape.n_local(), nv)


def make_dist_matvec(dshape: DistH2Shape, comm: Comm,
                     mode: str = "halo-plan", backend: str = "cuda",
                     schedule: str = "auto", hide_flops: int = 0):
    """The distributed matvec of one rank: ``fn(local_data, x_local)``.

    ``mode`` is the comm mode (``COMMS``); ``backend="cuda"`` packs the
    halo-plan send rows with the ``halo_pack`` kernel on CUDA tensors;
    ``schedule`` picks the halo-plan product schedule per level
    (``_use_split``); ``hide_flops > 0`` requests the solver lowering
    (merged single all-to-all + hide-aware auto).  On a 2D mesh ``comm``
    is the rank's block-row ``Comm`` (``comm.mesh_comm``) and ``x`` its
    ``mesh_slice``.
    """
    if backend not in kops.BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    tables: dict = {}             # the halo-plan exchange's pack tables

    def fn(d: DistH2Data, x: torch.Tensor) -> torch.Tensor:
        return dist_h2_matvec_local(dshape, d, x, comm, mode, backend,
                                    schedule, hide_flops, tables)
    return fn


# ---------------------------------------------------------------------------
# distributed orthogonalization + compression (symmetric structure)
# ---------------------------------------------------------------------------

def _branch_orthogonalize(dshape: DistH2Shape, leaf, e_br, e_top,
                          comm: Comm, backend: str):
    """Upsweep QR: local branch, then replicated top.  Returns
    ``(new_leaf, new_e_br, new_e_top, r_br, r_top)``."""
    depth, lc = dshape.depth, dshape.lc
    r: Dict[int, torch.Tensor] = {}
    q_leaf, r[depth] = kops.backend_qr(leaf, backend)

    def step(rl, e):
        re = torch.matmul(rl, e)                     # R_c @ E_c
        nn, kl, kp = re.shape
        q, rr = kops.backend_qr(re.reshape(nn // 2, 2 * kl, kp), backend)
        return q.reshape(nn, kl, q.shape[-1]), rr

    new_e_br = [e_br[0]] + [None] * (depth - lc)
    for l in range(depth, lc, -1):
        new_e_br[l - lc], r[l - 1] = step(r[l], e_br[l - lc])
    # gather the branch-root R factors and continue on the replicated top
    r_top: Dict[int, torch.Tensor] = {lc: comm.all_gather(r[lc])}
    new_e_top = [e_top[0]] + [None] * lc
    for l in range(lc, 0, -1):
        new_e_top[l], r_top[l - 1] = step(r_top[l], e_top[l])
    return q_leaf, new_e_br, new_e_top, r, r_top


def _project_blocks(left_rows, s, right_cols) -> torch.Tensor:
    """``S'_b = left_b @ S_b @ right_b^T``."""
    return torch.matmul(torch.matmul(left_rows, s),
                        right_cols.transpose(-1, -2))


def _remote_cols(dshape: DistH2Shape, d: DistH2Data, i: int, f_l, f_top_lc,
                 comm: Comm, backend: str) -> torch.Tensor:
    """Per slab block of branch level ``lc + i``, the column node's factor
    (``f_l``: this rank's ``[nloc, ...]``).  Level ``lc`` reads the
    C-level gather; deeper levels fetch remote columns through the level's
    halo plan (the node set a remote rank references is the matvec's)."""
    if i == 0 and dshape.p > 1:
        return f_top_lc.index_select(0, d.s_br_cols[0])
    buf = _halo.exchange(f_l, d.hp_br[i], dshape.br_offsets[i], comm,
                         backend=backend) if dshape.p > 1 else f_l
    return buf.index_select(0, d.hp_br[i].blk_idx)


def dist_orthogonalize_local(dshape: DistH2Shape, d: DistH2Data, comm: Comm,
                             backend: str = "cuda") -> DistH2Data:
    """Distributed orthogonalization (symmetric structure): the S update
    needs the column node's R factor, fetched through the halo plan."""
    if not dshape.symmetric:
        raise ValueError("the distributed path assumes symmetric structure")
    depth, lc = dshape.depth, dshape.lc
    with phase("compress/orthogonalize"):
        q_leaf, new_e_br, new_e_top, r, r_top = _branch_orthogonalize(
            dshape, d.u_leaf, d.e_br, d.e_top, comm, backend)
    with phase("compress/project-s"):
        s_br_new = []
        for l in range(lc, depth + 1):
            i = l - lc
            r_cols = _remote_cols(dshape, d, i, r[l], r_top[lc], comm,
                                  backend)
            r_rows = r[l].index_select(0, d.s_br_rows[i])
            s_br_new.append(_project_blocks(r_rows, d.s_br[i], r_cols))
        s_top_new = [
            _project_blocks(r_top[l].index_select(0, d.s_top_rows[l]),
                            d.s_top[l],
                            r_top[l].index_select(0, d.s_top_cols[l]))
            if dshape.top_counts[l] else d.s_top[l] for l in range(lc)]
    return _with_remarshaled(dshape, d, dataclasses.replace(
        d, u_leaf=q_leaf, v_leaf=q_leaf, e_br=new_e_br, f_br=new_e_br,
        s_br=s_br_new, e_top=new_e_top, f_top=new_e_top, s_top=s_top_new))


def _with_remarshaled(dshape: DistH2Shape, d_old: DistH2Data,
                      d_new: DistH2Data) -> DistH2Data:
    """Refresh the marshaled S buffers from rewritten block values through
    the (unchanged) per-rank slot plans.  Dense is untouched."""
    depth, lc = dshape.depth, dshape.lc
    br = range(lc, depth + 1)
    return dataclasses.replace(
        d_new,
        s_br_mar=[marshal_blocks(d_new.s_br[l - lc], d_old.pb_blk[l - lc],
                                 dshape.nodes_local(l)) for l in br],
        s_br_mar_diag=[marshal_blocks(d_new.s_br[l - lc],
                                      d_old.hp_br[l - lc].diag_blk,
                                      dshape.nodes_local(l)) for l in br],
        # the off twin's row axis is the boundary-row set, not the node set
        s_br_mar_off=[marshal_blocks(d_new.s_br[l - lc],
                                     d_old.hp_br[l - lc].off_blk,
                                     d_old.s_br_mar_off[l - lc].shape[0])
                      for l in br],
        s_top_mar=[marshal_blocks(d_new.s_top[l], d_old.pt_blk[l], 1 << l)
                   for l in range(lc)])


def _stack_local(s_mar: torch.Tensor) -> torch.Tensor:
    """A node's coupling blocks stacked vertically as ``S^T``: the
    row-marshaled ``[nloc, k, maxb*k]`` buffer transposed (the port's
    counterpart of the reference's ``compression._stack_blocks``; zero
    padding slots leave the R factor unchanged)."""
    return s_mar.transpose(-1, -2)


def _weights_r(pieces: List[torch.Tensor], kl: int, backend: str
               ) -> torch.Tensor:
    """R factor ``[nn, kl, kl]`` of the stacked pieces (zero rows pad a
    stack shorter than ``kl``)."""
    stack = torch.cat(pieces, dim=1)
    if stack.shape[1] < kl:
        stack = torch.cat([stack, stack.new_zeros(
            (stack.shape[0], kl - stack.shape[1], kl))], dim=1)
    return kops.backend_qr_r(stack, backend)[..., :kl, :]


def dist_compress_local(dshape: DistH2Shape, d: DistH2Data,
                        target_ranks: Sequence[int], comm: Comm,
                        backend: str = "cuda") -> DistH2Data:
    """Distributed recompression with static target ranks (symmetric).

    Paper §5: weights downsweep (batched QR of stacked blocks, no
    communication below the C-level), truncation upsweep (batched SVD, one
    gather at the C-level), then the coupling projection with a halo
    exchange of the remote column maps.
    """
    depth, lc, p = dshape.depth, dshape.lc, dshape.p
    me = comm.rank
    ranks = dshape.ranks
    tr = list(target_ranks)
    d = dist_orthogonalize_local(dshape, d, comm, backend)

    # ---- weights downsweep (top replicated, branch local; zero comm) ----
    with phase("compress/weights"):
        w_top: Dict[int, torch.Tensor] = {
            0: d.u_leaf.new_zeros((1, ranks[0], ranks[0]))}
        for l in range(1, lc + 1):
            rpar = w_top[l - 1].repeat_interleave(2, dim=0)
            pieces = [torch.matmul(rpar, d.e_top[l].transpose(-1, -2))]
            if l < lc and dshape.top_counts[l] > 0:
                pieces.append(_stack_local(d.s_top_mar[l]))
            w_top[l] = _weights_r(pieces, ranks[l], backend)
        # level lc: this rank's node, with its branch blocks folded in
        w: Dict[int, torch.Tensor] = {lc: w_top[lc][me:me + 1]}
        if dshape.br_counts[0] > 0:
            if lc > 0:
                par_r = w_top[lc - 1].repeat_interleave(2, dim=0)[me:me + 1]
                pieces = [torch.matmul(par_r, d.e_top[lc][me:me + 1]
                                       .transpose(-1, -2))]
            else:
                pieces = [d.u_leaf.new_zeros((1, ranks[0], ranks[lc]))]
            pieces.append(_stack_local(d.s_br_mar[0]))
            w[lc] = _weights_r(pieces, ranks[lc], backend)
        for l in range(lc + 1, depth + 1):
            i = l - lc
            rpar = w[l - 1].repeat_interleave(2, dim=0)
            pieces = [torch.matmul(rpar, d.e_br[i].transpose(-1, -2))]
            if dshape.br_counts[i] > 0:
                pieces.append(_stack_local(d.s_br_mar[i]))
            w[l] = _weights_r(pieces, ranks[l], backend)

    # ---- truncation upsweep: branch local -> gather at C-level -> top ----
    def up(pmap_, transfers, weights, lo, hi, base):
        new_t = [transfers[0]] + [None] * (hi - lo)
        for l in range(hi, lo, -1):
            stack, g, _ = truncation_inner_factors(
                pmap_[l], transfers[l - base], weights[l - 1], backend)
            rl = stack.shape[1] // 2
            gk = g[..., :min(tr[l - 1], g.shape[-1], 2 * rl)]
            new_t[l - base] = gk.reshape(2 * stack.shape[0], rl,
                                         gk.shape[-1])
            pmap_[l - 1] = truncation_project(gk, stack)
        return new_t

    with phase("compress/truncate"):
        wq, _ = truncation_leaf_factors(w[depth], backend)
        wk = wq[..., :min(tr[depth], wq.shape[-1])]
        new_leaf = torch.matmul(d.u_leaf, wk)
        pmap_: Dict[int, torch.Tensor] = {
            depth: wk.transpose(-1, -2).contiguous()}
        new_e_br = up(pmap_, d.e_br, w, lc, depth, lc)
        p_top: Dict[int, torch.Tensor] = {lc: comm.all_gather(pmap_[lc])}
        new_e_top = up(p_top, d.e_top, w_top, 0, lc, 0)

    # ---- coupling projection (planned exchange of remote column maps;
    # level lc rides the C-level gather that opened the top sweep) ----
    with phase("compress/project-s"):
        s_br_new = []
        for l in range(lc, depth + 1):
            i = l - lc
            pc = _remote_cols(dshape, d, i, pmap_[l], p_top[lc], comm,
                              backend)
            pr = pmap_[l].index_select(0, d.s_br_rows[i])
            s_br_new.append(_project_blocks(pr, d.s_br[i], pc))
        s_top_new = []
        for l in range(lc):
            if dshape.top_counts[l] == 0:
                rnew = p_top[l].shape[1]
                s_top_new.append(d.u_leaf.new_zeros(
                    (d.s_top[l].shape[0], rnew, rnew)))
                continue
            s_top_new.append(_project_blocks(
                p_top[l].index_select(0, d.s_top_rows[l]), d.s_top[l],
                p_top[l].index_select(0, d.s_top_cols[l])))

    return _with_remarshaled(dshape, d, dataclasses.replace(
        d, u_leaf=new_leaf, v_leaf=new_leaf, e_br=new_e_br, f_br=new_e_br,
        s_br=s_br_new, e_top=new_e_top, f_top=new_e_top, s_top=s_top_new))


def make_dist_compress(dshape: DistH2Shape, comm: Comm,
                       target_ranks: Sequence[int], backend: str = "cuda"):
    """The distributed recompression of one rank: ``fn(local_data) ->
    local_data`` with ranks ``target_ranks`` (the caller's shape for the
    result is ``dataclasses.replace(dshape, ranks=target_ranks)``).
    ``backend="cuda"`` runs the QRs and SVDs on the kernels."""
    if backend not in kops.BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    tr = tuple(int(t) for t in target_ranks)

    def fn(d: DistH2Data) -> DistH2Data:
        return dist_compress_local(dshape, d, tr, comm, backend)
    return fn


# ---------------------------------------------------------------------------
# communication model
# ---------------------------------------------------------------------------

def matvec_comm_bytes(dshape: DistH2Shape, nv: int, comm: str = "halo-plan",
                      bytes_per_el: int = 4) -> int:
    """Per-rank bytes one distributed matvec receives over the wire.

    ``allgather`` ships ``(p-1)`` full level copies and broadcast
    ``ppermute`` ``2*rad`` copies; ``halo-plan`` only the compressed send
    lists (``sum(caps)`` rows per level, the paper's §4.1 volume).  The
    branch-root gather brings the other ``p-1`` root slices.  ``-bf16``
    modes halve ``bytes_per_el`` at the call site.
    """
    total = (dshape.p - 1) * dshape.ranks[dshape.lc] * nv * bytes_per_el
    for l in range(dshape.lc, dshape.depth + 1):
        i = l - dshape.lc
        nloc = dshape.nodes_local(l)
        row = dshape.ranks[l] * nv * bytes_per_el
        if comm == "allgather":
            total += (dshape.p - 1) * nloc * row
        elif comm.startswith("halo-plan"):
            if l > dshape.lc:      # level lc rides the branch-root gather
                total += sum(dshape.br_caps[i]) * row
        else:
            total += 2 * dshape.br_radius[i] * nloc * row
    nl = dshape.leaves_per_dev
    row = dshape.leaf_size * nv * bytes_per_el
    if comm == "allgather":
        total += (dshape.p - 1) * nl * row
    elif comm.startswith("halo-plan"):
        total += sum(dshape.dense_caps) * row
    else:
        total += 2 * dshape.dense_radius * nl * row
    return total


def merged_exchange_bytes(dshape: DistH2Shape, nv: int,
                          comm: str = "halo-plan",
                          bytes_per_el: int = 4) -> int:
    """Per-rank wire bytes of the solver lowering's merged exchange: one
    ``[p, capmax]`` all-to-all, of which ``(p-1) * capmax`` elements cross
    the wire.  ``-bf16`` ships 2-byte payloads."""
    if dshape.p <= 1:
        return 0
    _, tot = _hp_payload_layout(dshape, nv)
    if not tot:
        return 0
    capmax, _ = _hp_merged_layout(tot, dshape.p)
    bpe = 2 if comm.endswith("-bf16") else bytes_per_el
    return (dshape.p - 1) * capmax * bpe
