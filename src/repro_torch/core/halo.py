"""HaloPlan: the compressed halo exchange of the distributed H^2 operations
(paper §4.1/§4.2), port of ``repro/core/halo.py``.

Every level's block list is partitioned over ``p`` ranks by block row.  For
each nonzero rank offset ``delta`` in a level's block list, sender ``q``
owes rank ``q - delta`` exactly the nodes of ``q`` that appear there as
block columns; the per-sender lists are padded to the global per-offset cap
(``send``), so a rank packs ``x[send]`` and ships it in ONE permute per
offset.  A rank's landed halo buffer is ``[own (nloc) | recv(offsets[0])
| recv(offsets[1]) | ...]``, and three gather maps address it: ``diag_*``
(own-column slots -> local node), ``off_*`` (remote-column slots -> buffer
position, over the boundary rows only) and ``blk_idx`` (slab block ->
buffer position of its column).  The marshaled value buffers are split into
a diagonal (own-column) twin and an off-diagonal twin, so the diagonal
products need no remote data and run while the exchange is in flight.

``build_send_lists`` and ``partition_level`` are host numpy and give the
reference's int32 maps bit for bit.  They are vectorized over the block
list (the reference walks it block by block), and the value buffers are
made by gathering the level's blocks through slot -> block maps on the
blocks' own device: a bitwise copy of what the reference assembles in
numpy, without a host copy of the operator.

``start_halo``/``land_halo``/``exchange`` issue and land one level's
exchange over a ``Comm``; the send rows of all the level's offsets are
packed by one ``ops.halo_pack_segments`` call.

The distributed solve's grid<->tree transpositions (DESIGN.md §12) are one
all-to-all each: ``build_transpose_plan`` (host numpy, the reference's
``(cap, send_idx, take_idx)`` bit for bit, vectorized over the rows) says
which local rows each rank owes each peer, and ``transpose_a2a`` packs
them -- one ``halo_pack`` launch for all ``p`` lanes and their side-channel
rows on the card -- ships them and takes the landed rows into place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.halo_pack import PackPlan, Segment
from repro_torch.obs.trace import phase

from .comm import Comm, Pending
from .structure import marshal_blocks


@dataclasses.dataclass
class HaloPlan:
    """Runtime gather maps of one level's compressed exchange (int32).

    Shapes below are per rank; the partitioned arrays carry a ``p*``
    leading factor (``dist.local_shard`` cuts a rank's slice).

    send[j]:  [cap_j]            local rows to pack for offset ``offsets[j]``
    comb_idx: [nloc*maxb]        combined slot -> landed-buffer position
    diag_blk: [nloc*maxb_d]      slot -> local slab block (sentinel = nbmax)
    diag_col: [nloc*maxb_d]      slot -> local source node
    bnd_rows: [n_bnd_cap]        boundary rows (padding repeats 0)
    rowpos:   [nloc]             output merge map: interior row r -> r,
                                 boundary row r -> nloc + its boundary rank
    off_blk:  [n_bnd_cap*maxb_o] slot -> local slab block (sentinel = nbmax)
    off_idx:  [n_bnd_cap*maxb_o] slot -> landed-buffer position
    blk_idx:  [nbmax]            slab block -> buffer position of its column
    """

    send: List[torch.Tensor]
    comb_idx: torch.Tensor
    diag_blk: torch.Tensor
    diag_col: torch.Tensor
    bnd_rows: torch.Tensor
    rowpos: torch.Tensor
    off_blk: torch.Tensor
    off_idx: torch.Tensor
    blk_idx: torch.Tensor


PLAN_FIELDS = ("comb_idx", "diag_blk", "diag_col", "bnd_rows", "rowpos",
               "off_blk", "off_idx", "blk_idx")


@dataclasses.dataclass(frozen=True)
class LevelPartition:
    """One level's block list partitioned over ``p`` ranks: the slab, the
    combined marshaled layout (allgather / broadcast modes) and the
    compressed halo plan with its diag/off marshaled twins.

    The int32 maps are numpy (the reference's, bit for bit); the value
    buffers ``sv``, ``sv_mar``, ``sv_mar_diag``, ``sv_mar_off`` are tensors
    on the device of the blocks they were gathered from.
    """

    # slab layout (block-list order per rank, padded to nbmax)
    sv: torch.Tensor         # [p*nbmax, k1, k2]
    sr: np.ndarray           # [p*nbmax] local row
    sc: np.ndarray           # [p*nbmax] GLOBAL col
    nbmax: int
    rad: int                 # broadcast halo radius (ppermute modes)
    # combined marshaled layout
    pb: np.ndarray           # [p*nloc*maxb] slot -> slab block (nbmax = pad)
    pc: np.ndarray           # [p*nloc*maxb] slot -> GLOBAL col
    sv_mar: torch.Tensor     # [p*nloc, k1, maxb*k2]
    # compressed halo plan
    offsets: Tuple[int, ...]
    caps: Tuple[int, ...]
    send: List[np.ndarray]   # per offset: [p*cap] local rows to pack
    comb_idx: np.ndarray
    diag_blk: np.ndarray
    diag_col: np.ndarray
    bnd_rows: np.ndarray
    rowpos: np.ndarray
    off_blk: np.ndarray
    off_idx: np.ndarray
    blk_idx: np.ndarray
    sv_mar_diag: torch.Tensor  # [p*nloc, k1, maxb_d*k2]
    sv_mar_off: torch.Tensor   # [p*n_bnd_cap, k1, maxb_o*k2]

    def plan(self, device) -> HaloPlan:
        def t(a):
            return torch.as_tensor(a, dtype=torch.int32, device=device)
        return HaloPlan(send=[t(s) for s in self.send],
                        **{f: t(getattr(self, f)) for f in PLAN_FIELDS})


def _occurrence(key: np.ndarray) -> np.ndarray:
    """For each entry, how many earlier entries carry the same key (the
    fill counter of the reference's block-by-block walk)."""
    if key.size == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    rank_sorted = np.arange(key.size) - np.searchsorted(sk, sk, side="left")
    out = np.empty(key.size, np.int64)
    out[order] = rank_sorted
    return out


def build_send_lists(rows: np.ndarray, cols: np.ndarray, p: int, shift: int
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                List[np.ndarray], np.ndarray]:
    """Compressed send lists of one level.

    Returns ``(offsets, caps, send, colpos)``: the sorted nonzero rank
    offsets present in the block list, the per-offset packed-row caps
    (global max over senders, at least 1), the padded per-rank send arrays
    ``[p*cap]`` (local rows sender ``q`` packs for receiver ``q - delta``),
    and ``colpos`` mapping block index -> position of its column in the
    receiver's landed buffer ``[own (nloc) | recv(offsets[0]) | ...]``.
    """
    nloc = 1 << shift
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    owner = rows >> shift
    col_owner = cols >> shift
    dvec = col_owner - owner
    offsets = tuple(int(d) for d in np.unique(dvec) if d != 0)
    colpos = cols - owner * nloc            # own columns: the local node
    send: List[np.ndarray] = []
    caps: List[int] = []
    base = nloc
    for d in offsets:
        lists = []
        for q in range(p):
            sel = (col_owner == q) & (dvec == d)
            loc = np.unique(cols[sel]) - q * nloc
            lists.append((sel, loc))
        cap = max([1] + [loc.shape[0] for _, loc in lists])
        arr = np.zeros(p * cap, np.int32)
        for q, (sel, loc) in enumerate(lists):
            arr[q * cap:q * cap + loc.shape[0]] = loc
            colpos[sel] = base + np.searchsorted(loc, cols[sel] - q * nloc)
        caps.append(cap)
        send.append(arr)
        base += cap
    return offsets, tuple(caps), send, colpos


def partition_level(rows: np.ndarray, cols: np.ndarray, vals: torch.Tensor,
                    p: int, shift: int) -> LevelPartition:
    """Partition one level's (row-sorted) block list into the per-rank
    slab + combined marshaled layout + compressed halo plan.

    ``vals``: the level's ``[nb, k1, k2]`` blocks; the value buffers are
    gathered from it on its device.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nb = rows.shape[0]
    nloc = 1 << shift
    n_rows_g = p * nloc
    owner = rows >> shift
    dvec = (cols >> shift) - owner
    is_off = dvec != 0

    def row_max(sel) -> int:
        return int(np.bincount(rows[sel], minlength=n_rows_g).max()) \
            if nb else 0

    counts = np.bincount(owner, minlength=p)
    nbmax = max(int(counts.max()) if nb else 0, 1)
    maxb = max(row_max(slice(None)), 1)
    maxb_d = max(row_max(~is_off), 1)
    maxb_o = row_max(is_off)
    nrow_o = np.bincount(rows[is_off], minlength=n_rows_g)
    bnd_mask = (nrow_o > 0).reshape(p, nloc)
    n_bnd_cap = int(bnd_mask.sum(axis=1).max()) if nb else 0

    offsets, caps, send, colpos = build_send_lists(rows, cols, p, shift)

    fill = _occurrence(owner)                 # slab position on its rank
    slot = owner * nbmax + fill
    j = _occurrence(rows)                     # slot within its row

    sr = np.zeros(p * nbmax, np.int32)
    sc = np.repeat(np.arange(p, dtype=np.int32) * nloc, nbmax)
    blk_idx = np.zeros(p * nbmax, np.int32)
    sv_src = np.full(p * nbmax, nb, np.int64)
    sr[slot] = rows - owner * nloc
    sc[slot] = cols
    blk_idx[slot] = colpos
    sv_src[slot] = np.arange(nb)

    pb = np.full(n_rows_g * maxb, nbmax, np.int32)      # nbmax = pad sentinel
    pc = np.repeat(np.arange(p, dtype=np.int32) * nloc, nloc * maxb)
    comb_idx = np.zeros(n_rows_g * maxb, np.int32)
    mar_src = np.full(n_rows_g * maxb, nb, np.int64)
    s = rows * maxb + j
    pb[s] = fill
    pc[s] = cols
    comb_idx[s] = colpos
    mar_src[s] = np.arange(nb)

    # boundary rows (rows owning >= 1 off block), padded to the global cap
    bnd_rows = np.zeros(p * n_bnd_cap, np.int32)
    rowpos = np.tile(np.arange(nloc, dtype=np.int32), p)
    bnd_rank = np.full(n_rows_g, -1, np.int64)
    for d in range(p):
        loc = np.nonzero(bnd_mask[d])[0]
        bnd_rows[d * n_bnd_cap:d * n_bnd_cap + loc.shape[0]] = loc
        bnd_rank[d * nloc + loc] = np.arange(loc.shape[0])
        rowpos[d * nloc + loc] = nloc + np.arange(loc.shape[0])

    diag_blk = np.full(n_rows_g * maxb_d, nbmax, np.int32)
    diag_col = np.zeros(n_rows_g * maxb_d, np.int32)
    diag_src = np.full(n_rows_g * maxb_d, nb, np.int64)
    b = np.nonzero(~is_off)[0]
    s = rows[b] * maxb_d + _occurrence(rows[b])
    diag_blk[s] = fill[b]
    diag_col[s] = colpos[b]
    diag_src[s] = b

    off_blk = np.full(p * n_bnd_cap * maxb_o, nbmax, np.int32)
    off_idx = np.zeros(p * n_bnd_cap * maxb_o, np.int32)
    off_src = np.full(p * n_bnd_cap * maxb_o, nb, np.int64)
    b = np.nonzero(is_off)[0]
    rb = owner[b] * n_bnd_cap + bnd_rank[rows[b]]
    s = rb * maxb_o + _occurrence(rows[b])
    off_blk[s] = fill[b]
    off_idx[s] = colpos[b]
    off_src[s] = b

    def gather(src, n_rows):
        idx = torch.as_tensor(src, device=vals.device)
        return marshal_blocks(vals, idx, n_rows)

    k1, k2 = vals.shape[-2], vals.shape[-1]
    rad = int(np.abs(dvec).max()) if nb else 0
    return LevelPartition(
        sv=gather(sv_src, p * nbmax).reshape(p * nbmax, k1, k2),
        sr=sr, sc=sc, nbmax=nbmax, rad=rad, pb=pb, pc=pc,
        sv_mar=gather(mar_src, n_rows_g),
        offsets=offsets, caps=caps, send=send, comb_idx=comb_idx,
        diag_blk=diag_blk, diag_col=diag_col,
        bnd_rows=bnd_rows, rowpos=rowpos,
        off_blk=off_blk, off_idx=off_idx, blk_idx=blk_idx,
        sv_mar_diag=gather(diag_src, n_rows_g),
        sv_mar_off=gather(off_src, p * n_bnd_cap))


# ---------------------------------------------------------------------------
# the exchange, over a Comm
# ---------------------------------------------------------------------------

def perm_of(delta: int, p: int) -> List[Tuple[int, int]]:
    """The permute that ships offset ``delta``: rank ``src`` sends to
    ``src - delta``, so each rank receives from ``rank + delta``."""
    return [(src, (src - delta) % p) for src in range(p)]


def start_halo(x: torch.Tensor, plan: HaloPlan, offsets: Sequence[int],
               comm: Comm, bf16: bool = False, backend: str = "cuda"
               ) -> List[Pending]:
    """Issue one level's packed exchanges: one ``halo_pack`` launch packs
    every offset's ``cap`` planned rows into one buffer (cast to bf16 on
    store when ``bf16``, halving the payload), then one permute per
    neighbour offset ships its slice."""
    x = x.contiguous()
    row = math.prod(x.shape[1:])
    segs, lo = [], 0
    for idx in plan.send[:len(offsets)]:
        segs.append(Segment(0, idx, lo, row))
        lo += idx.shape[0] * row
    pack = PackPlan(segs, bf16=bf16)
    with phase("halo/pack"):
        buf = torch.empty(lo, dtype=torch.bfloat16 if bf16 else x.dtype,
                          device=x.device)
        kops.halo_pack_segments(pack, [x], buf, backend)
    chunks = []
    for delta, s in zip(offsets, segs):
        packed = buf[s.off:s.off + s.idx.shape[0] * row].view(
            s.idx.shape[0], *x.shape[1:])
        with phase("halo/round"):
            chunks.append(comm.ppermute_async(packed, perm_of(delta, comm.p),
                                              tag=delta + comm.p))
    return chunks


def land_halo(x: torch.Tensor, chunks: Sequence[Pending]) -> torch.Tensor:
    """Concatenate own rows + landed chunks into the plan's buffer layout."""
    if not chunks:
        return x
    with phase("halo/round"):
        landed = [c.wait() for c in chunks]
    with phase("halo/land"):
        return torch.cat([x] + [c.to(x.dtype) for c in landed], dim=0)


def exchange(x: torch.Tensor, plan: HaloPlan, offsets: Sequence[int],
             comm: Comm, bf16: bool = False, backend: str = "cuda"
             ) -> torch.Tensor:
    """start + land in one go (no compute to overlap: the R-factor and
    projection-map exchanges of the compression sweeps)."""
    return land_halo(x, start_halo(x, plan, offsets, comm, bf16, backend))


# ---------------------------------------------------------------------------
# a cross-rank permutation as ONE all_to_all (the solver's fused
# grid<->tree transposition rounds; DESIGN.md §12)
# ---------------------------------------------------------------------------

def build_transpose_plan(g: np.ndarray, p: int
                         ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Host-side send/recv plan realizing the sharded gather
    ``y[i] = x[g[i]]`` (both ``x`` and ``y`` in contiguous ``n/p`` row
    strips) as ONE ``all_to_all`` instead of ``all_gather`` + take.

    Sender ``s`` owes receiver ``r`` only the *unique* local rows of ``s``
    that ``r``'s ``g``-slice references, padded to the global per-pair cap
    so every lane has one shape.  Returns ``(cap, send_idx, take_idx)``:

    ``cap``       per-(sender, receiver) row cap (>= 1)
    ``send_idx``  [p*p, cap] int32, sharded over senders: rank ``s``'s
                  ``[p, cap]`` slice holds, per receiver ``r``, the sorted
                  local rows to pack into its lane (padding repeats row 0,
                  never read on landing)
    ``take_idx``  [p * (n//p)] int32, sharded over receivers: positions
                  into the landed ``[p, cap]`` buffer (flattened) whose
                  row ``s`` is the lane received from sender ``s``.
    """
    g = np.asarray(g, np.int64)
    n = g.shape[0]
    if n % p:
        raise ValueError(f"transpose plan needs p | n ({n} % {p})")
    nloc = n // p
    recv = np.arange(n) // nloc
    send = g // nloc
    pair = send * p + recv                      # lane (sender, receiver)
    key = pair * nloc + (g - send * nloc)
    uniq = np.unique(key)                       # sorted by lane, then row
    counts = np.bincount(uniq // nloc, minlength=p * p)
    cap = max(1, int(counts.max()))
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    lane = uniq // nloc
    send_idx = np.zeros((p * p, cap), np.int32)
    send_idx[lane, np.arange(uniq.shape[0]) - start[lane]] = uniq % nloc
    pos = np.searchsorted(uniq, key) - start[pair]
    take_idx = (send * cap + pos).astype(np.int32)
    return cap, send_idx, take_idx


def transpose_pack(send_idx: torch.Tensor, extra: int = 0) -> PackPlan:
    """The segment table that packs a rank's ``[p, cap + extra]``
    all-to-all buffer in one ``halo_pack`` launch: lane ``r``'s ``cap``
    planned rows of the strip (rows of one element), then, when ``extra``,
    one row of ``extra`` elements of a second source ``[p, extra]``, its
    row ``r``.  ``send_idx``: the rank's ``[p, cap]`` int32 slice."""
    p, cap = send_idx.shape
    width = cap + extra
    segs = [Segment(0, send_idx[r], r * width, 1) for r in range(p)]
    if extra:
        lanes = torch.arange(p, dtype=torch.int32, device=send_idx.device)
        segs += [Segment(1, lanes[r:r + 1], r * width + cap, extra)
                 for r in range(p)]
    return PackPlan(segs)


def transpose_a2a(x: torch.Tensor, send_idx: torch.Tensor,
                  take_idx: torch.Tensor, comm: Comm,
                  extra: Optional[torch.Tensor] = None,
                  backend: str = "cuda", pack: Optional[PackPlan] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply a :func:`build_transpose_plan` permutation over ``comm``.

    ``x``: the rank's [nloc] strip (float32); ``send_idx``/``take_idx``:
    the rank's plan slices ([p, cap] / [nloc]).  ``extra`` optionally
    appends per-receiver side-channel rows ``[p, e]`` onto the payload
    lanes (the C-stencil row halo rides the solve's transpose-in round).
    The lanes are packed by ``ops.halo_pack_segments`` (``pack``: the
    table of :func:`transpose_pack`, built here when not given): one
    launch on the card under ``backend="cuda"``, ``index_select`` per lane
    otherwise -- the same gather, so the two agree bitwise.  Returns ``(y,
    extra_landed)`` where ``extra_landed[s]`` is the extra row sender
    ``s`` addressed to this rank (``None`` without ``extra``).
    """
    p, cap = send_idx.shape
    e = 0 if extra is None else extra.shape[1]
    if pack is None:
        pack = transpose_pack(send_idx, e)
    srcs = [x.contiguous()] + ([] if extra is None
                               else [extra.to(x.dtype).contiguous()])
    with phase("halo/pack"):
        buf = torch.empty((p, cap + e), dtype=x.dtype, device=x.device)
        kops.halo_pack_segments(pack, srcs, buf.view(-1), backend)
    with phase("halo/round"):
        land = comm.all_to_all(buf)
    with phase("halo/land"):
        y = land[:, :cap].reshape(p * cap).index_select(0, take_idx)
    return y, (land[:, cap:] if extra is not None else None)
