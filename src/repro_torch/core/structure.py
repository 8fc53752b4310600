"""Static structure + runtime data layout of an H^2 matrix (torch tensors).

The *structure* (which blocks exist, at which level, block counts, ranks) is
the small frozen ``H2Shape``.  The *index arrays* (rows/cols of coupling and
dense blocks, the marshaling plan) and the *value arrays* (bases U/V,
transfers E/F, coupling S, dense leaves) are tensors in ``H2Data``.

Naming follows the paper (Table 1):
  U, V   row / column basis trees (leaf bases stored explicitly)
  E, F   interlevel transfer matrices of U / V
  S      coupling-matrix tree (one block-sparse matrix per level)
  A_de   dense leaf blocks at the finest level

Marshaling plan: per level, the conflict-free padded slot layout
``rows x maxb`` as int32 ``slot -> S-block`` / ``slot -> source node`` index
tensors plus per-row slot counts, built once at construction.  Padding slots
carry the sentinel block index ``nb``.  ``H2Data`` also carries the
row-marshaled value buffers ``s_mar[l]: [rows, k, maxb*k]`` (zero blocks in
padding slots) and ``dense_mar``, used by the plain ``backend="torch"``
matvec and the compression sweeps.

A symmetric operator shares one basis tree: ``v_leaf is u_leaf`` and
``f[l] is e[l]``.  Eager PyTorch never breaks that alias, so every pass that
checks it factors one tree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class H2Shape:
    """Static description of an H^2 matrix (hashable)."""

    n: int                      # matrix dimension
    leaf_size: int              # m
    depth: int                  # leaf level index; level l has 2**l nodes
    ranks: Tuple[int, ...]      # rank k[l] for l = 0..depth
    coupling_counts: Tuple[int, ...]  # number of S blocks per level
    dense_count: int            # number of dense leaf blocks
    symmetric: bool = True      # V tree == U tree structure (kernel symmetric)
    row_maxb: Optional[Tuple[int, ...]] = None
    col_maxb: Optional[Tuple[int, ...]] = None
    dense_maxb: Optional[int] = None   # max dense blocks per leaf block-row

    @property
    def n_leaves(self) -> int:
        return 1 << self.depth

    def nodes(self, level: int) -> int:
        return 1 << level

    def memory_lowrank(self) -> int:
        """Number of scalars in the low-rank part (bases+transfers+couplings)."""
        m = self.leaf_size
        tot = self.n_leaves * m * self.ranks[self.depth] * (1 if self.symmetric else 2)
        for l in range(1, self.depth + 1):
            tot += self.nodes(l) * self.ranks[l] * self.ranks[l - 1] * (
                1 if self.symmetric else 2)
        for l in range(self.depth + 1):
            tot += self.coupling_counts[l] * self.ranks[l] * self.ranks[l]
        return tot

    def memory_dense(self) -> int:
        return self.dense_count * self.leaf_size * self.leaf_size


@dataclasses.dataclass
class CouplingPlan:
    """Marshaling plan for the block-sparse phases (int32 tensors).

    Block row ``r`` of level ``l`` owns slots ``r*maxb .. r*maxb + maxb-1``
    (``maxb = row_maxb[l]``).  Padding slots carry the sentinel block index
    ``nb`` (one past the end) and source node 0.  ``cblk`` is the
    column-grouped twin used by the compression column sweep.
    """

    sblk: List[torch.Tensor]   # [2**l * row_maxb_l] slot -> S-block (nb = pad)
    scol: List[torch.Tensor]   # [2**l * row_maxb_l] slot -> xhat source node
    scnt: List[torch.Tensor]   # [2**l] blocks per block-row
    cblk: List[torch.Tensor]   # [2**l * col_maxb_l] column-grouped slot -> S-block
    dblk: torch.Tensor         # [2**depth * dense_maxb] slot -> dense block
    dcol: torch.Tensor         # [2**depth * dense_maxb] slot -> x source leaf
    dcnt: torch.Tensor         # [2**depth] dense blocks per leaf row


def build_slot_plan(rows: np.ndarray, cols: np.ndarray, n_rows: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """One level's padded slot layout from a (row-sorted) block list.

    Returns ``(blk, col, cnt, maxb)`` with ``blk``/``col`` of shape
    ``[n_rows * maxb]``; padding slots get ``blk = len(rows)`` and
    ``col = 0``.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    cnt = np.bincount(rows, minlength=n_rows).astype(np.int32) if rows.size \
        else np.zeros(n_rows, np.int32)
    maxb = int(cnt.max()) if rows.size else 0
    blk = np.full(n_rows * maxb, rows.shape[0], np.int32)
    col = np.zeros(n_rows * maxb, np.int32)
    if rows.size:
        starts = np.searchsorted(rows, np.arange(n_rows))
        pos = np.arange(rows.shape[0]) - starts[rows]
        slots = rows * maxb + pos
        blk[slots] = np.arange(rows.shape[0], dtype=np.int32)
        col[slots] = cols
    return blk, col, cnt, maxb


def build_coupling_plan(depth: int, s_rows: Sequence[np.ndarray],
                        s_cols: Sequence[np.ndarray], d_rows: np.ndarray,
                        d_cols: np.ndarray, device="cpu") -> CouplingPlan:
    """Host-side plan construction from the admissibility block lists
    (sorted by (row, col)); the tensors are placed on ``device``."""
    def dev(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    sblk, scol, scnt, cblk = [], [], [], []
    for l in range(depth + 1):
        nn = 1 << l
        rows = np.asarray(s_rows[l])
        cols = np.asarray(s_cols[l])
        b, c, n, _ = build_slot_plan(rows, cols, nn)
        sblk.append(dev(b))
        scol.append(dev(c))
        scnt.append(dev(n))
        order = np.lexsort((rows, cols))
        b, _, _, _ = build_slot_plan(cols[order], rows[order], nn)
        pad = b == order.shape[0]
        b = order.astype(np.int32)[np.minimum(b, max(order.shape[0] - 1, 0))] \
            if order.size else b
        b = np.where(pad, np.int32(order.shape[0]), b)
        cblk.append(dev(b))
    db, dc, dn, _ = build_slot_plan(np.asarray(d_rows), np.asarray(d_cols),
                                    1 << depth)
    return CouplingPlan(sblk=sblk, scol=scol, scnt=scnt, cblk=cblk,
                        dblk=dev(db), dcol=dev(dc), dcnt=dev(dn))


def _take_fill(blocks: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """``blocks[blk]`` with the sentinel ``blk == nb`` read as a zero block
    (a gather of clamped indices, the sentinel rows then zeroed: no
    data-dependent shape, so it also runs on ``meta`` tensors)."""
    nb = blocks.shape[0]
    if not nb:
        return blocks.new_zeros((blk.shape[0],) + tuple(blocks.shape[1:]))
    idx = blk.long()
    g = blocks.index_select(0, idx.clamp(max=nb - 1))
    valid = (idx < nb).reshape(-1, *([1] * (blocks.dim() - 1)))
    return torch.where(valid, g, g.new_zeros(()))


def marshal_blocks(blocks: torch.Tensor, blk: torch.Tensor, n_rows: int
                   ) -> torch.Tensor:
    """Gather ``[nb, k1, k2]`` blocks into the row-marshaled stacked form
    ``[n_rows, k1, maxb*k2]`` (zero padding slots)."""
    k1, k2 = blocks.shape[-2], blocks.shape[-1]
    maxb = blk.shape[0] // max(n_rows, 1)
    g = _take_fill(blocks, blk)
    return g.reshape(n_rows, maxb, k1, k2).permute(0, 2, 1, 3).reshape(
        n_rows, k1, maxb * k2)


def stack_blocks_by_plan(blocks: torch.Tensor, blk: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """Gather ``[nb, k1, k2]`` blocks into the vertically stacked form
    ``[n_rows, maxb*k1, k2]`` (the compression-sweep layout)."""
    k1, k2 = blocks.shape[-2], blocks.shape[-1]
    maxb = blk.shape[0] // max(n_rows, 1)
    return _take_fill(blocks, blk).reshape(n_rows, maxb * k1, k2)


@dataclasses.dataclass
class H2Data:
    """Runtime tensors of an H^2 matrix.

    Per-level lists are indexed by level ``l``; levels without data hold
    zero-size tensors.  Every operator carries its ``plan``; refresh the
    marshaled buffers ``s_mar`` and ``dense_mar`` with ``remarshal`` after
    rewriting S.
    """

    u_leaf: torch.Tensor                 # [2**depth, m, k_leaf]
    v_leaf: torch.Tensor                 # alias of u_leaf for symmetric
    e: List[torch.Tensor]                # e[l]: [2**l, k_l, k_{l-1}] (e[0] empty)
    f: List[torch.Tensor]                # same for V tree
    s: List[torch.Tensor]                # s[l]: [nb_l, k_l, k_l]
    s_rows: List[torch.Tensor]           # [nb_l] int32 block-row (node) index
    s_cols: List[torch.Tensor]           # [nb_l] int32 block-col (node) index
    dense: torch.Tensor                  # [nbd, m, m]
    d_rows: torch.Tensor                 # [nbd] int32
    d_cols: torch.Tensor                 # [nbd] int32
    plan: CouplingPlan
    s_mar: Optional[List[torch.Tensor]] = None   # [2**l, k_l, maxb_l*k_l]
    dense_mar: Optional[torch.Tensor] = None     # [2**depth, m, dense_maxb*m]

    def nbytes(self) -> int:
        """Bytes of every distinct tensor (aliases counted once)."""
        seen, tot = set(), 0
        for t in _tensors(self):
            if id(t) not in seen:
                seen.add(id(t))
                tot += t.numel() * t.element_size()
        return tot


def _tensors(data: H2Data) -> List[torch.Tensor]:
    out = [data.u_leaf, data.v_leaf, *data.e, *data.f, *data.s,
           *data.s_rows, *data.s_cols, data.dense, data.d_rows, data.d_cols]
    p = data.plan
    if p is not None:
        out += [*p.sblk, *p.scol, *p.scnt, *p.cblk, p.dblk, p.dcol, p.dcnt]
    if data.s_mar is not None:
        out += list(data.s_mar)
    if data.dense_mar is not None:
        out.append(data.dense_mar)
    return out


def remarshal(data: H2Data, dense: bool = True) -> H2Data:
    """Refresh the marshaled S (and optionally dense) buffers from the
    block lists."""
    depth = len(data.e) - 1
    s_mar = [marshal_blocks(data.s[l], data.plan.sblk[l], 1 << l)
             for l in range(depth + 1)]
    dense_mar = marshal_blocks(data.dense, data.plan.dblk,
                               data.u_leaf.shape[0]) if dense or \
        data.dense_mar is None else data.dense_mar
    return dataclasses.replace(data, s_mar=s_mar, dense_mar=dense_mar)


def shape_of(data: H2Data, leaf_size: int, symmetric: bool = True) -> H2Shape:
    """Recover the static H2Shape from an H2Data (the plan's padded slot
    layout gives ``row_maxb``/``col_maxb``/``dense_maxb``)."""
    depth = len(data.e) - 1
    ranks = [0] * (depth + 1)
    ranks[depth] = data.u_leaf.shape[-1]
    for l in range(depth, 0, -1):
        ranks[l - 1] = data.e[l].shape[-1]
    counts = tuple(int(data.s[l].shape[0]) for l in range(depth + 1))
    n = data.u_leaf.shape[0] * leaf_size
    row_maxb = tuple(int(data.plan.sblk[l].shape[0]) >> l
                     for l in range(depth + 1))
    col_maxb = tuple(int(data.plan.cblk[l].shape[0]) >> l
                     for l in range(depth + 1))
    dense_maxb = int(data.plan.dblk.shape[0]) >> depth
    return H2Shape(n=n, leaf_size=leaf_size, depth=depth, ranks=tuple(ranks),
                   coupling_counts=counts, dense_count=int(data.dense.shape[0]),
                   symmetric=symmetric, row_maxb=row_maxb, col_maxb=col_maxb,
                   dense_maxb=dense_maxb)


def zeros_data(shape: H2Shape, dtype=torch.float32, device="cuda") -> H2Data:
    """Zero-initialized tensors matching ``shape`` (tests/bench), plan and
    marshaled buffers included; ``shape`` must carry the marshaling statics
    (``row_maxb``, ``col_maxb``, ``dense_maxb``), as a constructed one does."""
    if None in (shape.row_maxb, shape.col_maxb, shape.dense_maxb):
        raise ValueError("zeros_data needs a shape with row_maxb, col_maxb "
                         "and dense_maxb")

    def z(*dims, dt=dtype):
        return torch.zeros(dims, dtype=dt, device=device)

    i32 = torch.int32
    m, nl, depth = shape.leaf_size, shape.n_leaves, shape.depth
    e = [z(0, 0, 0)] + [z(shape.nodes(l), shape.ranks[l], shape.ranks[l - 1])
                        for l in range(1, depth + 1)]
    f = [z(*t.shape) for t in e]
    nbs = shape.coupling_counts
    rng = range(depth + 1)
    plan = CouplingPlan(
        sblk=[z(shape.nodes(l) * shape.row_maxb[l], dt=i32) for l in rng],
        scol=[z(shape.nodes(l) * shape.row_maxb[l], dt=i32) for l in rng],
        scnt=[z(shape.nodes(l), dt=i32) for l in rng],
        cblk=[z(shape.nodes(l) * shape.col_maxb[l], dt=i32) for l in rng],
        dblk=z(nl * shape.dense_maxb, dt=i32),
        dcol=z(nl * shape.dense_maxb, dt=i32), dcnt=z(nl, dt=i32))
    s_mar = [z(shape.nodes(l), shape.ranks[l],
               shape.row_maxb[l] * shape.ranks[l]) for l in rng]
    dense_mar = z(nl, m, shape.dense_maxb * m)
    return H2Data(
        u_leaf=z(nl, m, shape.ranks[depth]), v_leaf=z(nl, m, shape.ranks[depth]),
        e=e, f=f, s=[z(nbs[l], shape.ranks[l], shape.ranks[l])
                     for l in range(depth + 1)],
        s_rows=[z(nbs[l], dt=i32) for l in range(depth + 1)],
        s_cols=[z(nbs[l], dt=i32) for l in range(depth + 1)],
        dense=z(shape.dense_count, m, m),
        d_rows=z(shape.dense_count, dt=i32), d_cols=z(shape.dense_count, dt=i32),
        plan=plan, s_mar=s_mar, dense_mar=dense_mar)


def abstract_data(shape: H2Shape, dtype=torch.float32, device="meta"
                  ) -> H2Data:
    """Stand-ins for every tensor of the operator ``shape`` describes, on
    ``device`` (``meta`` by default: shapes and dtypes, nothing allocated)
    -- the dry run's counterpart of the reference's ``ShapeDtypeStruct``
    tree.  The shapes are those ``construct_h2`` gives; a symmetric shape
    shares one basis tree, as a constructed operator does.  When the shape
    carries the marshaling statics (``row_maxb``, ``col_maxb``,
    ``dense_maxb``) the plan and the marshaled buffers are described too,
    else they are None."""
    if None not in (shape.row_maxb, shape.col_maxb, shape.dense_maxb):
        data = zeros_data(shape, dtype, device)
    else:
        def z(*dims, dt=dtype):
            return torch.zeros(dims, dtype=dt, device=device)
        rng = range(shape.depth + 1)
        m, k, nbs = shape.leaf_size, shape.ranks[shape.depth], \
            shape.coupling_counts
        e = [z(0, 0, 0)] + [z(shape.nodes(l), shape.ranks[l],
                              shape.ranks[l - 1])
                            for l in range(1, shape.depth + 1)]
        data = H2Data(
            u_leaf=z(shape.n_leaves, m, k), v_leaf=z(shape.n_leaves, m, k),
            e=e, f=[z(*t.shape) for t in e],
            s=[z(nbs[l], shape.ranks[l], shape.ranks[l]) for l in rng],
            s_rows=[z(nbs[l], dt=torch.int32) for l in rng],
            s_cols=[z(nbs[l], dt=torch.int32) for l in rng],
            dense=z(shape.dense_count, m, m),
            d_rows=z(shape.dense_count, dt=torch.int32),
            d_cols=z(shape.dense_count, dt=torch.int32), plan=None)
    if shape.symmetric:
        data.v_leaf, data.f = data.u_leaf, list(data.e)
    return data


# ---------------------------------------------------------------------------
# carry-across: a flat dict of numpy arrays <-> H2Data
# ---------------------------------------------------------------------------

_PLAN_LISTS = ("sblk", "scol", "scnt", "cblk")
_PLAN_LEAVES = ("dblk", "dcol", "dcnt")


def data_to_numpy(data: H2Data) -> Dict[str, np.ndarray]:
    """Flatten an H2Data into ``{name: ndarray}``.

    Keys: ``u_leaf``, ``dense``, ``d_rows``, ``d_cols``, ``dense_mar``,
    ``e/<l>``, ``s/<l>``, ``s_rows/<l>``, ``s_cols/<l>``, ``s_mar/<l>``,
    ``plan/<field>/<l>`` and ``plan/<dblk|dcol|dcnt>``.  The V tree
    (``v_leaf``, ``f/<l>``) is written only when it is not an alias of the
    U tree; its absence means "symmetric, one shared tree".
    """
    def np_(t):
        return t.detach().cpu().numpy()

    out: Dict[str, np.ndarray] = {"u_leaf": np_(data.u_leaf),
                                  "dense": np_(data.dense),
                                  "d_rows": np_(data.d_rows),
                                  "d_cols": np_(data.d_cols)}
    aliased = data.v_leaf is data.u_leaf and all(
        a is b for a, b in zip(data.f, data.e))
    if not aliased:
        out["v_leaf"] = np_(data.v_leaf)
    for l in range(len(data.e)):
        out[f"e/{l}"] = np_(data.e[l])
        if not aliased:
            out[f"f/{l}"] = np_(data.f[l])
        out[f"s/{l}"] = np_(data.s[l])
        out[f"s_rows/{l}"] = np_(data.s_rows[l])
        out[f"s_cols/{l}"] = np_(data.s_cols[l])
    for name in _PLAN_LISTS:
        for l, t in enumerate(getattr(data.plan, name)):
            out[f"plan/{name}/{l}"] = np_(t)
    for name in _PLAN_LEAVES:
        out[f"plan/{name}"] = np_(getattr(data.plan, name))
    if data.s_mar is not None:
        for l, t in enumerate(data.s_mar):
            out[f"s_mar/{l}"] = np_(t)
    if data.dense_mar is not None:
        out["dense_mar"] = np_(data.dense_mar)
    return out


def data_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> H2Data:
    """Inverse of ``data_to_numpy``: build an H2Data on ``device``.

    Without ``v_leaf``/``f/<l>`` keys the V tree aliases the U tree
    (``v_leaf is u_leaf``, ``f[l] is e[l]``).  Without ``plan/...`` keys
    the plan is built from the (row-sorted) block lists, and without
    ``s_mar/<l>``/``dense_mar`` the marshaled buffers are gathered by it.
    """
    def t(key):
        return torch.tensor(np.asarray(arrays[key]), device=device)

    depth = max(int(k.split("/")[1]) for k in arrays if k.startswith("e/"))
    levels = range(depth + 1)
    u_leaf = t("u_leaf")
    e = [t(f"e/{l}") for l in levels]
    if "v_leaf" in arrays:
        v_leaf, f = t("v_leaf"), [t(f"f/{l}") for l in levels]
    else:
        v_leaf, f = u_leaf, list(e)
    if "plan/dblk" in arrays:
        plan = CouplingPlan(
            **{n: [t(f"plan/{n}/{l}") for l in levels] for n in _PLAN_LISTS},
            **{n: t(f"plan/{n}") for n in _PLAN_LEAVES})
    else:
        plan = build_coupling_plan(
            depth, [arrays[f"s_rows/{l}"] for l in levels],
            [arrays[f"s_cols/{l}"] for l in levels], arrays["d_rows"],
            arrays["d_cols"], device=device)
    data = H2Data(
        u_leaf=u_leaf, v_leaf=v_leaf, e=e, f=f,
        s=[t(f"s/{l}") for l in levels],
        s_rows=[t(f"s_rows/{l}") for l in levels],
        s_cols=[t(f"s_cols/{l}") for l in levels],
        dense=t("dense"), d_rows=t("d_rows"), d_cols=t("d_cols"),
        plan=plan,
        s_mar=[t(f"s_mar/{l}") for l in levels] if "s_mar/0" in arrays
        else None,
        dense_mar=t("dense_mar") if "dense_mar" in arrays else None)
    if data.s_mar is None or data.dense_mar is None:
        data = remarshal(data, dense=data.dense_mar is None)
    return data


def dist_data_from_numpy(arrays: Dict[str, np.ndarray], device="cuda"):
    """A ``dist.DistH2Data`` on ``device`` from the flat dict of a
    partitioned operator (for instance the reference's ``partition_h2``
    output as numpy), so the distributed path can run on exactly that
    partition.

    Keys: ``<field>`` for a tensor field, ``<field>/<i>`` for a list
    field, ``<plan>/<name>`` and ``<plan>/send/<j>`` for a halo plan, and
    ``hp_br/<i>/<name>``, ``hp_br/<i>/send/<j>`` for the branch plans.
    Without ``v_leaf``/``f_br/<i>``/``f_top/<l>`` keys the V tree aliases
    the U tree.
    """
    from .dist import DistH2Data
    from .halo import PLAN_FIELDS, HaloPlan

    def t(key):
        return torch.tensor(np.asarray(arrays[key]), device=device)

    def listed(name):
        n = sum(1 for k in arrays if k.startswith(name + "/") and
                k.count("/") == 1)
        return [t(f"{name}/{i}") for i in range(n)]

    def plan(prefix):
        n = sum(1 for k in arrays if k.startswith(prefix + "/send/"))
        return HaloPlan(send=[t(f"{prefix}/send/{j}") for j in range(n)],
                        **{f: t(f"{prefix}/{f}") for f in PLAN_FIELDS})

    n_br = sum(1 for k in arrays if k.startswith("hp_br/") and
               k.endswith("/comb_idx"))
    fields = {}
    for f in dataclasses.fields(DistH2Data):
        if f.name == "hp_br":
            fields[f.name] = [plan(f"hp_br/{i}") for i in range(n_br)]
        elif f.name == "hp_dense":
            fields[f.name] = plan("hp_dense")
        elif f.name in arrays:
            fields[f.name] = t(f.name)
        elif f.name not in ("v_leaf", "f_br", "f_top"):
            fields[f.name] = listed(f.name)
    fields["v_leaf"] = t("v_leaf") if "v_leaf" in arrays else \
        fields["u_leaf"]
    for f, e in (("f_br", "e_br"), ("f_top", "e_top")):
        fields[f] = listed(f) if f"{f}/0" in arrays else list(fields[e])
    return DistH2Data(**fields)
