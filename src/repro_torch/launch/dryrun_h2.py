"""Dry run of the paper's own workloads on the production layouts, the
port of the reference's ``launch/dryrun_h2.py``: the per-rank cost of the
distributed HGEMV, its compression and one PCG iteration at the paper's
§6.2 load (2^19 rows per device).

The block structure is *measured* on a probe tree of moderate depth and
extrapolated level by level (``measured_structure_stats``,
``synth_dist_shape``: the reference's numpy code, equal results): interior
block rows of a regular grid are translation-invariant, so the per-level
counts converge to C_sp-bounded constants (paper §2.1).

Where the reference lowers and compiles one ``shard_map`` program over 512
fake XLA devices, the port walks ONE rank's local program on the ``meta``
device: every tensor has its shape and dtype and nothing is allocated.
``abstract_dist_data`` is that rank's view (what ``core.dist.local_shard``
would hand it), ``core.comm.DryComm`` stands in for its process group (collectives
return meta tensors of the landed shape and count their bytes as ``Comm``
does, so the totals compare with ``matvec_comm_bytes``), and
``perf.op_cost`` counts the dispatched operators.  The walk runs the plain
backend (``backend="torch"``: the kernels never reach the dispatcher, and
``op_cost`` raises if one launches) and the program the real path runs:
no value is read on the host, so the index plans need only their sizes.

    python -m repro_torch.launch.dryrun_h2 --rows-log2 14 --out dry.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.admissibility import build_block_structure
from repro_torch.core.clustering import build_cluster_tree, \
    regular_grid_points
from repro_torch.core.comm import DryComm
from repro_torch.core.dist import DistH2Data, DistH2Shape, \
    dist_compress_local, dist_h2_matvec_local, matvec_comm_bytes
from repro_torch.core.halo import HaloPlan
from repro_torch.perf import op_cost
from repro_torch.solvers.distributed import krylov_comm_bytes

from .mesh import MeshLayout, h2_ranks, production_layout

CELLS = {"matvec1": ("matvec", 1), "matvec64": ("matvec", 64),
         "compress": ("compress", 1), "pcg": ("pcg", 1)}
MATVEC_MODES = ("halo-plan", "ppermute", "allgather")
PCG_PROLOGUE_PSUMS = 3        # scalars psum'd before the first iteration


def measured_structure_stats(dim: int, depth_probe: int = 9, m: int = 64,
                             eta: float = 0.9) -> Dict:
    """Per-level (blocks/row, halo radius) constants from a probe tree."""
    n = m * (1 << depth_probe)
    if dim == 2:
        side = int(np.sqrt(n))
    else:
        side = int(round(n ** (1 / 3)))
    pts = regular_grid_points(side, dim)
    # pad/trim to n by tiling the grid slightly larger then trimming
    if pts.shape[0] < n:
        reps = int(np.ceil(n / pts.shape[0]))
        pts = np.concatenate([pts + i * 1.5 for i in range(reps)])[:n]
    else:
        pts = pts[:n]
    tree = build_cluster_tree(pts, m)
    bs = build_block_structure(tree, eta)
    per_row = [bs.s_rows[l].shape[0] / (1 << l)
               for l in range(tree.depth + 1)]
    dense_per_row = bs.d_rows.shape[0] / (1 << tree.depth)
    return {"per_row": per_row, "dense_per_row": dense_per_row,
            "row_maxb": list(bs.row_maxb()), "Csp": bs.sparsity_constant()}


def synth_dist_shape(p: int, depth: int, m: int, k: int, stats: Dict
                     ) -> DistH2Shape:
    """Extrapolate the probe stats to a depth-``depth`` tree on p ranks."""
    lc = int(np.log2(p))
    per_row = stats["per_row"]
    maxb = stats["row_maxb"]

    def level_stat(arr, l, default):
        # deep levels converge to the probe's deepest interior level
        if l < len(arr):
            return arr[l]
        return arr[-2] if len(arr) > 1 else default

    br_counts, br_rad, row_maxb = [], [], []
    br_offsets, br_caps = [], []
    for l in range(depth + 1):
        row_maxb.append(int(level_stat(maxb, l, 8)) or 0)
    for l in range(lc, depth + 1):
        nloc = (1 << l) // p
        cnt = int(np.ceil(level_stat(per_row, l, 6) * nloc))
        br_counts.append(max(cnt, 1))
        rad = 1 if l > lc else min(2, p - 1)
        br_rad.append(rad)
        # compressed-plan statics: boundary-band send caps per offset (the
        # interior of a regular grid never crosses ranks, so the packed
        # rows per neighbour are O(row_maxb), independent of nloc)
        offs = tuple(d for d in range(-rad, rad + 1) if d != 0)
        cap = min(nloc, max(row_maxb[l], 1))
        br_offsets.append(offs)
        br_caps.append(tuple([cap] * len(offs)))
    top_counts = tuple(int(np.ceil(level_stat(per_row, l, 0) * (1 << l)))
                       for l in range(lc))
    nbd = max(int(np.ceil(stats["dense_per_row"] * ((1 << depth) // p))), 1)
    dense_maxb = max(int(np.ceil(stats["dense_per_row"])), 1)
    nl_loc = (1 << depth) // p
    return DistH2Shape(
        n=m * (1 << depth), leaf_size=m, depth=depth,
        ranks=tuple([k] * (depth + 1)), p=p, lc=lc,
        br_counts=tuple(br_counts), br_radius=tuple(br_rad),
        top_counts=top_counts, dense_count=nbd, dense_radius=1,
        row_maxb=tuple(row_maxb), symmetric=True,
        dense_maxb=dense_maxb,
        br_offsets=tuple(br_offsets), br_caps=tuple(br_caps),
        dense_offsets=(-1, 1),
        dense_caps=(min(nl_loc, dense_maxb), min(nl_loc, dense_maxb)))


def abstract_dist_data(ds: DistH2Shape, dtype=torch.float32,
                       device="meta") -> DistH2Data:
    """ONE rank's view of the partitioned operator (what
    ``core.dist.local_shard`` hands a rank: sharded fields cut to its
    block rows, replicated top levels whole) as tensors on ``device``,
    sized by the reference's static rules (``abstract_dist_data``, whose
    sharded fields carry the leading ``p``).  A symmetric operator: one
    basis tree."""
    i32 = torch.int32

    def z(*dims, dt=dtype):
        return torch.zeros(dims, dtype=dt, device=device)

    m, p, lc, depth = ds.leaf_size, ds.p, ds.lc, ds.depth
    k = ds.ranks[0]
    nl_loc = ds.leaves_per_dev
    br = list(enumerate(range(lc, depth + 1)))
    e_br = [z(1, 0, 0)] + [z(ds.nodes_local(l), k, k)
                           for l in range(lc + 1, depth + 1)]
    e_top = [z(0, 0, 0)] + [z(1 << l, k, k) for l in range(1, lc + 1)]
    hp_br, s_br_mar_diag, s_br_mar_off = [], [], []
    for i, l in br:
        nloc = ds.nodes_local(l)
        maxb = max(ds.row_maxb[l], 1)
        # interior rows of a regular grid are diagonal-only: the off twin
        # spans the boundary rows (bounded by the summed send caps) and the
        # diag twin keeps the full slot width
        n_bnd = min(nloc, sum(ds.br_caps[i]))
        maxb_o = min(maxb, 4)
        hp_br.append(HaloPlan(
            send=[z(cap, dt=i32) for cap in ds.br_caps[i]],
            comb_idx=z(nloc * maxb, dt=i32), diag_blk=z(nloc * maxb, dt=i32),
            diag_col=z(nloc * maxb, dt=i32), bnd_rows=z(n_bnd, dt=i32),
            rowpos=z(nloc, dt=i32), off_blk=z(n_bnd * maxb_o, dt=i32),
            off_idx=z(n_bnd * maxb_o, dt=i32),
            blk_idx=z(ds.br_counts[i], dt=i32)))
        s_br_mar_diag.append(z(nloc, k, maxb * k))
        s_br_mar_off.append(z(n_bnd, k, maxb_o * k))
    d_bnd = min(nl_loc, sum(ds.dense_caps))
    dmaxb_o = min(ds.dense_maxb, 4)
    hp_dense = HaloPlan(
        send=[z(cap, dt=i32) for cap in ds.dense_caps],
        comb_idx=z(nl_loc * ds.dense_maxb, dt=i32),
        diag_blk=z(nl_loc * ds.dense_maxb, dt=i32),
        diag_col=z(nl_loc * ds.dense_maxb, dt=i32),
        bnd_rows=z(d_bnd, dt=i32), rowpos=z(nl_loc, dt=i32),
        off_blk=z(d_bnd * dmaxb_o, dt=i32), off_idx=z(d_bnd * dmaxb_o, dt=i32),
        blk_idx=z(ds.dense_count, dt=i32))
    u_leaf = z(nl_loc, m, k)
    return DistH2Data(
        u_leaf=u_leaf, v_leaf=u_leaf, e_br=e_br, f_br=list(e_br),
        s_br=[z(ds.br_counts[i], k, k) for i, _ in br],
        s_br_rows=[z(ds.br_counts[i], dt=i32) for i, _ in br],
        s_br_cols=[z(ds.br_counts[i], dt=i32) for i, _ in br],
        e_top=e_top, f_top=list(e_top),
        s_top=[z(ds.top_counts[l], k, k) for l in range(lc)],
        s_top_rows=[z(ds.top_counts[l], dt=i32) for l in range(lc)],
        s_top_cols=[z(ds.top_counts[l], dt=i32) for l in range(lc)],
        dense=z(ds.dense_count, m, m), d_rows=z(ds.dense_count, dt=i32),
        d_cols=z(ds.dense_count, dt=i32),
        pb_blk=[z(ds.nodes_local(l) * max(ds.row_maxb[l], 1), dt=i32)
                for _, l in br],
        pb_col=[z(ds.nodes_local(l) * max(ds.row_maxb[l], 1), dt=i32)
                for _, l in br],
        s_br_mar=[z(ds.nodes_local(l), k, max(ds.row_maxb[l], 1) * k)
                  for _, l in br],
        pt_blk=[z((1 << l) * ds.row_maxb[l], dt=i32) for l in range(lc)],
        pt_col=[z((1 << l) * ds.row_maxb[l], dt=i32) for l in range(lc)],
        s_top_mar=[z(1 << l, k, ds.row_maxb[l] * k) for l in range(lc)],
        pd_col=z(nl_loc * ds.dense_maxb, dt=i32),
        dense_mar=z(nl_loc, m, ds.dense_maxb * m),
        hp_br=hp_br, hp_dense=hp_dense,
        s_br_mar_diag=s_br_mar_diag, s_br_mar_off=s_br_mar_off,
        dense_mar_diag=z(nl_loc, m, ds.dense_maxb * m),
        dense_mar_off=z(d_bnd, m, dmaxb_o * m))


def resident_bytes(d) -> int:
    """Bytes of every distinct tensor of a rank's data (aliases once)."""
    seen, tot = set(), 0

    def walk(v):
        nonlocal tot
        if isinstance(v, torch.Tensor):
            if id(v) not in seen:
                seen.add(id(v))
                tot += v.numel() * v.element_size()
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
    walk(d)
    return tot


def cell_shape(layout: MeshLayout, dim: int,
               per_dev_rows_log2: int = 19, m: int = 64, k: int = 64,
               depth_probe: int = 9,
               stats: Optional[Dict] = None) -> Tuple[DistH2Shape, Dict]:
    """The synthesized operator of a layout: p = its data axes, 2^rows
    rows per rank (the reference's depth rule)."""
    p = h2_ranks(layout)
    if stats is None:
        stats = measured_structure_stats(dim, depth_probe, m)
    depth = int(np.log2(p)) + per_dev_rows_log2 - int(np.log2(m))
    return synth_dist_shape(p, depth, m, k, stats), stats


def _walk(kind: str, ds: DistH2Shape, d: DistH2Data, comm: DryComm,
          nv: int, mode: str):
    """The rank's local program of one cell, as a thunk."""
    dev = d.u_leaf.device
    if kind == "matvec":
        x = torch.zeros((ds.n_local(), nv), device=dev)
        return lambda: dist_h2_matvec_local(ds, d, x, comm, mode,
                                            backend="torch")
    if kind == "pcg":
        from repro_torch.solvers import pcg_init, pcg_segment

        def apply_a(v):
            return dist_h2_matvec_local(ds, d, v[:, None], comm, mode,
                                        backend="torch")[:, 0]
        b = torch.zeros((ds.n_local(),), device=dev)

        def one_iteration():
            # the reference's per-iteration lower bound: the prologue and
            # the loop body once
            st = pcg_init(apply_a, b, comm=comm)
            return pcg_segment(apply_a, b, st, tol=1e-6, steps=1,
                               maxiter=1, graph=False, comm=comm)
        return one_iteration
    if kind == "compress":
        tgt = tuple([max(ds.ranks[0] // 4, 8)] * (ds.depth + 1))
        return lambda: dist_compress_local(ds, d, tgt, comm, backend="torch")
    raise ValueError(f"unknown cell kind {kind!r}")


def dry_cell(kind: str, dim: int, nv: int, layout: MeshLayout,
             per_dev_rows_log2: int = 19, m: int = 64, k: int = 64,
             mode: str = "halo-plan", rank: int = 0, depth_probe: int = 9,
             stats: Optional[Dict] = None) -> Dict:
    """Rank ``rank``'s cost of one cell on ``layout``: ``kind`` one of
    ``matvec`` (``nv`` right-hand sides, comm ``mode``), ``compress``
    (static target ranks k/4, as the reference) or ``pcg`` (one
    iteration).  Returns flops, bytes, matmul flops, collective bytes by
    kind, the rank's resident bytes, the walk's wall seconds and the
    communication model."""
    ds, stats = cell_shape(layout, dim, per_dev_rows_log2, m, k,
                           depth_probe, stats)
    comm = DryComm(rank, ds.p)
    d = abstract_dist_data(ds)
    fn = _walk(kind, ds, d, comm, nv, mode)
    t0 = time.perf_counter()
    per_op = op_cost.count_ops(fn)
    walk_s = time.perf_counter() - t0
    name = f"h2-{dim}d-{kind}" + (f"-nv{nv}" if kind == "matvec" else "")
    res = {"cell": name, "layout": dict(zip(layout.axes, layout.shape)),
           "p": ds.p, "rank": rank, "n": ds.n, "n_local": ds.n_local(),
           "depth": ds.depth, "k": k, "m": m, "nv": nv,
           "comm": mode if kind != "compress" else None,
           "flops": sum(r["flops"] for r in per_op.values()),
           "bytes": sum(r["bytes"] for r in per_op.values()),
           "matmul_flops": op_cost.matmul_flops(per_op),
           "collectives": dict(comm.recv_by_kind),
           "resident_bytes": resident_bytes(d),
           "walk_s": walk_s, "Csp": stats["Csp"]}
    if kind == "matvec":
        res["model_comm_bytes"] = matvec_comm_bytes(ds, nv, mode)
    elif kind == "pcg":
        res["model_comm_bytes_per_iter"] = krylov_comm_bytes(ds, 1, mode)
        # the walk's prologue: <r, z>, ||r|| and the threshold's ||b||
        res["model_comm_bytes"] = res["model_comm_bytes_per_iter"] + \
            PCG_PROLOGUE_PSUMS * 4 * (ds.p - 1)
    return res


def run_cells(cells: Sequence[str], multi_pod: bool = False,
              rows_log2: int = 19) -> List[Dict]:
    """Every cell of ``cells`` in 2D and 3D (matvec cells in every comm
    mode), as the reference's ``main`` runs them; a failed cell is
    recorded with its error."""
    layout = production_layout(multi_pod=multi_pod)
    results = []
    for dim in (2, 3):
        stats = measured_structure_stats(dim)
        for cell in cells:
            kind, nv = CELLS[cell]
            for mode in (MATVEC_MODES if kind == "matvec"
                         else ("halo-plan",)):
                try:
                    r = dry_cell(kind, dim, nv, layout, rows_log2,
                                 mode=mode, stats=stats)
                except Exception as e:        # record and go on
                    r = {"cell": f"h2-{dim}d-{cell}", "comm": mode,
                         "error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()[-1500:]}
                results.append(r)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rows-log2", type=int, default=19)
    ap.add_argument("--out", default="dryrun_h2.json")
    ap.add_argument("--cells", default="matvec1,matvec64,compress,pcg")
    args = ap.parse_args(argv)
    results = run_cells(args.cells.split(","), args.multi_pod,
                        args.rows_log2)
    for r in results:
        if "error" in r:
            print(f"FAIL {r['cell']} {r['comm']}: {r['error']}")
            continue
        coll = sum(r["collectives"].values())
        print(f"OK {r['cell']} {r['comm'] or ''}: p={r['p']} "
              f"flops/rank={r['flops']:.3e} bytes/rank={r['bytes']:.3e} "
              f"coll={coll}B resident={r['resident_bytes']}B "
              f"walk={r['walk_s']:.2f}s")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"{len(results) - n_fail} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
