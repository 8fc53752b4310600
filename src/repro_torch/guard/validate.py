"""Structural certification of H^2 operators (guard pillar 1a), port of
``repro/guard/validate.py``.

``validate_h2`` checks every invariant the matvec silently assumes, with
the reference's checks and error strings:

- shape coherence between ``H2Shape`` and the ``H2Data`` tensors;
- index bounds and row-sortedness of the block lists;
- ``CouplingPlan`` self-consistency (slots map back to blocks of their own
  row and column, every block owns one row slot and one column slot, slot
  counts match the block lists);
- marshaled-twin coherence: ``s_mar``/``dense_mar`` are derived buffers,
  re-gathered and compared bitwise.  The plain ``backend="torch"`` matvec
  reads the twins and the kernels' ``backend="cuda"`` matvec reads ``s``
  and ``dense``, so an incoherent pair makes one of the two wrong;
- symmetry aliasing and transpose-closed block patterns;
- finiteness of every value buffer;
- basis orthogonality, reported always and enforced on request.

Where the reference copies every buffer to numpy, the port keeps the value
buffers on their device: finiteness, the twin comparison and the symmetry
aliasing become device flags, read together with one host sync.  Only the
int32 index arrays come to the host, for the bounds, sort and plan checks
(the transpose closure as a sorted int64 key comparison, the reference's
pair sets in numpy form).  Orthogonality runs the Gram recurrence in
float64 on the device, ``G_parent = sum_c E_c^T G_c E_c`` from
``U_leaf^T U_leaf``, which never forms the explicit bases (O(N k^2); the
explicit bases of ``core.reconstruct.check_orthogonal`` are ~4.5 GB of
float64 per tree at N = 2^20).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.structure import H2Data, H2Shape, marshal_blocks


@dataclasses.dataclass
class ValidationReport:
    """Outcome of a structural validation pass."""
    ok: bool
    errors: List[str]
    warnings: List[str]
    orthogonality: Optional[float] = None   # worst |V^T V - I| entry

    def __bool__(self) -> bool:
        return self.ok

    def summary(self) -> str:
        if self.ok and not self.warnings:
            return "ok"
        parts = [f"{len(self.errors)} error(s)"] if self.errors else []
        parts += [f"{len(self.warnings)} warning(s)"] if self.warnings else []
        head = "; ".join(self.errors[:3] + self.warnings[:2])
        return ", ".join(parts) + (f": {head}" if head else "")


class _Errors:
    """Errors in the reference's order: host strings as they are found,
    device checks as ``(message, flag)`` pairs resolved by one host sync
    in ``resolve``.  Flags of one tensor are computed once (an aliased
    symmetric tree is checked under both names, as in the reference)."""

    def __init__(self):
        self.items: List[Union[str, tuple]] = []
        self._finite: Dict[int, torch.Tensor] = {}

    def append(self, msg: str) -> None:
        self.items.append(msg)

    def flag(self, msg: str, bad: torch.Tensor) -> None:
        self.items.append((msg, bad))

    def finite(self, name: str, t: torch.Tensor) -> None:
        if t.numel() == 0:
            return
        key = id(t)
        if key not in self._finite:
            self._finite[key] = ~torch.isfinite(t).all()
        self.flag(f"{name}: non-finite values", self._finite[key])

    def resolve(self) -> List[str]:
        flags = [it[1] for it in self.items if isinstance(it, tuple)]
        host = []
        if flags:
            dev = flags[0].device
            host = torch.stack([f.to(dev) for f in flags]).cpu().tolist()
        out, i = [], 0
        for it in self.items:
            if isinstance(it, str):
                out.append(it)
            else:
                if host[i]:
                    out.append(it[0])
                i += 1
        return out


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _bounds(name: str, arr, lo: int, hi: int, errors) -> None:
    a = _np(arr)
    if a.size and (a.min() < lo or a.max() >= hi):
        errors.append(f"{name}: index out of bounds "
                      f"[{int(a.min())},{int(a.max())}] vs [{lo},{hi})")


def _differs(a: torch.Tensor, b: torch.Tensor) -> Optional[torch.Tensor]:
    """Device flag ``not array_equal(a, b)`` (NaN differs from itself, as
    in numpy), or None when ``a is b``."""
    if a is b:
        return None
    if a.shape != b.shape:
        return torch.ones((), dtype=torch.bool, device=a.device)
    return torch.ne(a, b).any()


def _pairs_closed(rows: np.ndarray, cols: np.ndarray) -> bool:
    """``{(r, c)} == {(c, r)}`` of a block pattern, by sorted int64 keys."""
    r = rows.astype(np.int64)
    c = cols.astype(np.int64)
    return np.array_equal(np.unique((r << 32) + c), np.unique((c << 32) + r))


def _gram_deviation(leaf: torch.Tensor, transfers: List[torch.Tensor]
                    ) -> float:
    """Worst ``|B^T B - I|`` entry of the nested basis tree over every level
    of nonzero rank, by the Gram recurrence in float64 on the device."""
    depth = len(transfers) - 1
    g = leaf.double().transpose(-1, -2) @ leaf.double()
    worst = []
    for l in range(depth, -1, -1):
        if g.shape[-1]:
            eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
            worst.append((g - eye).abs().amax())
        if l == 0:
            break
        e = transfers[l].double()
        t = e.transpose(-1, -2) @ g @ e
        g = t.reshape(t.shape[0] // 2, 2, *t.shape[1:]).sum(dim=1)
    return float(torch.stack(worst).max()) if worst else 0.0


def check_orthogonal(shape: H2Shape, data: H2Data, tol: float = 1e-4) -> float:
    """Max deviation of V^T V from identity across all levels (``tol`` is
    kept for signature compatibility; the caller compares the result).
    A shared (symmetric) tree is evaluated once."""
    worst = _gram_deviation(data.u_leaf, data.e[:shape.depth + 1])
    aliased = data.v_leaf is data.u_leaf and all(
        a is b for a, b in zip(data.f, data.e))
    if not aliased:
        worst = max(worst, _gram_deviation(data.v_leaf,
                                           data.f[:shape.depth + 1]))
    return worst


def validate_h2(shape: H2Shape, data: H2Data, *,
                check_marshal: bool = True, check_orth: bool = True,
                require_orthogonal: bool = False,
                tol_orth: float = 1e-3) -> ValidationReport:
    """Full structural certification of a single-device H^2 operator."""
    errors = _Errors()
    warnings: List[str] = []
    depth, m = shape.depth, shape.leaf_size
    nl = 1 << depth

    # -- shape coherence -----------------------------------------------------
    if len(data.e) != depth + 1:
        return ValidationReport(
            ok=False, warnings=warnings,
            errors=[f"e: {len(data.e)} levels, shape.depth={depth}"])
    if tuple(data.u_leaf.shape) != (nl, m, shape.ranks[depth]):
        errors.append(f"u_leaf shape {tuple(data.u_leaf.shape)} != "
                      f"{(nl, m, shape.ranks[depth])}")
    for l in range(1, depth + 1):
        want = (1 << l, shape.ranks[l], shape.ranks[l - 1])
        if tuple(data.e[l].shape) != want:
            errors.append(f"e[{l}] shape {tuple(data.e[l].shape)} != {want}")
    for l in range(depth + 1):
        nb = shape.coupling_counts[l]
        if data.s[l].shape[0] != nb:
            errors.append(f"s[{l}]: {data.s[l].shape[0]} blocks, "
                          f"coupling_counts={nb}")
        if nb and tuple(data.s[l].shape[1:]) != (shape.ranks[l],
                                                 shape.ranks[l]):
            errors.append(f"s[{l}] block shape {tuple(data.s[l].shape[1:])}"
                          f" != {(shape.ranks[l], shape.ranks[l])}")
    if data.dense.shape[0] != shape.dense_count:
        errors.append(f"dense: {data.dense.shape[0]} blocks, "
                      f"dense_count={shape.dense_count}")

    # -- index bounds + sortedness (host copies of the int32 lists) ---------
    s_rows = [_np(r) for r in data.s_rows]
    s_cols = [_np(c) for c in data.s_cols]
    for l in range(depth + 1):
        _bounds(f"s_rows[{l}]", s_rows[l], 0, 1 << l, errors)
        _bounds(f"s_cols[{l}]", s_cols[l], 0, 1 << l, errors)
        rows = s_rows[l]
        if rows.size and np.any(np.diff(rows) < 0):
            errors.append(f"s_rows[{l}]: not row-sorted (segment_sum "
                          "indices_are_sorted would corrupt)")
    dr = _np(data.d_rows)
    dc = _np(data.d_cols)
    _bounds("d_rows", dr, 0, nl, errors)
    _bounds("d_cols", dc, 0, nl, errors)
    if dr.size and np.any(np.diff(dr) < 0):
        errors.append("d_rows: not row-sorted")

    # -- CouplingPlan self-consistency --------------------------------------
    if data.plan is None:
        warnings.append("no marshaling plan (reference matvec path)")
    else:
        plan = data.plan
        for l in range(depth + 1):
            nn = 1 << l
            nb = int(s_rows[l].shape[0])
            blk = _np(plan.sblk[l])
            col = _np(plan.scol[l])
            cnt = _np(plan.scnt[l])
            if blk.shape != col.shape or cnt.shape[0] != nn:
                errors.append(f"plan[{l}]: slot array shapes incoherent")
                continue
            maxb = blk.shape[0] // max(nn, 1)
            _bounds(f"plan.sblk[{l}]", blk, 0, nb + 1, errors)
            _bounds(f"plan.scol[{l}]", col, 0, max(nn, 1), errors)
            want_cnt = np.bincount(s_rows[l], minlength=nn).astype(
                cnt.dtype) if nb else np.zeros(nn, cnt.dtype)
            if not np.array_equal(cnt, want_cnt):
                errors.append(f"plan.scnt[{l}] != bincount(s_rows)")
            live = blk < nb
            if int(live.sum()) != nb:
                errors.append(f"plan.sblk[{l}]: {int(live.sum())} live slots"
                              f" for {nb} blocks")
            if nb and maxb:
                slots = np.nonzero(live)[0]
                srow = slots // maxb
                sr = s_rows[l][blk[slots]]
                sc = s_cols[l][blk[slots]]
                if not np.array_equal(srow, sr):
                    errors.append(f"plan.sblk[{l}]: slot row != block row")
                if not np.array_equal(col[slots], sc):
                    errors.append(f"plan.scol[{l}]: slot col != block col")
                cb = _np(plan.cblk[l])
                livec = cb[cb < nb]
                if not np.array_equal(np.sort(livec), np.arange(nb)):
                    errors.append(f"plan.cblk[{l}]: not a permutation of "
                                  "blocks")
        nbd = int(dr.shape[0])
        _bounds("plan.dblk", plan.dblk, 0, nbd + 1, errors)
        _bounds("plan.dcol", plan.dcol, 0, max(nl, 1), errors)
        dcnt = _np(plan.dcnt)
        want = np.bincount(dr, minlength=nl).astype(dcnt.dtype) if nbd \
            else np.zeros(nl, dcnt.dtype)
        if not np.array_equal(dcnt, want):
            errors.append("plan.dcnt != bincount(d_rows)")

        # -- marshaled-twin coherence (device; one temporary at a time) -----
        if check_marshal:
            if data.s_mar is None or data.dense_mar is None:
                errors.append("plan present but marshaled buffers missing")
            else:
                for l in range(depth + 1):
                    want_m = marshal_blocks(data.s[l], plan.sblk[l], 1 << l)
                    errors.flag(f"s_mar[{l}] incoherent with s (remarshal "
                                "missing or buffer corrupted)",
                                _differs(data.s_mar[l], want_m))
                    del want_m
                want_d = marshal_blocks(data.dense, plan.dblk, nl)
                errors.flag("dense_mar incoherent with dense",
                            _differs(data.dense_mar, want_d))
                del want_d

    # -- symmetry aliasing ---------------------------------------------------
    if shape.symmetric:
        bad = _differs(data.v_leaf, data.u_leaf)
        if bad is not None:
            errors.flag("symmetric shape but v_leaf != u_leaf", bad)
        for l in range(1, depth + 1):
            bad = _differs(data.f[l], data.e[l])
            if bad is not None:
                errors.flag(f"symmetric shape but f[{l}] != e[{l}]", bad)
        for l in range(depth + 1):
            if not _pairs_closed(s_rows[l], s_cols[l]):
                errors.append(f"s[{l}]: coupling pattern not "
                              "transpose-closed")
        if not _pairs_closed(dr, dc):
            errors.append("dense pattern not transpose-closed")

    # -- value finiteness ----------------------------------------------------
    errors.finite("u_leaf", data.u_leaf)
    errors.finite("v_leaf", data.v_leaf)
    for l in range(1, depth + 1):
        errors.finite(f"e[{l}]", data.e[l])
        errors.finite(f"f[{l}]", data.f[l])
    for l in range(depth + 1):
        errors.finite(f"s[{l}]", data.s[l])
        if data.s_mar is not None:
            errors.finite(f"s_mar[{l}]", data.s_mar[l])
    errors.finite("dense", data.dense)
    if data.dense_mar is not None:
        errors.finite("dense_mar", data.dense_mar)
    found = errors.resolve()

    # -- basis orthogonality -------------------------------------------------
    orth = None
    if check_orth and not found:
        orth = check_orthogonal(shape, data)
        if orth > tol_orth:
            msg = f"basis orthogonality deviation {orth:.2e} > {tol_orth:g}"
            (found if require_orthogonal else warnings).append(msg)

    return ValidationReport(ok=not found, errors=found, warnings=warnings,
                            orthogonality=orth)


def validate_dist_h2(dshape, ddata) -> ValidationReport:
    """Bounds/finiteness certification of a partitioned operator.

    Checks the per-rank marshaling plans and every ``HaloPlan``'s gather
    maps against the slab sizes they index -- the distributed matvec
    gathers through them, so an out-of-range index would read the wrong
    rows instead of failing.  Value slabs are checked finite on their
    device.
    """
    errors = _Errors()
    p, lc, depth = dshape.p, dshape.lc, dshape.depth

    def plan_check(tag: str, hp, nloc: int, nbmax: int) -> None:
        for j, snd in enumerate(hp.send):
            _bounds(f"{tag}.send[{j}]", snd, 0, max(nloc, 1), errors)
        _bounds(f"{tag}.diag_blk", hp.diag_blk, 0, nbmax + 1, errors)
        _bounds(f"{tag}.diag_col", hp.diag_col, 0, max(nloc, 1), errors)
        _bounds(f"{tag}.off_blk", hp.off_blk, 0, nbmax + 1, errors)
        _bounds(f"{tag}.bnd_rows", hp.bnd_rows, 0, max(nloc, 1), errors)
        for nm in ("comb_idx", "off_idx", "blk_idx", "rowpos"):
            a = _np(getattr(hp, nm))
            if a.size and a.min() < 0:
                errors.append(f"{tag}.{nm}: negative index")

    for i, l in enumerate(range(lc, depth + 1)):
        nloc = dshape.nodes_local(l)
        nbmax = int(ddata.s_br[i].shape[0]) // p
        _bounds(f"pb_blk[{i}]", ddata.pb_blk[i], 0, nbmax + 1, errors)
        _bounds(f"pb_col[{i}]", ddata.pb_col[i], 0, max(1 << l, 1), errors)
        plan_check(f"hp_br[{i}]", ddata.hp_br[i], nloc, nbmax)
        errors.finite(f"s_br[{i}]", ddata.s_br[i])
        errors.finite(f"s_br_mar[{i}]", ddata.s_br_mar[i])
        errors.finite(f"s_br_mar_diag[{i}]", ddata.s_br_mar_diag[i])
        errors.finite(f"s_br_mar_off[{i}]", ddata.s_br_mar_off[i])
    nbd_max = int(ddata.dense.shape[0]) // p
    plan_check("hp_dense", ddata.hp_dense, dshape.leaves_per_dev, nbd_max)
    errors.finite("u_leaf", ddata.u_leaf)
    errors.finite("dense", ddata.dense)
    errors.finite("dense_mar", ddata.dense_mar)
    for l in range(lc):
        errors.finite(f"s_top[{l}]", ddata.s_top[l])
    found = errors.resolve()
    return ValidationReport(ok=not found, errors=found, warnings=[])
