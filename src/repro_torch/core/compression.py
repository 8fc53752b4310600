"""Algebraic H^2 recompression (paper §5), eager PyTorch.

Three passes, all batched per level:

1. ``compression_weights`` — downsweep computing the re-weighting factors
   ``R_t`` per basis node from QR of the stacked ``[R_parent E^T; S^T ...]``
   blocks (paper Eq. 2–4).  Requires orthogonal bases.
2. Truncation upsweep of batched SVDs.  With orthonormal bases the SVD of
   the re-weighted basis ``U R^T`` reduces to the SVD of the small ``R^T`` at
   the leaves and of the stacked projected transfers at inner nodes.
   Produces the truncated basis and the old->new projections ``P = U'^T U``.
3. Coupling projection ``S' = P_row S P_col^T``.

Rank selection:

- ``target_ranks``: static ranks per level (``truncate``).
- ``tol``: a single sweep (``truncate_by_tol``).  Each upsweep SVD runs
  once; only its singular values go to the host, where the level's rank is
  picked, and the computed factors are sliced to it.  The host syncs per
  level are by design.
- ``tol`` with ``legacy_two_sweep=True``: the reference's pre-fusion
  schedule, the baseline the single sweep is held against: both trees
  orthogonalized and weighted apart (no symmetry aliasing), the ranks
  probed by one upsweep (``pick_ranks_by_tol``), then ``truncate`` runs
  every SVD again.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import phase

from .orthogonalize import orthogonalize, project_couplings
from .structure import H2Data, H2Shape, remarshal, shape_of, \
    stack_blocks_by_plan


def compression_weights(shape: H2Shape, data: H2Data, backend: str = "cuda",
                        aliased: bool = False
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Downsweep computing R_t per node for the row (U) and column (V) trees.

    ``aliased=True`` (a symmetric operator with one shared basis tree) skips
    the column sweep: ``S_ts = S_st^T`` block for block, so both sweeps
    give the same R factors.
    """
    depth = shape.depth
    ranks = shape.ranks

    def sweep(transfers, stacked_fn, maxb_tuple):
        r: List[torch.Tensor] = [None] * (depth + 1)
        r[0] = data.u_leaf.new_zeros((1, ranks[0], ranks[0]))
        for l in range(1, depth + 1):
            nn = shape.nodes(l)
            kl = ranks[l]
            # parent part: R_parent @ E_c^T -> [2**l, k_{l-1}, k_l]
            rpar = r[l - 1].repeat_interleave(2, dim=0)
            pieces = [torch.matmul(rpar, transfers[l].transpose(-1, -2))]
            if shape.coupling_counts[l] > 0 and maxb_tuple[l] > 0:
                pieces.append(stacked_fn(l))        # [nn, maxb*k_l, k_l]
            stack = torch.cat(pieces, dim=1)
            if stack.shape[1] < kl:                 # ensure R is [k_l, k_l]
                stack = torch.cat([stack, stack.new_zeros(
                    (nn, kl - stack.shape[1], kl))], dim=1)
            r[l] = kops.backend_qr_r(stack, backend)[..., :kl, :]
        return r

    # Row tree: blocks grouped by row, entries S^T (paper Eq. 4): the
    # row-marshaled buffer [nn, k, maxb*k] transposes into the stack.
    def stacked_row(l):
        return data.s_mar[l].transpose(-1, -2)

    # Column tree: blocks grouped by column, entries S (un-transposed).
    def stacked_col(l):
        return stack_blocks_by_plan(data.s[l], data.plan.cblk[l],
                                    shape.nodes(l))

    with phase("compress/weights"):
        ru = sweep(data.e, stacked_row, shape.row_maxb)
        if aliased and shape.symmetric:
            return ru, ru
        rv = sweep(data.f, stacked_col, shape.col_maxb)
        return ru, rv


# ---------------------------------------------------------------------------
# truncation upsweep steps
# ---------------------------------------------------------------------------

def truncation_leaf_factors(r_leaf: torch.Tensor, backend: str = "cuda"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leaf upsweep step: SVD of ``R^T`` (U orthonormal) -> (basis, svals)."""
    w, s, _ = kops.backend_svd(r_leaf.transpose(-1, -2), backend,
                               want_vt=False)
    return w, s


def truncation_inner_factors(p: torch.Tensor, transfer: torch.Tensor,
                             r_parent: torch.Tensor, backend: str = "cuda"
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Inner upsweep step at level ``l``: children candidate ``P_c E_c``
    stacked per parent and re-weighted by ``R_{l-1}``; one batched SVD.

    Returns (stack [nn/2, 2r_l, k_{l-1}], basis g, svals).
    """
    pe = torch.matmul(p, transfer)
    rl = pe.shape[1]
    stack = pe.reshape(pe.shape[0] // 2, 2 * rl, pe.shape[2])
    m = torch.matmul(stack, r_parent.transpose(-1, -2))
    g, s, _ = kops.backend_svd(m, backend, want_vt=False)
    return stack, g, s


def truncation_project(gk: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """Next level's projection map ``P_{l-1} = G_k^T stack``."""
    return torch.matmul(gk.transpose(-1, -2), stack)


def _pack_truncated(shape: H2Shape, data: H2Data, u_leaf, v_leaf, e_new,
                    f_new, pu, pv) -> Tuple[H2Shape, H2Data]:
    """Assemble the truncated operator + refreshed marshaled buffers."""
    with phase("compress/project-s"):
        s_new = project_couplings(shape, data, pu, pv)
    new_ranks = tuple(int(pu[l].shape[1]) for l in range(shape.depth + 1))
    with phase("compress/remarshal"):
        new_data = remarshal(H2Data(
            u_leaf=u_leaf, v_leaf=v_leaf, e=e_new, f=f_new,
            s=s_new, s_rows=list(data.s_rows), s_cols=list(data.s_cols),
            dense=data.dense, d_rows=data.d_rows, d_cols=data.d_cols,
            plan=data.plan, dense_mar=data.dense_mar), dense=False)
    return dataclasses.replace(shape, ranks=new_ranks), new_data


def _aliased(shape: H2Shape, data: H2Data) -> bool:
    return bool(shape.symmetric and data.v_leaf is data.u_leaf)


def truncate(shape: H2Shape, data: H2Data, ru: List[torch.Tensor],
             rv: List[torch.Tensor], target_ranks: Sequence[int],
             backend: str = "cuda") -> Tuple[H2Shape, H2Data]:
    """Upsweep truncation + coupling projection with static target ranks."""
    depth = shape.depth
    tr = list(target_ranks)

    def sweep(leaf, transfers, r):
        p: List[torch.Tensor] = [None] * (depth + 1)
        new_t: List[torch.Tensor] = [transfers[0]] + [None] * depth
        w, _ = truncation_leaf_factors(r[depth], backend)
        wk = w[..., :min(tr[depth], w.shape[-1])]          # [nl, k, r]
        new_leaf = torch.matmul(leaf, wk)
        p[depth] = wk.transpose(-1, -2)                     # [nl, r, k]
        for l in range(depth, 0, -1):
            nn = shape.nodes(l)
            stack, g, _ = truncation_inner_factors(p[l], transfers[l],
                                                   r[l - 1], backend)
            rl = stack.shape[1] // 2
            rp = min(tr[l - 1], g.shape[-1], 2 * rl)
            gk = g[..., :rp]
            new_t[l] = gk.reshape(nn, rl, rp)
            p[l - 1] = truncation_project(gk, stack)
        return new_leaf, new_t, p

    with phase("compress/truncate"):
        u_leaf, e_new, pu = sweep(data.u_leaf, data.e, ru)
        if _aliased(shape, data):
            v_leaf, f_new, pv = u_leaf, e_new, pu
        else:
            v_leaf, f_new, pv = sweep(data.v_leaf, data.f, rv)
    return _pack_truncated(shape, data, u_leaf, v_leaf, e_new, f_new, pu, pv)


def _host_read(value: torch.Tensor, cast):
    """``cast(value)``: one device-to-host read of the rank pick, in its
    own span ``compress/rank-pick`` (a round trip the card idles through:
    a trace puts the idle gap after the read down to this span)."""
    with phase("compress/rank-pick"):
        return cast(value)


def truncate_by_tol(shape: H2Shape, data: H2Data, ru: List[torch.Tensor],
                    rv: List[torch.Tensor], tol: float, backend: str = "cuda"
                    ) -> Tuple[H2Shape, H2Data]:
    """Single-sweep tolerance truncation.

    Each upsweep SVD runs once: its singular values go to the host to pick
    the level's rank (``max #{sigma > tol*scale}`` over both trees, at least
    1), then the computed factors are sliced to that rank.
    """
    depth = shape.depth
    sym = _aliased(shape, data)

    with phase("compress/truncate"):
        wu, su = truncation_leaf_factors(ru[depth], backend)
        wv, sv = (wu, su) if sym else truncation_leaf_factors(rv[depth],
                                                              backend)
        thresh = tol * _host_read(torch.maximum(su.max(), sv.max()), float)

        def count2(s_a, s_b) -> int:
            c = max(_host_read((s_a > thresh).sum(dim=-1).max(), int),
                    _host_read((s_b > thresh).sum(dim=-1).max(), int))
            return max(c, 1)

        rq = min(count2(su, sv), shape.ranks[depth])

        def leaf_apply(leaf, w):
            wk = w[..., :rq]
            return torch.matmul(leaf, wk), wk.transpose(-1, -2)

        u_leaf, p_u = leaf_apply(data.u_leaf, wu)
        v_leaf, p_v = (u_leaf, p_u) if sym else leaf_apply(data.v_leaf, wv)
        pu: List[torch.Tensor] = [None] * (depth + 1)
        pv: List[torch.Tensor] = [None] * (depth + 1)
        pu[depth], pv[depth] = p_u, p_v
        e_new: List[torch.Tensor] = [data.e[0]] + [None] * depth
        f_new: List[torch.Tensor] = [data.f[0]] + [None] * depth

        def inner_apply(g, stack, rp, nn):
            gk = g[..., :rp]
            return gk.reshape(nn, stack.shape[1] // 2, rp), \
                truncation_project(gk, stack)

        for l in range(depth, 0, -1):
            nn = shape.nodes(l)
            stack_u, g_u, s_u = truncation_inner_factors(
                pu[l], data.e[l], ru[l - 1], backend)
            stack_v, g_v, s_v = (stack_u, g_u, s_u) if sym else \
                truncation_inner_factors(pv[l], data.f[l], rv[l - 1],
                                         backend)
            rl = stack_u.shape[1] // 2
            rp = min(count2(s_u, s_v), shape.ranks[l - 1],
                     g_u.shape[-1], 2 * rl)
            e_new[l], pu[l - 1] = inner_apply(g_u, stack_u, rp, nn)
            if sym:
                f_new[l], pv[l - 1] = e_new[l], pu[l - 1]
            else:
                f_new[l], pv[l - 1] = inner_apply(g_v, stack_v, rp, nn)

    return _pack_truncated(shape, data, u_leaf, v_leaf, e_new, f_new, pu, pv)


def pick_ranks_by_tol(shape: H2Shape, data: H2Data, ru: List[torch.Tensor],
                      rv: List[torch.Tensor], tol: float,
                      backend: str = "cuda") -> Tuple[int, ...]:
    """Two-sweep reference: probe the truncation upsweep for ranks only.

    The baseline the fused single sweep (``truncate_by_tol``) is held
    against: it runs every upsweep SVD that ``truncate`` then repeats.  The
    scale is the largest singular value seen at the leaf level (a proxy for
    the norm of the low-rank part, making ``tol`` a relative threshold).
    """
    depth = shape.depth
    _, s_u = truncation_leaf_factors(ru[depth], backend)
    _, s_v = truncation_leaf_factors(rv[depth], backend)
    thresh = tol * float(torch.maximum(s_u.max(), s_v.max()))

    def count(s) -> int:
        return max(int((s > thresh).sum(dim=-1).max()), 1)

    rq = max(count(s_u), count(s_v))

    def sweep_probe(transfers, r) -> List[int]:
        picked = [0] * (depth + 1)
        w, _ = truncation_leaf_factors(r[depth], backend)
        p = w[..., :rq].transpose(-1, -2)
        for l in range(depth, 0, -1):
            stack, g, s = truncation_inner_factors(p, transfers[l],
                                                   r[l - 1], backend)
            picked[l - 1] = min(count(s), stack.shape[1])
            p = truncation_project(g[..., :picked[l - 1]], stack)
        return picked

    pu = sweep_probe(data.e, ru)
    pv = pu if _aliased(shape, data) else sweep_probe(data.f, rv)
    out = [max(a, b) for a, b in zip(pu, pv)]
    out[depth] = rq
    return tuple(min(o, k) for o, k in zip(out, shape.ranks))


def _unaliased(data: H2Data) -> H2Data:
    """The same operator with its V tree a distinct object (views of the U
    tree, no copy), so that every pass factors both trees."""
    return dataclasses.replace(
        data, v_leaf=data.v_leaf.view_as(data.v_leaf),
        f=[t.view_as(t) for t in data.f])


def compress(shape: H2Shape, data: H2Data, tol: Optional[float] = None,
             target_ranks: Optional[Sequence[int]] = None,
             backend: str = "cuda", assume_orthogonal: bool = False,
             legacy_two_sweep: bool = False) -> Tuple[H2Shape, H2Data]:
    """Full recompression: orthogonalize -> weights -> truncate -> project.

    ``target_ranks`` truncates to static ranks; ``tol`` runs the single-
    sweep host-in-the-loop rank pick (each SVD once).  The sweeps read the
    marshaling plan, which every constructed operator carries.
    ``legacy_two_sweep=True`` takes the retired probe-then-truncate tol
    path on the reference's pre-fusion schedule (no symmetry aliasing,
    ``pick_ranks_by_tol`` then ``truncate``): the baseline of the fused
    path.
    """
    if target_ranks is None and tol is None:
        raise ValueError("need tol or target_ranks")
    if legacy_two_sweep and target_ranks is None:
        data = _unaliased(data)
        if not assume_orthogonal:
            data = orthogonalize(shape, data, backend)
            shape = shape_of(data, shape.leaf_size, shape.symmetric)
        ru, rv = compression_weights(shape, data, backend)
        picked = pick_ranks_by_tol(shape, data, ru, rv, tol, backend)
        return truncate(shape, data, ru, rv, picked, backend)
    if not assume_orthogonal:
        data = orthogonalize(shape, data, backend)
        shape = shape_of(data, shape.leaf_size, shape.symmetric)
    ru, rv = compression_weights(shape, data, backend,
                                 aliased=_aliased(shape, data))
    if target_ranks is not None:
        return truncate(shape, data, ru, rv,
                        tuple(int(t) for t in target_ranks), backend)
    return truncate_by_tol(shape, data, ru, rv, tol, backend)
