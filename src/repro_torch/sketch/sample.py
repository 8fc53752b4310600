"""Batched kernel-block evaluation and sketching primitives (plain PyTorch).

Every operation here is one batched computation over all the blocks of a
tree level, as in the reference, where these are XLA einsums outside any
Pallas kernel; here they are chunked kernel evaluations followed by
``torch.bmm``.

The central primitive is ``apply_kernel_blocks``: ``A_b @ B_b`` for every
block ``b = (t, s)`` of a level without forming the ``[w, w]`` kernel
blocks.  Two chunkings bound its memory:

- the source axis in chunks of ``chunk`` points, clamped to ``w`` (the
  reference pads the source axis up to ``chunk`` with zero test rows, which
  add exactly nothing: clamping gives the same sums without the padded
  work);
- the blocks, so that one ``[blocks, w, chunk]`` evaluation holds at most
  ``BLOCK_BYTES`` (a kernel makes ~20 elementwise temporaries of that
  size: a few GB in all).  Each block's sum over source chunks keeps the
  reference's chunk order.

Summing the per-block products by block row yields the randomized
block-row sketch ``Y_t = sum_{s in F(t)} A(t,s) Omega_s``.  ``kernel``
takes torch tensors (``repro_torch.core.kernels_fn``).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import torch

from repro_torch.core.structure import _take_fill

BLOCK_BYTES = 1 << 28          # one [blocks, w, chunk] evaluation


def _block_slices(nb: int, per_block: int) -> Iterator[slice]:
    """Consecutive slices of ``nb`` blocks, ``BLOCK_BYTES // per_block``
    (at least one) at a time."""
    step = max(1, BLOCK_BYTES // max(per_block, 1))
    for b0 in range(0, nb, step):
        yield slice(b0, min(b0 + step, nb))


def _apply(xt: torch.Tensor, xs: torch.Tensor, b: torch.Tensor,
           kernel: Callable, cs: int) -> torch.Tensor:
    """``kernel(xt_b, xs_b) @ b_b`` for gathered blocks, the source axis in
    chunks of ``cs``, summed in chunk order."""
    w = xs.shape[1]
    acc = None
    for c0 in range(0, w, cs):
        kblk = kernel(xt[:, :, None, :], xs[:, None, c0:c0 + cs, :])
        part = torch.bmm(kblk.to(b.dtype), b[:, c0:c0 + cs])
        acc = part if acc is None else acc + part
    return acc


def apply_kernel_blocks(xt: torch.Tensor, xs: torch.Tensor, b: torch.Tensor,
                        *, kernel: Callable, chunk: int = 256
                        ) -> torch.Tensor:
    """Per-block ``kernel(xt_b, xs_b) @ b_b`` without forming [w, w] blocks.

    xt: [nb, w, d] target points, xs: [nb, w, d] source points,
    b: [nb, w, r] per-block right-hand sides  ->  [nb, w, r].
    """
    nb, w, _ = xt.shape
    cs = min(chunk, w)
    out = b.new_empty((nb, w, b.shape[-1]))
    for sl in _block_slices(nb, w * cs * xt.element_size()):
        out[sl] = _apply(xt[sl], xs[sl], b[sl], kernel, cs)
    return out


def _apply_gathered(pts_lvl: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor, rhs: torch.Tensor, kernel: Callable,
                    chunk: int) -> Iterator[tuple]:
    """``(slice, kernel(x_row, x_col) @ rhs[col])`` per chunk of blocks,
    gathering each chunk's points and right-hand sides only when its turn
    comes (the whole level's ``rhs[cols]`` would be a GB at the leaves)."""
    nb = rows.shape[0]
    w = pts_lvl.shape[1]
    cs = min(chunk, w)
    for sl in _block_slices(nb, w * cs * pts_lvl.element_size()):
        r, c = rows[sl].long(), cols[sl].long()
        yield sl, _apply(pts_lvl[r], pts_lvl[c], rhs[c], kernel, cs)


def sample_block_rows(pts_lvl: torch.Tensor, s_rows: torch.Tensor,
                      s_cols: torch.Tensor, omega: torch.Tensor,
                      plan_blk: Optional[torch.Tensor] = None, *,
                      kernel: Callable, chunk: int = 256) -> torch.Tensor:
    """Block-row sketches of one level's admissible far field.

    pts_lvl: [nn, w, d] per-node point sets (tree order reshaped),
    s_rows/s_cols: [nb] block lists (sorted by row), omega: [nn, w, r]
    per-node Gaussian test matrices -> Y: [nn, w, r] with
    ``Y[t] = sum_{b: row(b)=t} kernel(x_t, x_{s_b}) @ omega[s_b]``.

    With the construction's marshaling plan (``plan_blk``: slot -> block,
    padding sentinel ``nb`` read as a zero block) the block-row reduction is
    a gather into the slot layout and a sum over each row's slots, the
    matvec's schedule; without it, ``index_add_`` by block row.
    """
    nn, w, _ = pts_lvl.shape
    nb = s_rows.shape[0]
    y_b = omega.new_empty((nb, w, omega.shape[-1]))
    for sl, part in _apply_gathered(pts_lvl, s_rows, s_cols, omega, kernel,
                                    chunk):
        y_b[sl] = part
    if plan_blk is None:
        return omega.new_zeros((nn, w, omega.shape[-1])).index_add_(
            0, s_rows.long(), y_b)
    maxb = plan_blk.shape[0] // nn
    return _take_fill(y_b, plan_blk).reshape(nn, maxb, w, -1).sum(dim=1)


def eval_dense_blocks(pts_leaf: torch.Tensor, d_rows: torch.Tensor,
                      d_cols: torch.Tensor, *, kernel: Callable
                      ) -> torch.Tensor:
    """All dense leaf blocks, evaluated in chunks of blocks.

    pts_leaf: [2**depth, m, d] leaf point sets -> [nbd, m, m].
    """
    m = pts_leaf.shape[1]
    out = pts_leaf.new_empty((d_rows.shape[0], m, m))
    for sl in _block_slices(d_rows.shape[0], m * m * pts_leaf.element_size()):
        xt = pts_leaf[d_rows[sl].long()]
        xs = pts_leaf[d_cols[sl].long()]
        out[sl] = kernel(xt[:, :, None, :], xs[:, None, :, :])
    return out


def project_coupling_blocks(pts_lvl: torch.Tensor, s_rows: torch.Tensor,
                            s_cols: torch.Tensor, u_exp: torch.Tensor,
                            v_exp: torch.Tensor, *, kernel: Callable,
                            chunk: int = 256) -> torch.Tensor:
    """Coupling blocks ``S_b = U_t^T A(t,s) V_s`` for one level.

    u_exp/v_exp: [nn, w, k] explicit (expanded) per-node bases.
    Computed as chunked ``A V`` followed by one batched product per chunk of
    blocks -> [nb, k, k].
    """
    nb = s_rows.shape[0]
    out = u_exp.new_empty((nb, u_exp.shape[-1], v_exp.shape[-1]))
    for sl, av in _apply_gathered(pts_lvl, s_rows, s_cols, v_exp, kernel,
                                  chunk):
        ut = u_exp[s_rows[sl].long()]
        out[sl] = torch.bmm(ut.transpose(1, 2), av)
    return out
