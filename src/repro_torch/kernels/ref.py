"""Plain PyTorch versions of every hand-written kernel (the ``ref.py``
contract): the CPU path, the ``backend="torch"`` path, and what the kernels
are held to on the card."""
from __future__ import annotations

import torch


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bmk,bkn->bmn", a, b)


def batched_qr(a: torch.Tensor):
    """Reduced QR canonicalized to a non-negative R diagonal (the unique
    form the kernel emits, so the two agree elementwise)."""
    q, r = torch.linalg.qr(a, mode="reduced")
    d = torch.where(torch.diagonal(r, dim1=-2, dim2=-1) < 0.0, -1.0, 1.0
                    ).to(a.dtype)
    return q * d[..., None, :], r * d[..., :, None]


def batched_svd(a: torch.Tensor):
    return torch.linalg.svd(a, full_matrices=False)


def coupling_mv(s: torch.Tensor, x: torch.Tensor, blk: torch.Tensor,
                col: torch.Tensor, cnt: torch.Tensor, *, maxb: int
                ) -> torch.Tensor:
    """Plan-based block-sparse MV: take-by-plan (sentinel -> zero block) ->
    batched product -> masked sum over the slots."""
    rows = cnt.shape[0]
    nb, k1 = s.shape[0], s.shape[-2]
    idx = blk.long()
    valid = idx < nb
    sg = torch.where(valid[:, None, None], s[idx.clamp(max=max(nb - 1, 0))],
                     s.new_zeros(())) if nb else \
        s.new_zeros((idx.shape[0],) + tuple(s.shape[1:]))
    xg = x[col.long()]
    prod = torch.einsum("bij,bjv->biv", sg, xg)
    mask = torch.arange(maxb, dtype=cnt.dtype, device=cnt.device
                        )[None, :] < cnt[:, None]
    prod = prod.reshape(rows, maxb, k1, x.shape[-1]) * mask[:, :, None, None]
    return prod.sum(dim=1)


def halo_pack(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather of the planned send rows, ``y[i] = x[idx[i]]``."""
    return x.index_select(0, idx)


def halo_pack_segments(segments, srcs, dst: torch.Tensor) -> torch.Tensor:
    """Segmented pack (``halo_pack.Segment``s): for each segment one
    ``index_select`` of its source's rows into its slice of the flat
    ``dst`` (through a copy that casts where ``dst`` is bf16)."""
    for s in segments:
        cap = s.idx.shape[0]
        if cap and s.row:
            src = srcs[s.src].reshape(-1, s.row)
            out = dst[s.off:s.off + cap * s.row].view(cap, s.row)
            if out.dtype == src.dtype:
                torch.index_select(src, 0, s.idx, out=out)
            else:
                out.copy_(src.index_select(0, s.idx))
    return dst
