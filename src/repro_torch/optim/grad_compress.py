"""PowerSGD-style low-rank gradient compression with error feedback, the
port of the reference's ``repro/optim/grad_compress.py``.

Data-parallel gradient all-reduces on matrices G [m, n] are replaced by
all-reduces of rank-r factors P [m, r], Q [n, r] (one power-iteration step
per update, warm-started from the previous Q, plus error feedback so the
bias is corrected over time):

    P = G_fb Q_prev      -> mean over ranks -> orthonormalize (QR)
    Q = G_fb^T P         -> mean over ranks
    G_hat = P Q^T ;  error_fb = G_fb - G_hat

Communication drops from m*n to r*(m+n) per matrix.  Only leaves of rank
>= 2 above a size threshold are compressed; the rest are averaged exactly.
State is kept as flat lists aligned with the parameter tree's leaves
(``adamw.tree_leaves`` order, the reference's ``tree_flatten``).

The reference's ``axis=`` (a ``lax.pmean`` over a mesh axis) is ``comm=``
here: a ``core.comm.Comm`` whose ``psum`` is divided by the group size;
``comm=None`` is the reference's ``axis=None`` (one device).  The initial
Q factors come from the port's own seeded ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Union

import torch

from .adamw import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 4
    min_compress_size: int = 65536      # skip small tensors


class PowerSGDState(NamedTuple):
    q: List[Optional[torch.Tensor]]     # warm-start factors (flat, by leaf)
    err: List[Optional[torch.Tensor]]   # error feedback (flat, by leaf)


def _compressible(cfg: PowerSGDConfig, p) -> bool:
    return p.dim() >= 2 and p.numel() >= cfg.min_compress_size


def init_state(cfg: PowerSGDConfig, params,
               seed: Union[int, torch.Generator] = 0) -> PowerSGDState:
    """Gaussian Q factors [prod(shape[1:]), rank] (float32, drawn in leaf
    order from ``seed``, an int or a ``torch.Generator`` on the parameters'
    device) and zero error feedback for every compressible leaf; ``None``
    for the others."""
    leaves = tree_leaves(params)
    dev = leaves[0].device
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    qs, es = [], []
    for p in leaves:
        if _compressible(cfg, p):
            n = math.prod(p.shape[1:])
            qs.append(torch.randn((n, cfg.rank), generator=gen,
                                  dtype=torch.float32, device=dev))
            es.append(torch.zeros(p.shape, dtype=torch.float32, device=dev))
        else:
            qs.append(None)
            es.append(None)
    return PowerSGDState(q=qs, err=es)


def compress_and_reduce(cfg: PowerSGDConfig, grads, state: PowerSGDState,
                        comm=None):
    """Compress and average grads over ``comm``'s ranks (None = one
    device).  Returns (grads_hat, new_state)."""

    def reduce_mean(x):
        return x if comm is None else comm.psum(x) / comm.p

    def one(g, q, e):
        if q is None:
            return reduce_mean(g), None, None
        g32 = g.float() + e
        gm = g32.reshape(g32.shape[0], -1)
        p = reduce_mean(gm @ q)                       # [m, r]
        p, _ = torch.linalg.qr(p)
        q_new = reduce_mean(gm.T @ p)                 # [n, r]
        g_hat = (p @ q_new.T).reshape(g32.shape)
        return g_hat.to(g.dtype), q_new, g32 - g_hat

    outs = [one(g, q, e) for g, q, e in zip(tree_leaves(grads), state.q,
                                            state.err)]
    g_hat = tree_unflatten(grads, [o[0] for o in outs])
    return g_hat, PowerSGDState(q=[o[1] for o in outs],
                                err=[o[2] for o in outs])


def compression_ratio(cfg: PowerSGDConfig, params) -> float:
    """Communicated-bytes ratio (exact allreduce / compressed)."""
    full, comp = 0, 0
    for p in tree_leaves(params):
        if _compressible(cfg, p):
            m = p.shape[0]
            n = p.numel() // m
            full += p.numel()
            comp += cfg.rank * (m + n)
        else:
            full += p.numel()
            comp += p.numel()
    return full / max(comp, 1)
