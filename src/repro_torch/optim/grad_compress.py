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

On a device mesh the reference compresses the global, already-reduced
gradient (``axis=None`` under its sharded step); the port's gradient
blocks arrive reduced over ``data`` by the backward (reduce-scatter for
FSDP leaves, psum for replicated ones), so ``compress_and_reduce(mesh=,
specs=)`` gathers each compressible leaf's gradient and error feedback,
runs the power iteration on the global matrix (the same on every rank)
and keeps this rank's blocks of the result and of the error; the Q
factors are replicated.
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
                        comm=None, mesh=None, specs=None):
    """Compress and average grads over ``comm``'s ranks (None = one
    device).  Returns (grads_hat, new_state).  On a mesh (``specs``: the
    leaves' specs) the gradients are this rank's blocks of the reduced
    global gradient."""
    if mesh is not None:
        return _compress_sharded(cfg, grads, state, mesh, specs)

    def reduce_mean(x):
        return x if comm is None else comm.psum(x) / comm.p

    def one(g, q, e):
        if q is None:
            return reduce_mean(g), None, None
        return compress_leaf(g, q, e, reduce_mean)

    outs = [one(g, q, e) for g, q, e in zip(tree_leaves(grads), state.q,
                                            state.err)]
    g_hat = tree_unflatten(grads, [o[0] for o in outs])
    return g_hat, PowerSGDState(q=[o[1] for o in outs],
                                err=[o[2] for o in outs])


def _compress_sharded(cfg, grads, state, mesh, specs):
    from repro_torch.parallel.sharding import assemble, local_block
    from .adamw import spec_leaves
    outs = []
    for g, q, e, spec in zip(tree_leaves(grads), state.q, state.err,
                             spec_leaves(specs)):
        if q is None:
            outs.append((g, None, None))
            continue
        gh, qn, en = compress_leaf(assemble(g, spec, mesh), q,
                                   assemble(e, spec, mesh))
        outs.append((local_block(gh, spec, mesh), qn,
                     local_block(en, spec, mesh)))
    g_hat = tree_unflatten(grads, [o[0] for o in outs])
    return g_hat, PowerSGDState(q=[o[1] for o in outs],
                                err=[o[2] for o in outs])


def compress_leaf(g, q, e, reduce_mean=lambda x: x):
    """One leaf's power-iteration step with error feedback: (g_hat in g's
    dtype, the new Q, the new error feedback)."""
    g32 = g.float() + e
    gm = g32.reshape(g32.shape[0], -1)
    p = reduce_mean(gm @ q)                       # [m, r]
    p, _ = torch.linalg.qr(p)
    q_new = reduce_mean(gm.T @ p)                 # [n, r]
    g_hat = (p @ q_new.T).reshape(g32.shape)
    return g_hat.to(g.dtype), q_new, g32 - g_hat


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
