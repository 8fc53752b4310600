"""AdamW on device tensors, the port of the reference's
``repro/optim/adamw.py``: global-norm clipping, bias correction, decoupled
weight decay, float32 moments ("master" dtype) and parameters cast back to
their own dtype.

Parameter trees are nested dicts of tensors (``models.api`` trees); their
leaves are taken in the reference's ``jax.tree_util`` order (dict keys
sorted), so a state carried across from the reference lines up leaf for
leaf.  ``AdamWState.step`` is a 0-d int32 tensor on the parameters' device:
the schedule and the bias correction read no host value.

On a device mesh the moments are blocks like the parameters (the update
is elementwise), and ``global_norm(specs=, mesh=)`` is the norm of the
global gradient: each leaf's sum of squares is summed over the axes its
spec shards it on, so a replicated leaf counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, List, NamedTuple

import torch


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple in ``jax.tree_util``
    order (dict keys sorted; ``None`` is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in ``tree_leaves``
    order, by ``leaves`` (a sequence or an iterator)."""
    it: Iterator = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def tree_map(fn, *trees) -> Any:
    """``fn`` over the leaves of trees of one structure (the first's)."""
    cols = [tree_leaves(t) for t in trees]
    return tree_unflatten(trees[0], [fn(*xs) for xs in zip(*cols)])


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # master weights: keep f32 copies when params are bf16
    master_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init_state(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments in ``cfg.master_dtype`` and step 0, on the parameters'
    device."""
    dt = getattr(torch, cfg.master_dtype)
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                           device=p.device), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=tree_map(torch.clone, zeros))


def spec_leaves(specs) -> List[Any]:
    """The leaves of a spec tree (nested dicts of spec tuples) in
    ``tree_leaves`` order: each spec tuple is one leaf."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [tuple(specs)]


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves'
    sums added in tree order.  On a mesh (``specs``: the leaves' specs)
    the leaves are blocks: the sums of the leaves sharded over the same
    axes are added, summed over those axes (``Comm.psum``, the same bits
    on every rank), and the groups added in a fixed order."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    if mesh is None:
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        return torch.sqrt(total)
    from repro_torch.launch.mesh import mesh_comms
    mc = mesh_comms(mesh)
    groups = {}
    for s, spec in zip(sq, spec_leaves(specs)):
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        axes = tuple(a for a in mc.layout.axes if a in used)
        groups[axes] = groups[axes] + s if axes in groups else s
    total = None
    for axes in sorted(groups):
        comm = mc.comm(axes)
        part = groups[axes] if comm is None else comm.psum(groups[axes])
        total = part if total is None else total + part
    return torch.sqrt(total)


def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState,
                  lr_scale=1.0, specs=None, mesh=None):
    """Returns (new_params, new_state, metrics); nothing is updated in
    place.  On a mesh the trees are this rank's blocks and the clip is
    driven by the global gradient norm (``global_norm(specs=, mesh=)``)."""
    gnorm = global_norm(grads, specs, mesh)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    step = state.step + 1
    sf = step.float()
    b1c = 1.0 - torch.pow(cfg.beta1, sf)
    b2c = 1.0 - torch.pow(cfg.beta2, sf)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g32 = g.float() * clip
        m_new = cfg.beta1 * m + (1 - cfg.beta1) * g32
        v_new = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g32)
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + \
            cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = [upd(*xs) for xs in zip(tree_leaves(params), tree_leaves(grads),
                                  tree_leaves(state.m),
                                  tree_leaves(state.v))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_params, AdamWState(step, new_m, new_v), \
        {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(step: torch.Tensor, *, base_lr=1.0, warmup=100,
                    total=10000, min_frac=0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac`` of it at ``total``; ``step`` a tensor (read on
    its device)."""
    s = step.float()
    warm = s / max(warmup, 1)
    frac = (s - warmup) / max(total - warmup, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(
        math.pi * torch.clamp(frac, 0, 1)))
    return base_lr * torch.where(s < warmup, warm, cos)
