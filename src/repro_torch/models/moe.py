"""Mixture-of-Experts FFN (qwen3-moe, grok-1), the port of the reference's
``models/moe.py``.

Routing: softmax -> top-k -> renormalized gates, per-expert capacity
``C = ceil(T*k/E * cf)`` clamped to [1, T] with sort-based dispatch
(choices over capacity drop that expert's contribution).  Since C depends
on the token count T, a prefill (T = B*S) and a decode step (T = B) drop
different choices.

Virtual experts (``cfg.moe_virtual`` = v, grok-1): each expert's hidden
width F is stored as v slices, ``[E*v, D, F/v]``; virtual expert m is
(real expert m // v, F-slice m % v), and the scatter-add over the slices
of one real expert completes its F sum.

On a device mesh (``mesh=``) it is the reference's expert-parallel
``shard_map``: each rank routes every token of its data shard (the
router and the capacity per data shard, ``_capacity(cfg, t_loc)``),
computes its ``E*v/m`` virtual experts from ``model_rank * E*v/m`` on, and
the partial outputs are summed over ``model`` (for virtual experts the
sum also adds the F slices).  So a mesh run equals the one-device model
run separately on each data shard's rows.

Deliberate differences, both within float rounding:
  * ``jax.lax.top_k`` returns ties lowest index first; ``torch.topk``
    promises no order for ties, so the top k come from a stable
    descending sort (the same indices as the reference's).
  * The scatter ``y.at[tok].add`` is ``index_add``, whose float order of
    the sums differs.  The gathers are ``index_select``, whose backward
    (``index_add``) sums a token's several choices in one order on the
    CPU, where an indexing backward adds them atomically from threads.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init


def moe_params(cfg, gen: torch.Generator, dtype) -> Dict[str, Any]:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    v = max(getattr(cfg, "moe_virtual", 1), 1)
    ev, fw = e * v, f // v
    p = {
        "router": dense_init(gen, (d, e), dtype, scale=0.02),
        "moe_w1": dense_init(gen, (ev, d, fw), dtype),
        "moe_w2": dense_init(gen, (ev, fw, d), dtype),
    }
    if cfg.act == "swiglu":
        p["moe_w3"] = dense_init(gen, (ev, d, fw), dtype)
    return p


def _capacity(cfg, t_loc: int) -> int:
    c = int(math.ceil(t_loc * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(1, min(t_loc, c))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties lowest
    index first (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(eid_flat: torch.Tensor, k: int, n_exp: int, cap: int):
    """Sort-based capacity dispatch: eid_flat [T*k] expert per choice.
    Returns (tok [E,C], slot [E,C], valid [E,C]), int64 indices."""
    eid_flat = eid_flat.long()
    n = eid_flat.shape[0]
    dev = eid_flat.device
    sorted_e, order = torch.sort(eid_flat, stable=True)
    start = torch.searchsorted(sorted_e, torch.arange(n_exp, device=dev))
    seg_len = torch.cat([start[1:], start.new_tensor([n])]) - start
    slots = torch.arange(cap, device=dev)
    idx = start[:, None] + slots[None, :]
    valid = slots[None, :] < torch.clamp(seg_len, max=cap)[:, None]
    idx = torch.clamp(idx, 0, n - 1)
    flat = order[idx]
    return flat // k, flat % k, valid


def _moe_shard(cfg, p, x: torch.Tensor, virt_offset: int = 0
               ) -> torch.Tensor:
    """One shard's contribution. x: [T, D]; p holds the router and the
    shard's ``e_loc`` virtual experts' [e_loc, D, F/v] weights from
    ``virt_offset`` on (every one on a single device).  Returns the
    partial output [T, D] in the promoted dtype of the gated expert
    outputs (float32)."""
    t, d = x.shape
    v = max(getattr(cfg, "moe_virtual", 1), 1)
    e_loc = p["moe_w1"].shape[0]
    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eid = top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    cap = _capacity(cfg, t)
    tok, slot, valid = _dispatch_indices(eid.reshape(-1), cfg.top_k,
                                         cfg.n_experts, cap)

    real_ids = (virt_offset +
                torch.arange(e_loc, device=x.device)) // v      # [e_loc]
    tok_l, slot_l, val_l = tok[real_ids], slot[real_ids], valid[real_ids]

    xin = x.index_select(0, tok_l.reshape(-1)).reshape(e_loc, cap, d)
    xin = xin.masked_fill(~val_l[..., None], 0)
    h = torch.bmm(xin, p["moe_w1"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.bmm(xin, p["moe_w3"])
    elif cfg.act == "sq_relu":
        h = torch.square(F.relu(h))
    else:                                 # jax.nn.gelu's tanh form
        h = F.gelu(h, approximate="tanh")
    out = torch.bmm(h, p["moe_w2"])

    g = gate.reshape(-1).index_select(
        0, (tok_l * cfg.top_k + slot_l).reshape(-1)).reshape(tok_l.shape)
    g = g.masked_fill(~val_l, 0)
    out = out * g[..., None]
    y = torch.zeros((t, d), dtype=out.dtype, device=x.device)
    return y.index_add(0, tok_l.reshape(-1), out.reshape(-1, d))


def moe_ffn(cfg, p, x: torch.Tensor, rules=None, mesh=None
            ) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]; on a mesh ``x`` is this rank's residual
    stream (gathered along the sequence for the routing, the partial
    outputs reduce-scattered back)."""
    if mesh is not None:
        ev = cfg.n_experts * max(getattr(cfg, "moe_virtual", 1), 1)
        if ev % mesh.m:
            raise ValueError(f"{ev} virtual experts do not split over "
                             f"{mesh.m} model ranks")
        xf = mesh.enter(x)
        b, s, d = xf.shape
        local = {"router": mesh.take(p, "router", None, True)}
        for k in p:
            if k.startswith("moe_"):
                local[k] = mesh.take(p, k, 0)
        y = _moe_shard(cfg, local, xf.reshape(-1, d),
                       mesh.t * (ev // mesh.m))
        return mesh.leave(y.reshape(b, s, d)).to(x.dtype)
    b, s, d = x.shape
    y = _moe_shard(cfg, p, x.reshape(-1, d))
    return y.reshape(b, s, d).to(x.dtype)
