"""Dense decoder-only transformer (qwen1.5 / nemotron / codeqwen / qwen3
families), the port of the reference's ``models/transformer.py``.

Three entry points, as the reference's launch contract:
  train_loss(cfg, params, tokens)                      -> scalar loss
  prefill(cfg, params, tokens)                         -> (last_logits, cache)
  decode_step(cfg, params, token, cache, pos)          -> (logits, cache)

The layer stack is stored stacked (``params["blocks"]``: every leaf with a
leading ``L`` axis) as the reference's scan carries it, and run as a
Python loop over the layers.  ``train_loss`` is differentiable: with
``cfg.remat`` each layer runs under ``layers.remat`` (recomputed in the
backward), as the reference's ``_backbone_train``; prefill and decode
never recompute.  A config with ``moe=True`` takes the mixture-of-experts
FFN (``models/moe.py``) in place of the MLP, as the reference's ``_ffn``.

On a device mesh (``mesh=``, a ``parallel.sharding.ShardCtx``) the
parameters are this rank's blocks, ``tokens`` its data shard's rows, and
the residual stream is sequence-parallel over ``model`` (``rules.act()``)
where the length divides: gathered into the attention and the FFN,
reduce-scattered out of them.  The embedding and the head are
vocab-sharded: the embedding's partial rows are reduce-scattered, and
``chunked_ce_loss`` takes the softmax statistics of vocab-sharded logits
by psums over ``model``.  ``prefill`` returns this rank's block of the
logits (``logits_spec``) and of the decode caches, padded to
``cache_len`` and sequence-sharded (``rules.kv_cache_decode()``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as C
from . import moe as moe_lib
from .config import ModelConfig
from .layers import (_w, attention, attention_params, dense_init, mlp,
                     mlp_params, remat, rms_norm)


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _act_dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer(blocks: Dict[str, Any], i, mesh=None) -> Dict[str, Any]:
    """Layer ``i``'s parameters: views of the stacked blocks (on a mesh,
    ``ShardCtx.layer``: with their specs)."""
    if mesh is not None:
        return mesh.layer(blocks, i)
    return tree_map(lambda a: a[i], blocks)


def unstack(blocks: Dict[str, Any], n: int, mesh=None
            ) -> List[Dict[str, Any]]:
    """Every layer's parameters, views of the stacked blocks taken by one
    ``unbind`` per leaf (whose backward stacks the layers' gradients
    once, where ``n`` ``layer`` views would each scatter into a zero
    tensor of the whole stack); on a mesh, ``layer`` views."""
    if mesh is not None:
        return [mesh.layer(blocks, i) for i in range(n)]
    parts = tree_map(lambda a: a.unbind(0), blocks)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def block_params(cfg: ModelConfig, gen: torch.Generator,
                 cross: bool = False) -> Dict[str, Any]:
    dt = _dt(cfg)
    ones = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    p = {"norm1": ones, "norm2": ones.clone(),
         "attn": attention_params(cfg, gen, dt)}
    if cfg.moe:
        p["moe"] = moe_lib.moe_params(cfg, gen, dt)
    else:
        p["mlp"] = mlp_params(cfg, gen, dt)
    if cross:
        p["norm_x"] = ones.clone()
        p["xattn"] = attention_params(cfg, gen, dt)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters from ``gen`` (on ``gen``'s device): the layer
    blocks in order, then the embedding, then the separate head unless the
    embedding is tied."""
    dt = _dt(cfg)
    blocks = _stack([block_params(cfg, gen) for _ in range(cfg.n_layers)])
    p = {"embed": dense_init(gen, (cfg.vocab, cfg.d_model), dt, scale=0.02),
         "blocks": blocks,
         "final_norm": torch.ones((cfg.d_model,), dtype=dt,
                                  device=gen.device)}
    if not cfg.tie_embed:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    return p


def _ffn(cfg, bp, x, rules, mesh=None):
    if cfg.moe:
        return moe_lib.moe_ffn(cfg, bp["moe"], x, rules, mesh=mesh)
    return mlp(cfg, bp["mlp"], x, rules, mesh=mesh)


def _block(cfg, bp, x, *, rules=None, msize: int = 1, cache=None,
           pos=None, mesh=None):
    """Pre-norm transformer block.  Returns (x, new_cache)."""
    h = rms_norm(x, _w(mesh, bp, "norm1", None), cfg.norm_eps)
    a, new_cache = attention(cfg, bp["attn"], h, rules=rules,
                             model_size=msize, cache=cache, pos=pos,
                             mesh=mesh)
    x = x + a
    h = rms_norm(x, _w(mesh, bp, "norm2", None), cfg.norm_eps)
    x = x + _ffn(cfg, bp, h, rules, mesh)
    return x, new_cache


def _head(params, mesh=None, cfg=None) -> torch.Tensor:
    """The output head [D, V] (the embedding's transpose when tied); on a
    mesh, this rank's block (vocab-sharded over ``model`` where
    ``vocab_sharded``) gathered over ``data``."""
    if mesh is None:
        return params["head"] if "head" in params else params["embed"].T
    vs = vocab_sharded(cfg, mesh)
    if "head" in params:
        return mesh.take(params, "head", 1 if vs else None)
    return mesh.take(params, "embed", 0 if vs else None).T


def vocab_sharded(cfg, mesh) -> bool:
    """Whether the embedding and head shard the vocab over ``model`` (the
    embedding's spec shards its larger dim)."""
    return mesh is not None and mesh.tp_ok(cfg.vocab) and \
        cfg.vocab > cfg.d_model


def logits_spec(cfg, rules, mesh) -> tuple:
    """The layout of the logits a prefill or decode step returns on a
    mesh: the reference's ``rules.logits()`` (vocab over ``model``), the
    vocab whole where it does not shard."""
    return (rules.dp, rules.tp if vocab_sharded(cfg, mesh) else None)


def _embed(cfg, params, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """The rows of ``params["embed"]``: ``F.embedding``, whose backward sums
    a repeated token's rows in one order on the CPU and on the card (an
    indexing backward adds them atomically from CPU threads).  On a mesh
    with the vocab sharded each rank looks up the tokens of its vocab
    block (zero rows for the others) and the partial rows leave like a
    row-parallel product (``ShardCtx.leave``); else each rank looks up
    its own rows."""
    if mesh is None:
        return F.embedding(tokens.long(), params["embed"]).to(_act_dt(cfg))
    vs = vocab_sharded(cfg, mesh)
    w = mesh.take(params, "embed", 0 if vs else None)
    if vs:
        nv = w.shape[0]
        idx = tokens.long() - mesh.t * nv
        own = (idx >= 0) & (idx < nv)
        e = F.embedding(idx.clamp(0, nv - 1), w) * own[..., None].to(w.dtype)
        return mesh.leave(e).to(_act_dt(cfg))
    if mesh.sp:
        tokens = mesh.rows(tokens)
    return F.embedding(tokens.long(), w).to(_act_dt(cfg))


def _ce_sharded(cfg, hidden, head_w, targets, mesh):
    """``chunked_ce_loss`` on a mesh: ``hidden`` is this rank's residual
    stream, ``head_w`` its head block, ``targets`` its data shard's rows.
    With the vocab sharded the hidden rows are gathered and each chunk's
    log-sum-exp and gold logit are psums over ``model`` of the rank's
    vocab block (the maximum a ``pmax``); else each rank scores its own
    rows with the whole head.  The per-row sums are summed over the data
    axis (``ShardCtx.data_sum``)."""
    vs = vocab_sharded(cfg, mesh)
    if vs:
        hidden = mesh.enter(hidden)
    elif mesh.sp:
        targets = mesh.rows(targets)
    b, s, _ = hidden.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        c = s
    nv = head_w.shape[1]
    lo = mesh.t * nv
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for a in range(0, s, c):
        logits = (hidden[:, a:a + c] @ head_w).float()
        tc = targets[:, a:a + c, None].long()
        if vs:
            mx = C.pmax(logits.amax(-1), mesh.model)
            se = torch.exp(logits - mx[..., None]).sum(-1)
            lse = torch.log(C.reduce_from(se, mesh.model)) + mx
            own = (tc >= lo) & (tc < lo + nv)
            gold = torch.gather(logits, -1, (tc - lo).clamp(0, nv - 1))
            gold = C.reduce_from((gold * own)[..., 0], mesh.model)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, tc)[..., 0]
        total = total + (lse - gold).sum()
    rows = b * (s * mesh.m if mesh.sp and not vs else s)
    if mesh.sp and not vs:
        total = C.reduce_from(total, mesh.model)
    total, n = mesh.data_sum(total, rows)
    return total / n


def chunked_ce_loss(cfg, hidden, head_w, targets, rules=None, mesh=None):
    """Cross-entropy without materializing [B, S, V] logits: a loop over
    sequence chunks (peak memory = chunk x vocab)."""
    if mesh is not None:
        return _ce_sharded(cfg, hidden, head_w, targets, mesh)
    b, s, d = hidden.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        c = s
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, c):
        logits = (hidden[:, lo:lo + c] @ head_w).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets[:, lo:lo + c, None].long())[..., 0]
        total = total + (lse - gold).sum()
    return total / (b * s)


def last_logits(cfg, params, hidden, mesh=None) -> torch.Tensor:
    """The last position's logits [B, V] float32 of the normed ``hidden``
    (on a sequence-sharded mesh the last row is on the last model rank,
    whose row the others receive by a psum; the result is this rank's
    block of ``logits_spec``)."""
    x = hidden[:, -1]
    if mesh is not None and mesh.sp:
        x = C.reduce_from(x * float(mesh.t == mesh.m - 1), mesh.model)
    return (x @ _head(params, mesh, cfg)).float()


def train_loss(cfg: ModelConfig, params, tokens: torch.Tensor, rules=None,
               msize: int = 1, mesh=None) -> torch.Tensor:
    """Next-token CE over tokens [B, S+1] (targets = tokens shifted);
    every layer recomputed in the backward when ``cfg.remat``."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    if mesh is not None:
        mesh = mesh.at(inp.shape[1])
    x = _embed(cfg, params, inp, mesh)

    def body(bp, h):
        return _block(cfg, bp, h, rules=rules, msize=msize, mesh=mesh)[0]

    body = remat(body, cfg.remat)
    for bp in unstack(params["blocks"], cfg.n_layers, mesh):
        x = body(bp, x)
    x = rms_norm(x, _w(mesh, params, "final_norm", None), cfg.norm_eps)
    return chunked_ce_loss(cfg, x, _head(params, mesh, cfg), tgt, rules,
                           mesh)


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, rules=None,
            msize: int = 1, cache_len: Optional[int] = None, mesh=None):
    """Process a full prompt; returns (last-position logits [B, V] float32,
    kv caches).  The caches are ``[L, B, cache_len, Hkv, dh]`` (cache_len
    defaults to the prompt length; a larger one leaves zero rows for
    decode steps); on a mesh, this rank's blocks."""
    b, s = tokens.shape
    cl = cache_len or s
    ctx = mesh.at(s) if mesh is not None else None
    x = _embed(cfg, params, tokens, ctx)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block(cfg, layer(params["blocks"], i, mesh), x,
                           rules=rules, msize=msize, mesh=ctx)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)
    if mesh is not None:
        heads = mesh.heads_tp(cfg)
        x = rms_norm(x, _w(ctx, params, "final_norm", None), cfg.norm_eps)
        return last_logits(cfg, params, x, ctx), {
            "k": mesh.decode_cache(ks, cl, heads),
            "v": mesh.decode_cache(vs, cl, heads)}
    if cl > s:
        pad = (0, 0, 0, 0, 0, cl - s)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params)).float()
    return logits, {"k": ks, "v": vs}


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                pos, rules=None, msize: int = 1, mesh=None):
    """One decode step.  token: [B, 1]; cache k/v: [L, B, S, Hkv, dh];
    pos: scalar (current length; a 0-d tensor is read on the device).
    Returns (logits [B, V] float32, new cache)."""
    ctx = mesh.at(1) if mesh is not None else None
    x = _embed(cfg, params, token, ctx)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block(cfg, layer(params["blocks"], i, mesh), x,
                           rules=rules, msize=msize, cache=(cache["k"][i],
                                                            cache["v"][i]),
                           pos=pos, mesh=ctx)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, _w(ctx, params, "final_norm", None), cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, ctx, cfg)).float()
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
