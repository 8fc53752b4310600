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
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from . import moe as moe_lib
from .config import ModelConfig
from .layers import (_no_rules, attention, attention_params, dense_init,
                     mlp, mlp_params, remat, rms_norm)


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


def layer(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameters: views of the stacked blocks."""
    return tree_map(lambda a: a[i], blocks)


def unstack(blocks: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Every layer's parameters, views of the stacked blocks taken by one
    ``unbind`` per leaf (whose backward stacks the layers' gradients
    once, where ``n`` ``layer`` views would each scatter into a zero
    tensor of the whole stack)."""
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


def _ffn(cfg, bp, x, rules):
    if cfg.moe:
        return moe_lib.moe_ffn(cfg, bp["moe"], x, rules)
    return mlp(cfg, bp["mlp"], x, rules)


def _block(cfg, bp, x, *, rules=None, msize: int = 1, cache=None,
           pos=None):
    """Pre-norm transformer block.  Returns (x, new_cache)."""
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    a, new_cache = attention(cfg, bp["attn"], h, rules=rules,
                             model_size=msize, cache=cache, pos=pos)
    x = x + a
    h = rms_norm(x, bp["norm2"], cfg.norm_eps)
    x = x + _ffn(cfg, bp, h, rules)
    return x, new_cache


def _head(params) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].T


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``params["embed"]``: ``F.embedding``, whose backward sums
    a repeated token's rows in one order on the CPU and on the card (an
    indexing backward adds them atomically from CPU threads)."""
    return F.embedding(tokens.long(), params["embed"]).to(_act_dt(cfg))


def chunked_ce_loss(cfg, hidden, head_w, targets, rules=None):
    """Cross-entropy without materializing [B, S, V] logits: a loop over
    sequence chunks (peak memory = chunk x vocab)."""
    _no_rules(rules)
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


def train_loss(cfg: ModelConfig, params, tokens: torch.Tensor, rules=None,
               msize: int = 1) -> torch.Tensor:
    """Next-token CE over tokens [B, S+1] (targets = tokens shifted);
    every layer recomputed in the backward when ``cfg.remat``."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x = _embed(cfg, params, inp)

    def body(bp, h):
        return _block(cfg, bp, h, rules=rules, msize=msize)[0]

    body = remat(body, cfg.remat)
    for bp in unstack(params["blocks"], cfg.n_layers):
        x = body(bp, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return chunked_ce_loss(cfg, x, _head(params), tgt, rules)


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, rules=None,
            msize: int = 1, cache_len: Optional[int] = None):
    """Process a full prompt; returns (last-position logits [B, V] float32,
    kv caches).  The caches are ``[L, B, cache_len, Hkv, dh]`` (cache_len
    defaults to the prompt length; a larger one leaves zero rows for
    decode steps)."""
    b, s = tokens.shape
    cl = cache_len or s
    x = _embed(cfg, params, tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block(cfg, layer(params["blocks"], i), x, rules=rules,
                           msize=msize)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)
    if cl > s:
        pad = (0, 0, 0, 0, 0, cl - s)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params)).float()
    return logits, {"k": ks, "v": vs}


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                pos, rules=None, msize: int = 1):
    """One decode step.  token: [B, 1]; cache k/v: [L, B, S, Hkv, dh];
    pos: scalar (current length; a 0-d tensor is read on the device).
    Returns (logits [B, V] float32, new cache)."""
    x = _embed(cfg, params, token)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block(cfg, layer(params["blocks"], i), x, rules=rules,
                           msize=msize, cache=(cache["k"][i],
                                               cache["v"][i]), pos=pos)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params)).float()
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
