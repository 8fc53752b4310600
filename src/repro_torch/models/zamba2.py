"""Zamba2 (arXiv:2411.15242), the port of the reference's
``models/zamba2.py``: a Mamba2 backbone with one *shared* attention block.

``n_layers`` Mamba2 blocks; after every ``attn_every``-th one the single
shared transformer block (attention + MLP, one parameter set reused at
every application) is applied.  The Mamba2 blocks are stored as
superblocks, ``super`` [n_super, attn_every, ...], plus a ``tail``
[n_tail, ...] of the layers that ``attn_every`` does not divide (none when
it divides ``n_layers``).

Decode state: per-layer (ssm, conv) states and one K/V cache per
shared-block application (weights shared, caches distinct).  In training
each Mamba2 layer (and its chunk steps) and each application of the
shared block run under ``layers.remat`` when ``cfg.remat``, at the
reference's ``jax.checkpoint`` sites; the shared block's gradients from
its applications add up.

On a device mesh (``mesh=``) the residual stream is replicated over
``model``: the Mamba2 blocks are head-parallel (``mamba2.mamba_block``)
and the shared block tensor-parallel; the ssm states hold this rank's
heads and the K/V caches are sequence-sharded blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _full, _w, dense_init, remat, rms_norm
from .mamba2 import CONV_W, mamba_block, mamba_params
from .transformer import (_block as tf_block, _embed, _stack,
                          block_params as tf_block_params, layer, tree_map,
                          unstack)


def n_shared_applications(cfg) -> int:
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters from ``gen``: the Mamba2 layers in order, then the
    shared block, the embedding and the head."""
    dt = getattr(torch, cfg.param_dtype)
    per = cfg.attn_every
    n_super = cfg.n_layers // per
    n_tail = cfg.n_layers - n_super * per
    mb = [mamba_params(cfg, gen, dt) for _ in range(cfg.n_layers)]
    main = tree_map(lambda a: a.reshape(n_super, per, *a.shape[1:]),
                    _stack(mb[:n_super * per]))
    p = {"super": main,
         "shared": tf_block_params(cfg, gen),
         "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dt, scale=0.02),
         "final_norm": _full(gen, (cfg.d_model,), 1.0, dt),
         "head": dense_init(gen, (cfg.d_model, cfg.vocab), dt, scale=0.02)}
    if n_tail:
        p["tail"] = _stack(mb[n_super * per:])
    return p


def _zero_states(cfg, bsz, dtype, device):
    d_in = 2 * cfg.d_model
    nh = d_in // cfg.mamba_head_dim
    conv_ch = d_in + 2 * cfg.ssm_state
    ssm = torch.zeros((bsz, nh, cfg.mamba_head_dim, cfg.ssm_state),
                      dtype=dtype, device=device)
    conv = torch.zeros((bsz, CONV_W - 1, conv_ch), dtype=dtype,
                       device=device)
    return ssm, conv


def forward(cfg: ModelConfig, params, tokens, *, rules=None, msize=1,
            mode="train", cache=None, pos=None,
            cache_len: Optional[int] = None, mesh=None):
    """mode train/prefill/decode.  cache (decode): {ssm [L,...], conv
    [L,...], k/v [A, B, S, Hkv, dh]}.  Returns (normed hidden, cache); the
    cache is empty in train mode."""
    per = cfg.attn_every
    n_super = cfg.n_layers // per
    n_tail = cfg.n_layers - n_super * per
    bsz, t = tokens.shape
    ctx = mesh.at(t, seq=False) if mesh is not None else None
    x = _embed(cfg, params, tokens, ctx)
    decode = mode == "decode"
    train = mode == "train"
    collect_cache = mode == "prefill"
    if not decode:
        zero = _zero_states(cfg, bsz, x.dtype, x.device)
        if ctx is not None and ctx.tp_ok(zero[0].shape[1]):
            zero = (ctx.rows(zero[0], 1), zero[1])

    ssm_list, conv_list, k_list, v_list = [], [], [], []

    def mamba_train(bp, h):
        return mamba_block(cfg, bp, h, rules=rules, state=zero,
                           train=True, mesh=ctx)[0]

    def shared_train(h):
        return tf_block(cfg, params["shared"], h, rules=rules,
                        msize=msize, mesh=ctx)[0]

    mamba_train = remat(mamba_train, cfg.remat)
    shared_train = remat(shared_train, cfg.remat)

    def mamba_group(h, group_params, first, count):
        if train:
            for bp in unstack(group_params, count, mesh):
                h = mamba_train(bp, h)
            return h
        for j in range(count):
            st = ((cache["ssm"][first + j], cache["conv"][first + j])
                  if decode else zero)
            h, (ssm, conv) = mamba_block(cfg, layer(group_params, j, mesh),
                                         h, rules=rules, state=st,
                                         use_chunked=not decode, mesh=ctx)
            ssm_list.append(ssm)
            conv_list.append(conv)
        return h

    supers = (unstack(params["super"], n_super, mesh) if train else
              [layer(params["super"], g, mesh) for g in range(n_super)])
    for g in range(n_super):
        x = mamba_group(x, supers[g], g * per, per)
        if train:
            x = shared_train(x)
            continue
        kv_cache = (cache["k"][g], cache["v"][g]) if decode else None
        x, kv = tf_block(cfg, params["shared"], x, rules=rules, msize=msize,
                         cache=kv_cache, pos=pos if decode else None,
                         mesh=ctx)
        k_list.append(kv[0])
        v_list.append(kv[1])
    if n_tail:
        x = mamba_group(x, params["tail"], n_super * per, n_tail)

    x = rms_norm(x, _w(ctx, params, "final_norm", None if ctx else
                       "stored"), cfg.norm_eps)
    new_cache: Dict[str, Any] = {}
    if mode != "train":
        new_cache["ssm"] = torch.stack(ssm_list)
        new_cache["conv"] = torch.stack(conv_list)
        if k_list:
            ks, vs = torch.stack(k_list), torch.stack(v_list)
            if collect_cache and mesh is not None:
                heads = mesh.heads_tp(cfg)
                ks = mesh.decode_cache(ks, cache_len or t, heads)
                vs = mesh.decode_cache(vs, cache_len or t, heads)
            elif collect_cache and cache_len and cache_len > t:
                pad = (0, 0, 0, 0, 0, cache_len - t)
                ks, vs = F.pad(ks, pad), F.pad(vs, pad)
            new_cache["k"] = ks
            new_cache["v"] = vs
    return x, new_cache
