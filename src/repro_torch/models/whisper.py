"""Whisper-style encoder-decoder audio backbone (whisper-tiny config), the
port of the reference's ``models/whisper.py``.

The conv frontend is a stub, as the reference's: the batch holds
precomputed frame embeddings ``frames`` [B, n_frames, d_model].  The
encoder is bidirectional self-attention; each decoder layer runs causal
self-attention, the MLP, then cross-attention to the encoder output
(rotary positions, as the reference's, instead of Whisper's learned
absolute embeddings).  The prefill caches each layer's cross K/V
(``k_cross``/``v_cross`` [L, B, n_frames, Hkv, dh]); decode takes no
frames.  In training every encoder and decoder layer runs under
``layers.remat`` when ``cfg.remat``, at the reference's
``jax.checkpoint`` sites.

On a device mesh (``mesh=``) the encoder's and the decoder's residual
streams are sequence-parallel where their lengths divide, the attention
and the FFN tensor-parallel; the encoder output is gathered once for the
cross-attention; the self-attention caches are sequence-sharded blocks,
the cross caches keep the prefill's layout (this rank's KV heads, or
whole).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from repro_torch.parallel import collectives as C
from .layers import _full, _w, attention, dense_init, mlp, remat, rms_norm
from .transformer import (_block as tf_block, _dt, _embed, _stack,
                          block_params, layer, unstack)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters from ``gen``: the encoder layers, the decoder
    layers, the embedding and the head."""
    dt = _dt(cfg)
    enc = [block_params(cfg, gen) for _ in range(cfg.enc_layers)]
    dec = [block_params(cfg, gen, cross=True) for _ in range(cfg.n_layers)]
    return {
        "enc": _stack(enc),
        "dec": _stack(dec),
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dt, scale=0.02),
        "enc_norm": _full(gen, (cfg.d_model,), 1.0, dt),
        "final_norm": _full(gen, (cfg.d_model,), 1.0, dt),
        "head": dense_init(gen, (cfg.d_model, cfg.vocab), dt, scale=0.02),
    }


def encode(cfg, params, frames, *, rules=None, msize=1,
           train: bool = False, mesh=None):
    """frames: [B, n_frames, D] stub embeddings -> encoder output; with
    ``train`` each layer runs under ``remat`` when ``cfg.remat``.  On a
    mesh the output is whole on every model rank."""
    x = frames.to(getattr(torch, cfg.act_dtype))
    ctx = mesh.at(x.shape[1]) if mesh is not None else None
    whole = None if mesh is not None else "stored"
    if ctx is not None and ctx.sp:
        x = ctx.rows(x)

    def body(bp, x):
        h = rms_norm(x, _w(ctx, bp, "norm1", whole), cfg.norm_eps)
        a, _ = attention(cfg, bp["attn"], h, rules=rules, model_size=msize,
                         causal=False, mesh=ctx)
        x = x + a
        h = rms_norm(x, _w(ctx, bp, "norm2", whole), cfg.norm_eps)
        return x + mlp(cfg, bp["mlp"], h, rules, mesh=ctx)

    body = remat(body, train and cfg.remat)
    for bp in unstack(params["enc"], cfg.enc_layers, mesh):
        x = body(bp, x)
    x = rms_norm(x, _w(ctx, params, "enc_norm", whole), cfg.norm_eps)
    if ctx is not None and ctx.sp:
        x = C.all_gather(x, 1, ctx.model, "slice")
    return x


def forward(cfg: ModelConfig, params, tokens, frames, *, rules=None,
            msize=1, mode="train", cache=None, pos=None,
            cache_len: Optional[int] = None, mesh=None):
    """Returns (normed decoder hidden, cache or None)."""
    bsz, t = tokens.shape
    decode = mode == "decode"
    enc_out = None if decode else encode(cfg, params, frames, rules=rules,
                                         msize=msize, train=mode == "train",
                                         mesh=mesh)
    ctx = mesh.at(t) if mesh is not None else None
    whole = None if mesh is not None else "stored"
    x = _embed(cfg, params, tokens, ctx)
    if mode == "train":
        def body(bp, x):
            x, _ = tf_block(cfg, bp, x, rules=rules, msize=msize, mesh=ctx)
            h = rms_norm(x, _w(ctx, bp, "norm_x", whole), cfg.norm_eps)
            a, _ = attention(cfg, bp["xattn"], h, rules=rules,
                             model_size=msize, x_kv=enc_out, rope=False,
                             causal=False, mesh=ctx)
            return x + a

        body = remat(body, cfg.remat)
        for bp in unstack(params["dec"], cfg.n_layers, mesh):
            x = body(bp, x)
        return rms_norm(x, _w(ctx, params, "final_norm", whole),
                        cfg.norm_eps), None
    ks, vs, kxs, vxs = [], [], [], []
    for i in range(cfg.n_layers):
        bp = layer(params["dec"], i, mesh)
        c = (cache["k"][i], cache["v"][i]) if decode else None
        x, kv = tf_block(cfg, bp, x, rules=rules, msize=msize, cache=c,
                         pos=pos if decode else None, mesh=ctx)
        h = rms_norm(x, _w(ctx, bp, "norm_x", whole), cfg.norm_eps)
        if decode:
            xkv = (cache["k_cross"][i], cache["v_cross"][i])
            a, _ = attention(cfg, bp["xattn"], h, rules=rules,
                             model_size=msize, rope=False, cache=xkv,
                             static_cache=True, mesh=ctx)
        else:
            a, xkv = attention(cfg, bp["xattn"], h, rules=rules,
                               model_size=msize, x_kv=enc_out, rope=False,
                               causal=False, mesh=ctx)
        x = x + a
        for acc, z in zip((ks, vs, kxs, vxs), (*kv, *xkv)):
            acc.append(z)
    x = rms_norm(x, _w(ctx, params, "final_norm", whole), cfg.norm_eps)
    ks, vs = torch.stack(ks), torch.stack(vs)
    if mode == "prefill" and mesh is not None:
        heads = mesh.heads_tp(cfg)
        ks = mesh.decode_cache(ks, cache_len or t, heads)
        vs = mesh.decode_cache(vs, cache_len or t, heads)
    elif mode == "prefill" and cache_len and cache_len > t:
        pad = (0, 0, 0, 0, 0, cache_len - t)
        ks, vs = F.pad(ks, pad), F.pad(vs, pad)
    return x, {"k": ks, "v": vs, "k_cross": torch.stack(kxs),
               "v_cross": torch.stack(vxs)}
