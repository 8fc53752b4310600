"""llama-3.2-vision style VLM backbone, the port of the reference's
``models/vision.py``: a dense decoder whose every ``cross_every``-th layer
also cross-attends to (stub) image embeddings.

The modality frontend is a stub, as the reference's: the batch holds
precomputed patch embeddings ``img_embed`` [B, n_img_tokens, d_model].
Layers are grouped into superblocks of (cross_every - 1) plain layers
(``plain`` [G, cross_every - 1, ...]) and one layer with self- and
cross-attention (``cross`` [G, ...]).  The prefill computes the cross K/V
of the image tokens once; decode attends to them as a static cache.

Caches: ``k_plain``/``v_plain`` [G, per-1, B, S, Hkv, dh] and
``k_cself``/``v_cself`` [G, B, S, Hkv, dh], padded to ``cache_len``;
``k_cross``/``v_cross`` [G, B, n_img, Hkv, dh], not padded.  In training
every plain layer and every cross layer runs under ``layers.remat`` when
``cfg.remat``, at the reference's ``jax.checkpoint`` sites.

On a device mesh (``mesh=``) the layers run as the transformer's
(sequence-parallel residual stream, tensor-parallel attention and FFN);
the self-attention caches are sequence-sharded blocks, the cross caches
keep the prefill's layout (this rank's KV heads, or whole).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _full, _w, attention, dense_init, remat, rms_norm
from .transformer import (_block as tf_block, _dt, _embed, _stack,
                          block_params, layer, tree_map, unstack)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters from ``gen``: the plain layers, the cross layers,
    the embedding and the head."""
    dt = _dt(cfg)
    per = cfg.cross_every
    n_super = cfg.n_layers // per
    plain = [block_params(cfg, gen) for _ in range(n_super * (per - 1))]
    crosses = [block_params(cfg, gen, cross=True) for _ in range(n_super)]
    return {
        "plain": tree_map(lambda a: a.reshape(n_super, per - 1,
                                              *a.shape[1:]), _stack(plain)),
        "cross": _stack(crosses),
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dt, scale=0.02),
        "final_norm": _full(gen, (cfg.d_model,), 1.0, dt),
        "head": dense_init(gen, (cfg.d_model, cfg.vocab), dt, scale=0.02),
    }


def _cross_block(cfg, bp, x, img_kv, *, rules, msize, cache, pos,
                 cross_cache=None, mesh=None):
    """Self-attn block + cross-attention to the image embeddings (or, in
    decode, to their cached K/V).  Returns (x, self_kv, cross_kv)."""
    x, self_kv = tf_block(cfg, bp, x, rules=rules, msize=msize, cache=cache,
                          pos=pos, mesh=mesh)
    h = rms_norm(x, _w(mesh, bp, "norm_x", None), cfg.norm_eps)
    if cross_cache is not None:
        a, cross_kv = attention(cfg, bp["xattn"], h, rules=rules,
                                model_size=msize, rope=False,
                                cache=cross_cache, static_cache=True,
                                mesh=mesh)
    else:
        a, cross_kv = attention(cfg, bp["xattn"], h, rules=rules,
                                model_size=msize, x_kv=img_kv, rope=False,
                                causal=False, mesh=mesh)
    return x + a, self_kv, cross_kv


def forward(cfg: ModelConfig, params, tokens, img_embed, *, rules=None,
            msize=1, mode="train", cache=None, pos=None,
            cache_len: Optional[int] = None, mesh=None):
    """img_embed: [B, n_img, D] stub patch embeddings (unused in decode,
    which reads the cross cache).  Returns (normed hidden, cache or
    None)."""
    per = cfg.cross_every
    n_super = cfg.n_layers // per
    bsz, t = tokens.shape
    ctx = mesh.at(t) if mesh is not None else None
    whole = None if mesh is not None else "stored"
    x = _embed(cfg, params, tokens, ctx)
    decode = mode == "decode"
    img = None if decode else img_embed.to(x.dtype)
    if mode == "train":
        def plain(bp, h):
            return tf_block(cfg, bp, h, rules=rules, msize=msize,
                            mesh=ctx)[0]

        def cross(bp, h):
            return _cross_block(cfg, bp, h, img, rules=rules, msize=msize,
                                cache=None, pos=None, mesh=ctx)[0]

        plain, cross = remat(plain, cfg.remat), remat(cross, cfg.remat)
        crosses = unstack(params["cross"], n_super, mesh)
        for g, gp in enumerate(unstack(params["plain"], n_super, mesh)):
            for bp in unstack(gp, per - 1, mesh):
                x = plain(bp, x)
            x = cross(crosses[g], x)
        return rms_norm(x, _w(ctx, params, "final_norm", whole),
                        cfg.norm_eps), None
    names = ("k_plain", "v_plain", "k_cself", "v_cself", "k_cross",
             "v_cross")
    out = {k: [] for k in names}
    for g in range(n_super):
        gp = layer(params["plain"], g, mesh)
        ks, vs = [], []
        for j in range(per - 1):
            c = ((cache["k_plain"][g, j], cache["v_plain"][g, j])
                 if decode else None)
            x, kv = tf_block(cfg, layer(gp, j, mesh), x, rules=rules,
                             msize=msize, cache=c,
                             pos=pos if decode else None, mesh=ctx)
            ks.append(kv[0])
            vs.append(kv[1])
        out["k_plain"].append(torch.stack(ks))
        out["v_plain"].append(torch.stack(vs))
        c = (cache["k_cself"][g], cache["v_cself"][g]) if decode else None
        cx = (cache["k_cross"][g], cache["v_cross"][g]) if decode else None
        x, self_kv, cross_kv = _cross_block(
            cfg, layer(params["cross"], g, mesh), x, img, rules=rules,
            msize=msize, cache=c, pos=pos if decode else None,
            cross_cache=cx, mesh=ctx)
        out["k_cself"].append(self_kv[0])
        out["v_cself"].append(self_kv[1])
        out["k_cross"].append(cross_kv[0])
        out["v_cross"].append(cross_kv[1])

    x = rms_norm(x, _w(ctx, params, "final_norm", whole), cfg.norm_eps)
    new_cache = {k: torch.stack(v) for k, v in out.items()}
    if mode == "prefill" and mesh is not None:
        heads = mesh.heads_tp(cfg)
        for k in ("k_plain", "v_plain", "k_cself", "v_cself"):
            new_cache[k] = mesh.decode_cache(new_cache[k], cache_len or t,
                                             heads)
    elif mode == "prefill" and cache_len and cache_len > t:
        pad6 = (0, 0, 0, 0, 0, cache_len - t)       # the S axis
        for k in ("k_plain", "v_plain", "k_cself", "v_cself"):
            new_cache[k] = F.pad(new_cache[k], pad6)
    return x, new_cache
