"""Shared layer library: norms, RoPE, flash attention, decode attention,
MLP -- the port of the reference's ``models/layers.py``.

Pure functions over explicit parameter dicts of tensors.  On a device
mesh (``mesh=``, a ``parallel.sharding.ShardCtx``) each rank runs its
block of the work in the Megatron style, with the collectives placed where
the reference's sharding constraints make XLA place them: ``attention``
shards the KV heads over ``model`` (``attn_tp``) or, otherwise, runs
context parallel on the query blocks with the reference's changed
blocking; decode attends over a sequence-sharded KV cache, each rank
combining its partial softmax statistics by psums; ``mlp`` is column- then
row-parallel over the FFN hidden dim.  Without a mesh the rules only
change the flash blocking, as the reference's constraints do outside a
mesh context.  Initialisation draws from an explicit
``torch.Generator`` (the reference's ``jax.random`` keys); a test that
compares the two carries the reference's parameters across
(``models.api.params_from_numpy``).

``flash_attention`` is the reference's blocked online-softmax scan (not a
TPU kernel) in plain PyTorch: the same block rules (a sequence that the
block does not divide is one block), float32 scores, running max and
denominator, and the ``-1e30`` mask.  Its backward is the reference's
custom VJP (``_flash_bwd_scan``): a ``torch.autograd.Function`` that saves
the inputs, the output and the softmax statistics and recomputes each
score tile, so no ``[.., bq, .., bkv]`` tile outlives its KV step.
``remat`` is the reference's ``jax.checkpoint``: the families wrap each
layer (and the chunk recurrences) in it in train mode only.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.parallel import collectives as C

MASK = -1e30


def _w(mesh, p, name: str, want="stored", split=None):
    """Parameter ``name`` of ``p``: as it is without a mesh, else in the
    layout its consumer wants (``ShardCtx.take``)."""
    return p[name] if mesh is None else mesh.take(p, name, want, split)


# ---------------------------------------------------------------------------
# norms / rope / init
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [B, S, H, dh]; pos: [S] or [B, S].  Half-split rotation in
    float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = pos[..., None].float() * freqs                     # [..., S, hd/2]
    if ang.dim() == 2:                                       # [S, hd/2]
        ang = ang[None, :, None, :]
    else:                                                    # [B, S, hd/2]
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) (or ``scale``) draws from ``gen``, on ``gen``'s
    device, cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * s).to(dtype)


def _full(gen: torch.Generator, shape, value: float, dtype) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_params(cfg, gen: torch.Generator, dtype,
                     cross: bool = False) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = _full(gen, (cfg.n_heads * hd,), 0.0, dtype)
        p["bk"] = _full(gen, (cfg.n_kv_heads * hd,), 0.0, dtype)
        p["bv"] = _full(gen, (cfg.n_kv_heads * hd,), 0.0, dtype)
    if cfg.qk_norm:
        p["q_norm"] = _full(gen, (hd,), 1.0, dtype)
        p["k_norm"] = _full(gen, (hd,), 1.0, dtype)
    return p


def _qkv(cfg, p, x, x_kv=None):
    """Project to q [B,S,H,dh], k/v [B,Sk,Hkv,dh]."""
    b, s, _ = x.shape
    xk = x if x_kv is None else x_kv
    sk = xk.shape[1]
    hd = cfg.hd
    q = x @ p["wq"]
    k = xk @ p["wk"]
    v = xk @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, sk, cfg.n_kv_heads, hd)
    v = v.reshape(b, sk, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def remat(fn, on: bool):
    """``fn`` run under ``torch.utils.checkpoint`` (non-reentrant: its
    activations are recomputed in the backward) when ``on``, else ``fn``
    itself: the reference's ``jax.checkpoint(fn, nothing_saveable)``."""
    if not on:
        return fn

    def wrapped(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, **kwargs)
    return wrapped


def _q_positions(nq: int, bq: int, q_offset: int, dev) -> torch.Tensor:
    return q_offset + torch.arange(nq * bq, device=dev).reshape(nq, bq)


def _scores(qb, kc, j: int, bkv: int, q_pos, causal: bool, scale: float):
    """The float32 score tile of KV block ``j``, masked to ``-1e30``."""
    sc = torch.einsum("bqthgd,bchd->bqthgc", qb, kc) * scale
    if causal:
        k_pos = j * bkv + torch.arange(bkv, device=qb.device)
        mask = q_pos[:, :, None] >= k_pos[None, None, :]
        sc = torch.where(mask[None, :, :, None, None, :], sc, MASK)
    return sc


def _flash_fwd(qb, kb, vb, causal: bool, scale: float, q_offset: int):
    """Forward scan with online softmax.  qb: [b,nq,bq,hkv,g,hd] float32;
    kb/vb: [b,nkv,bkv,hkv,hd].  Returns (out float32, mx, den)."""
    b, nq, bq, hkv, g, hd = qb.shape
    nkv, bkv = kb.shape[1], kb.shape[2]
    dev = qb.device
    q_pos = _q_positions(nq, bq, q_offset, dev)
    acc = torch.zeros((b, nq, bq, hkv, g, hd), dtype=torch.float32,
                      device=dev)
    mx = torch.full((b, nq, bq, hkv, g), MASK, dtype=torch.float32,
                    device=dev)
    den = torch.zeros((b, nq, bq, hkv, g), dtype=torch.float32, device=dev)
    for j in range(nkv):
        kc, vc = kb[:, j].float(), vb[:, j].float()
        sc = _scores(qb, kc, j, bkv, q_pos, causal, scale)
        new_mx = torch.maximum(mx, sc.amax(dim=-1))
        corr = torch.exp(mx - new_mx)
        p_ = torch.exp(sc - new_mx[..., None])
        den = den * corr + p_.sum(dim=-1)
        pv = torch.einsum("bqthgc,bchd->bqthgd", p_, vc)
        acc = acc * corr[..., None] + pv
        mx = new_mx
    out = acc / torch.clamp(den[..., None], min=1e-30)
    return out, mx, den


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_attend`` custom VJP: the forward scan, then a
    backward that recomputes each KV block's score tile from the saved
    ``(qb, kb, vb, out, mx, den)``.  With normalised probabilities
    p = exp(sc - mx) / den:
        dv_j = p^T dout;   ds = p * (dout . v_j - sum(dout * out))
        dq  += ds k_j * scale;   dk_j = ds^T q * scale
    all in float32, returned in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, qb, kb, vb, causal, scale, q_offset):
        out, mx, den = _flash_fwd(qb, kb, vb, causal, scale, q_offset)
        ctx.save_for_backward(qb, kb, vb, out, mx, den)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        qb, kb, vb, out, mx, den = ctx.saved_tensors
        causal, scale, q_offset = ctx.args
        nq, bq = qb.shape[1], qb.shape[2]
        nkv, bkv = kb.shape[1], kb.shape[2]
        q_pos = _q_positions(nq, bq, q_offset, qb.device)
        dout = dout.float()
        dterm = (dout * out).sum(dim=-1)                 # [b,nq,bq,hkv,g]
        den = torch.clamp(den[..., None], min=1e-30)
        dq = torch.zeros_like(qb, dtype=torch.float32)
        dks, dvs = [], []
        for j in range(nkv):
            kc, vc = kb[:, j].float(), vb[:, j].float()
            sc = _scores(qb, kc, j, bkv, q_pos, causal, scale)
            p = torch.exp(sc - mx[..., None]) / den
            del sc
            dvs.append(torch.einsum("bqthgc,bqthgd->bchd", p, dout))
            dp = torch.einsum("bqthgd,bchd->bqthgc", dout, vc)
            ds = p * (dp - dterm[..., None])
            del p, dp
            dq = dq + torch.einsum("bqthgc,bchd->bqthgd", ds, kc) * scale
            dks.append(torch.einsum("bqthgc,bqthgd->bchd", ds, qb) * scale)
            del ds
        dk = torch.stack(dks, dim=1).to(kb.dtype)
        dv = torch.stack(dvs, dim=1).to(vb.dtype)
        return dq.to(qb.dtype), dk, dv, None, None, None


def flash_blocks(s: int, sk: int, block_q: int, block_kv: int,
                 cp: int = 1) -> Tuple[int, int, int, int]:
    """(nq, bq, nkv, bkv): the reference's flash blocking of an
    ``s``-query, ``sk``-key attention (a length that the block does not
    divide is one block).  ``cp`` > 1 is context parallelism over that
    many model ranks: the query blocks are re-cut so that their count
    divides over the ranks (one block when ``s`` does not divide)."""
    bq = min(block_q, s)
    bkv = min(block_kv, sk)
    nq, nkv = s // bq, sk // bkv
    if s % bq:
        nq, bq = 1, s
    if sk % bkv:
        nkv, bkv = 1, sk
    if cp > 1:
        if s % cp == 0:
            nq = cp * max(1, s // (bq * cp))
            bq = s // nq
        else:
            nq, bq = 1, s
    return nq, bq, nkv, bkv


def _flash(q, k, v, causal: bool, q_offset: int, nq: int, bq: int,
           nkv: int, bkv: int) -> torch.Tensor:
    """``_FlashAttention`` of q [B, nq*bq, H, dh] (query rows from
    ``q_offset`` on) against k/v [B, nkv*bkv, Hkv, dh]."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    qb = q.reshape(b, nq, bq, hkv, h // hkv, hd).float()
    kb = k.reshape(b, nkv, bkv, hkv, hd)
    vb = v.reshape(b, nkv, bkv, hkv, hd)
    out = _FlashAttention.apply(qb, kb, vb, causal, 1.0 / math.sqrt(hd),
                                q_offset)
    return out.reshape(b, s, h, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    block_q: int = 512, block_kv: int = 1024,
                    rules=None, model_size: int = 1) -> torch.Tensor:
    """Memory-efficient attention: online softmax over KV blocks, query
    blocks as a leading batch dimension, and a backward that recomputes
    the score tiles (``_FlashAttention``).  q: [B,S,H,dh], k/v:
    [B,Sk,Hkv,dh] (grouped-query: H a multiple of Hkv).  With ``rules``
    and ``model_size`` > 1 whose KV heads do not shard (``attn_tp`` off,
    or ``Hkv`` not divisible), the query blocks are cut for context
    parallelism, as the reference's are (``flash_blocks``)."""
    s, sk, hkv = q.shape[1], k.shape[1], k.shape[2]
    cp = model_size if (rules is not None and model_size > 1 and not (
        rules.attn_tp and hkv % model_size == 0)) else 1
    return _flash(q, k, v, causal, q_offset,
                  *flash_blocks(s, sk, block_q, block_kv, cp))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length_mask: torch.Tensor,
                     rules=None, comm=None) -> torch.Tensor:
    """One-token attention against a KV cache.  q: [B,1,H,dh]; caches:
    [B,S,Hkv,dh]; length_mask: [B, S] bool (True = valid).  With a
    ``comm`` the caches are this rank's block of a cache sequence-sharded
    over its ranks: each rank takes its slots' scores, the maximum is a
    ``pmax`` and the softmax denominator and the weighted values are
    psums (the reference's reductions over the sharded axis)."""
    b, _, h, hd = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(b, hkv, g, hd).float()
    sc = torch.einsum("bhgd,bshd->bhgs", qh, k_cache.float()) * scale
    sc = torch.where(length_mask[:, None, None, :], sc, MASK)
    if comm is None or comm.p == 1:
        p_ = torch.softmax(sc, dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd", p_, v_cache.float())
    else:
        p_ = torch.exp(sc - C.pmax(sc.amax(-1, keepdim=True), comm))
        den = C.reduce_from(p_.sum(-1, keepdim=True), comm)
        out = C.reduce_from(
            torch.einsum("bhgs,bshd->bhgd", p_, v_cache.float()), comm) / den
    return out.reshape(b, 1, h, hd).to(q.dtype)


def write_at(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim(cache, new, pos, axis=1)`` out of
    place: ``new``'s positions written from ``pos`` on (a 0-d tensor or an
    int; clamped so the slice fits, as the reference's), no host read."""
    t, s = new.shape[1], cache.shape[1]
    start = torch.as_tensor(pos, device=cache.device).reshape(()).long()
    idx = start.clamp(0, s - t) + torch.arange(t, device=cache.device)
    return cache.index_copy(1, idx, new.to(cache.dtype))


def attention(cfg, p, x, *, rules=None, model_size: int = 1,
              causal: bool = True, x_kv: Optional[torch.Tensor] = None,
              rope: bool = True,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              pos: Optional[torch.Tensor] = None,
              static_cache: bool = False, mesh=None):
    """Full attention sub-layer.  Returns (out [B,S,D], new_cache or None).

    Modes:
      - train/prefill: cache is None -> flash attention; the new k/v are
        returned as the cache.
      - decode: cache=(k,v) with static length S; ``pos`` is the scalar
        write position; returns the updated cache (new tensors).
      - decode cross-attention: ``static_cache=True`` -- attend to a fixed
        cache, nothing appended.

    On a mesh (``_attention_mesh``) ``x`` is this rank's residual stream
    and the caches are its blocks.
    """
    if mesh is not None:
        return _attention_mesh(cfg, p, x, mesh, causal=causal, x_kv=x_kv,
                               rope=rope, cache=cache, pos=pos,
                               static_cache=static_cache)
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, x_kv)
    if cache is not None and static_cache:
        kc, vc = cache
        valid = torch.ones((b, kc.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = decode_attention(q, kc, vc, valid)
        new_cache = cache
    elif cache is None:
        if rope and x_kv is None:
            pid = torch.arange(s, device=x.device) if pos is None else pos
            q = apply_rope(q, pid, cfg.rope_theta)
            k = apply_rope(k, pid, cfg.rope_theta)
        out = flash_attention(q, k, v, causal=causal and x_kv is None,
                              block_q=cfg.flash_block_q,
                              block_kv=cfg.flash_block_kv, rules=rules,
                              model_size=model_size)
        new_cache = (k, v)
    else:                      # self-attention decode: append to cache
        kc, vc = cache
        sk = kc.shape[1]
        pos = torch.as_tensor(pos, device=x.device)
        if rope:
            pp = pos.reshape(1) if pos.dim() == 0 else pos
            q = apply_rope(q, pp, cfg.rope_theta)
            k = apply_rope(k, pp, cfg.rope_theta)
        kc = write_at(kc, k, pos)
        vc = write_at(vc, v, pos)
        valid = torch.arange(sk, device=x.device)[None, :] <= pos
        out = decode_attention(q, kc, vc, valid.expand(b, sk))
        new_cache = (kc, vc)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd)
    return out @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(cfg, gen: torch.Generator, dtype) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"w1": dense_init(gen, (d, f), dtype),
                "w3": dense_init(gen, (d, f), dtype),
                "w2": dense_init(gen, (f, d), dtype)}
    return {"w1": dense_init(gen, (d, f), dtype),
            "w2": dense_init(gen, (f, d), dtype)}


def ffn_act(cfg, h, h3=None):
    """The FFN's activation of ``h = x @ w1`` (``h3 = x @ w3`` for
    swiglu)."""
    if cfg.act == "swiglu":
        return F.silu(h) * h3
    if cfg.act == "sq_relu":              # nemotron squared ReLU
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's tanh form


def mlp(cfg, p, x, rules=None, mesh=None):
    """The FFN.  On a mesh whose model axis divides the hidden width it is
    column- then row-parallel (the residual stream gathered in, the
    partial sums reduce-scattered out); otherwise each rank runs the whole
    FFN on its own rows."""
    if mesh is not None and mesh.tp_ok(cfg.d_ff):
        xf = mesh.enter(x)
        h3 = xf @ mesh.take(p, "w3", -1) if cfg.act == "swiglu" else None
        h = ffn_act(cfg, xf @ mesh.take(p, "w1", -1), h3)
        return mesh.leave(h @ mesh.take(p, "w2", 0))
    want = None if mesh is not None else "stored"
    h3 = x @ _w(mesh, p, "w3", want) if cfg.act == "swiglu" else None
    h = ffn_act(cfg, x @ _w(mesh, p, "w1", want), h3)
    return h @ _w(mesh, p, "w2", want)


def _attention_mesh(cfg, p, x, ctx, *, causal, x_kv, rope, cache, pos,
                    static_cache):
    """``attention`` on one rank of a mesh.

    Heads mode (``ctx.heads_tp``): the projections are column blocks of
    this rank's heads, the output projection a row block whose partial
    sums leave by a reduce-scatter (or a psum).  Context-parallel mode
    (the KV heads do not shard, the sequence divides): the weights are
    whole, this rank computes the queries of its block of rows (the
    reference's re-cut query blocks) against every key.  Otherwise every
    rank computes the whole attention.  Decode writes the new K/V into the
    sequence shard that owns slot ``pos`` and attends over the
    sequence-sharded cache (``decode_attention(comm=)``); the static cross
    caches keep the prefill's layout (this rank's heads, or whole)."""
    m, hd = ctx.m, cfg.hd
    tp = ctx.heads_tp(cfg)
    b, s_loc, _ = x.shape
    s = s_loc * m if ctx.sp else s_loc
    cp = not tp and m > 1 and s % m == 0
    split = tp or cp
    hq = cfg.n_heads // m if tp else cfg.n_heads
    hk = cfg.n_kv_heads // m if tp else cfg.n_kv_heads
    col = -1 if tp else None

    def project(inp, wname, bname, nh, norm):
        y = inp @ ctx.take(p, wname, col, split)
        if cfg.qkv_bias:
            y = y + ctx.take(p, bname, col, split)
        y = y.reshape(*inp.shape[:2], nh, hd)
        if cfg.qk_norm and norm:
            y = rms_norm(y, ctx.take(p, norm, None, split), cfg.norm_eps)
        return y

    q_off = 0
    if cache is not None or not split:       # decode, or all replicated
        xq = C.copy_to(x, ctx.model) if split else x
        xk = xq
    elif tp:
        xq = xk = ctx.enter(x)
    elif ctx.sp:                             # context parallel, my rows
        xq, xk, q_off = x, ctx.enter(x), ctx.t * s_loc
    else:
        xk = C.copy_to(x, ctx.model)
        xq, q_off = ctx.rows(xk), ctx.t * (s // m)
    if x_kv is not None:
        xk = C.copy_to(x_kv, ctx.model) if split else x_kv
    q = project(xq, "wq", "bq", hq, "q_norm")
    k = project(xk, "wk", "bk", hk, "k_norm")
    v = project(xk, "wv", "bv", hk, None)

    if cache is not None and static_cache:
        kc, vc = cache
        valid = torch.ones((b, kc.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = decode_attention(q, kc, vc, valid)
        new_cache = cache
    elif cache is None:
        sq, sk = q.shape[1], k.shape[1]
        if rope and x_kv is None:
            dev = x.device
            q = apply_rope(q, q_off + torch.arange(sq, device=dev),
                           cfg.rope_theta)
            k = apply_rope(k, torch.arange(sk, device=dev), cfg.rope_theta)
        nq, bq, nkv, bkv = flash_blocks(
            s, sk, cfg.flash_block_q, cfg.flash_block_kv,
            m if not tp else 1)
        out = _flash(q, k, v, causal and x_kv is None, q_off,
                     nq // m if cp else nq, bq, nkv, bkv)
        new_cache = (k, v)
    else:                      # self-attention decode: the sharded cache
        kc, vc = cache
        pos = torch.as_tensor(pos, device=x.device)
        if rope:
            pp = pos.reshape(1) if pos.dim() == 0 else pos
            q = apply_rope(q, pp, cfg.rope_theta)
            k = apply_rope(k, pp, cfg.rope_theta)
        if tp:                 # every head, for the sequence-sharded cache
            q, k, v = (C.all_gather(z, 2, ctx.model, "slice")
                       for z in (q, k, v))
        idx, n = ctx.seq_block()
        cl = kc.shape[1]
        slots = idx * cl + torch.arange(cl, device=x.device)
        hit = (slots == pos.clamp(0, cl * n - 1))[None, :, None, None]
        kc = torch.where(hit, k.to(kc.dtype), kc)
        vc = torch.where(hit, v.to(vc.dtype), vc)
        valid = (slots[None, :] <= pos).expand(b, cl)
        out = decode_attention(q, kc, vc, valid, comm=ctx.seq_comm())
        if tp:
            out = ctx.rows(out, 2)
        new_cache = (kc, vc)
    out = out.reshape(b, out.shape[1], hq * hd)
    if tp:
        y = out @ ctx.take(p, "wo", 0)
        return (ctx.leave(y) if cache is None else
                C.reduce_from(y, ctx.model)), new_cache
    y = out @ ctx.take(p, "wo", None, split)
    if cp and not ctx.sp:
        y = C.all_gather(y, 1, ctx.model, "slice")
    return y, new_cache
