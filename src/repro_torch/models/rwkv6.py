"""RWKV6 "Finch" (arXiv:2404.05892), the port of the reference's
``models/rwkv6.py``: an attention-free LM with data-dependent per-channel
decay.

Time-mix per head (head size N): with receptance r, key k, value v, decay
w_t (data-dependent, per channel) and bonus u:

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv_scan`` is the recurrence (the decode path, one token); ``wkv_chunked``
the chunk-parallel form (chunk 16; log-space cumulative decays inside a
chunk and a carried inter-chunk state), the prefill path.  As the
reference's, a length that the chunk does not divide is one chunk (its
``exp(-L)`` then grows with the length), and the carried state is returned
in the activation dtype (bfloat16 between decode steps at full width).

``rwkv_init`` and ``rwkv_backbone`` are the full model (the reference's
``_rwkv_init`` and ``_rwkv_backbone`` in ``models/api.py``): stacked
blocks, run as a Python loop over the layers.  In training
(``rwkv_backbone(train=True)``) each layer and each chunk step of the
carried state run under ``layers.remat`` when ``cfg.remat``, at the
reference's ``jax.checkpoint`` sites.

On a device mesh (``mesh=``) the residual stream is replicated over
``model`` and the time mix is head-parallel, as the reference's
constraints on r/k/v: the projections are column blocks of this rank's
heads, the carried wkv state holds its heads, ``ln_x``'s statistics over
the whole width are psums, and the output projection's partial sums are
summed over ``model``; the channel mix is column- then row-parallel over
the FFN hidden width.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as C
from .layers import _full, _w, dense_init, remat, rms_norm
from .transformer import _embed, _stack, layer, unstack

_WL_MAX = 1.2          # clamp on pre-decay so chunk-16 stays in f32 range


def rwkv_block_params(cfg, gen: torch.Generator, dtype) -> Dict[str, Any]:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    nh = d // hs
    lora = max(32, d // 64)

    def half():
        return _full(gen, (d,), 0.5, dtype)

    p = {"norm1": _full(gen, (d,), 1.0, dtype),
         "norm2": _full(gen, (d,), 1.0, dtype),
         "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
         "mu_g": half()}
    for name in ("r_proj", "k_proj", "v_proj", "g_proj", "o_proj"):
        p[name] = dense_init(gen, (d, d), dtype)
    p["w_lora_a"] = dense_init(gen, (d, lora), dtype)
    p["w_lora_b"] = dense_init(gen, (lora, d), dtype, scale=0.01)
    p["w_bias"] = _full(gen, (d,), -6.0, dtype)
    p["u_bonus"] = dense_init(gen, (nh, hs), dtype, scale=0.5)
    p["ln_x"] = _full(gen, (d,), 1.0, dtype)
    # channel mix
    p["mu_ck"] = half()
    p["cm_k"] = dense_init(gen, (d, cfg.d_ff), dtype)
    p["cm_v"] = dense_init(gen, (cfg.d_ff, d), dtype)
    p["cm_r"] = dense_init(gen, (d, d), dtype)
    return p


def _token_shift(x, mu, last: Optional[torch.Tensor] = None):
    """lerp(x_{t-1}, x_t, mu); ``last`` is the carried previous token."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = last[:, None, :]
    return prev + mu * (x - prev)


def wkv_scan(r, k, v, w, u, state0):
    """The recurrence.  r/k/v/w: [B,T,H,N]; u: [H,N]; state0: [B,H,N,N].
    Returns (out [B,T,H,N], state), both in r's dtype."""
    s = state0.float()
    u32 = u.float()
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        a = torch.einsum("bhi,bhj->bhij", kt, vt)           # k v^T
        outs.append(torch.einsum("bhi,bhij->bhj", rt,
                                 s + u32[None, :, :, None] * a))
        s = wt[..., None] * s + a
    return torch.stack(outs, dim=1).to(r.dtype), s.to(r.dtype)


def _wkv_chunk_step(s, qd, ke, vc, lt):
    """One chunk of the carried state: (the chunk's inter-chunk output,
    the next state)."""
    inter = torch.einsum("bthn,bhnm->bthm", qd, s)
    a = torch.einsum("bthn,bthm->bhnm", ke, vc)
    return inter, torch.exp(lt)[..., None] * s + a


def wkv_chunked(r, k, v, w, u, state0, chunk: int = 16,
                remat_steps: bool = False):
    """Chunk-parallel wkv (equal to ``wkv_scan`` within rounding); the
    chunk steps recomputed in the backward when ``remat_steps``.

    With within-chunk cumulative log decay L_t = sum_{s<=t} log w_s:
      intra: o_t  = sum_{s<t} (r_t e^{L_{t-1}} . k_s e^{-L_s}) v_s
                    + (r_t . u k_t) v_t
      inter: o_t += (r_t e^{L_{t-1}}) @ S_in
      state: S_out = e^{L_C} S_in + sum_s (k_s e^{L_C - L_s}) v_s^T
    """
    b, t, h, n = r.shape
    if t % chunk:
        chunk = t
    nc = t // chunk

    def resh(x):
        return x.reshape(b, nc, chunk, h, n).float()

    rc, kc, vc = resh(r), resh(k), resh(v)
    logw = torch.log(torch.clamp(resh(w), min=1e-20))
    lcum = torch.cumsum(logw, dim=2)                     # inclusive L_t
    ltot = lcum[:, :, -1]                                # [b,nc,h,n]
    lprev = lcum - logw                                  # L_{t-1}

    q_dec = rc * torch.exp(lprev)                        # r_t e^{L_{t-1}}
    k_dec = kc * torch.exp(-lcum)                        # k_s e^{-L_s}
    att = torch.einsum("bcthn,bcshn->bcths", q_dec, k_dec)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)           # strict causal
    att = torch.where(tri[None, None, :, None, :], att, 0.0)
    intra = torch.einsum("bcths,bcshn->bcthn", att, vc)
    bonus = (rc * u.float() * kc).sum(-1)[..., None] * vc

    k_end = kc * torch.exp(ltot[:, :, None] - lcum)      # e^{L_C - L_s} k_s

    step = remat(_wkv_chunk_step, remat_steps)
    s = state0.float()
    inter = []
    for c in range(nc):
        o, s = step(s, q_dec[:, c], k_end[:, c], vc[:, c], ltot[:, c])
        inter.append(o)
    out = (intra + bonus + torch.stack(inter, dim=1)).reshape(b, t, h, n)
    return out.to(r.dtype), s.to(r.dtype)


def time_mix(cfg, p, x, *, rules=None, state=None, last_tok=None,
             use_chunked=True, train: bool = False, mesh=None):
    """RWKV6 attention analogue.  x: [B,T,D].
    state: [B,H,N,N] carried wkv state; last_tok: [B,D] previous token.
    On a mesh whose model axis divides the heads, this rank's heads."""
    b, t, d = x.shape
    hs = cfg.rwkv_head_size
    nh = d // hs
    tp = mesh is not None and mesh.tp_ok(nh)
    nh = nh // mesh.m if tp else nh
    col = -1 if tp else ("stored" if mesh is None else None)
    mp = (lambda z: C.copy_to(z, mesh.model)) if tp else (lambda z: z)

    def w_(name, want=col):
        return _w(mesh, p, name, want)

    mu = "stored" if mesh is None else None
    xr = _token_shift(x, w_("mu_r", mu), last_tok)
    xk = _token_shift(x, w_("mu_k", mu), last_tok)
    xv = _token_shift(x, w_("mu_v", mu), last_tok)
    xw = _token_shift(x, w_("mu_w", mu), last_tok)
    xg = _token_shift(x, w_("mu_g", mu), last_tok)
    r = (mp(xr) @ w_("r_proj")).reshape(b, t, nh, hs)
    k = (mp(xk) @ w_("k_proj")).reshape(b, t, nh, hs)
    v = (mp(xv) @ w_("v_proj")).reshape(b, t, nh, hs)
    g = F.silu(mp(xg) @ w_("g_proj"))
    # data-dependent decay (Finch): w = exp(-exp(wl)), wl clamped
    lora_a = p["w_lora_a"] if mesh is None else \
        mesh.take(p, "w_lora_a", None, tp)
    wl = w_("w_bias") + torch.tanh(mp(xw) @ lora_a) @ w_("w_lora_b")
    wl = torch.clamp(wl.float(), -20.0, _WL_MAX)
    w = torch.exp(-torch.exp(wl)).reshape(b, t, nh, hs)
    u = w_("u_bonus", 0 if tp else col)
    if state is None:
        state = torch.zeros((b, nh, hs, hs), dtype=x.dtype, device=x.device)
    if t == 1 or not use_chunked:
        out, state = wkv_scan(r, k, v, w, u, state)
    else:
        out, state = wkv_chunked(r, k, v, w, u, state,
                                 remat_steps=train and cfg.remat)
    out = out.reshape(b, t, nh * hs)
    if tp:                 # ln_x's statistics over every rank's heads
        o32 = out.float()
        ms = C.psum((o32 * o32).sum(-1, keepdim=True), mesh.model) / d
        out = (o32 * torch.rsqrt(ms + cfg.norm_eps) *
               w_("ln_x").float()).to(out.dtype) * g
        return C.reduce_from(out @ w_("o_proj", 0), mesh.model), state
    out = rms_norm(out, w_("ln_x"), cfg.norm_eps) * g
    return out @ w_("o_proj"), state


def channel_mix(cfg, p, x, last_tok=None, mesh=None):
    """On a mesh whose model axis divides the FFN width: column- then
    row-parallel ``cm_k``/``cm_v``; the receptance ``cm_r`` whole."""
    whole = "stored" if mesh is None else None
    xk = _token_shift(x, _w(mesh, p, "mu_ck", whole), last_tok)
    rr = torch.sigmoid(x @ _w(mesh, p, "cm_r", whole))
    if mesh is not None and mesh.tp_ok(cfg.d_ff):
        h = torch.square(F.relu(C.copy_to(xk, mesh.model) @
                                mesh.take(p, "cm_k", -1)))
        return rr * C.reduce_from(h @ mesh.take(p, "cm_v", 0), mesh.model)
    h = torch.square(F.relu(xk @ _w(mesh, p, "cm_k", whole)))
    return rr * (h @ _w(mesh, p, "cm_v", whole))


def rwkv_block(cfg, p, x, *, rules=None, state=None, use_chunked=True,
               train: bool = False, mesh=None):
    """One RWKV6 block.  ``state`` is (wkv [B,H,N,N], last1 [B,D], last2
    [B,D]) for decode, or None for train/prefill.  Returns (x, new_state)."""
    wkv_s, last1, last2 = state if state is not None else (None, None, None)
    whole = "stored" if mesh is None else None
    h = rms_norm(x, _w(mesh, p, "norm1", whole), cfg.norm_eps)
    a, wkv_s = time_mix(cfg, p, h, rules=rules, state=wkv_s,
                        last_tok=last1, use_chunked=use_chunked, train=train,
                        mesh=mesh)
    new_last1 = h[:, -1]
    x = x + a
    h2 = rms_norm(x, _w(mesh, p, "norm2", whole), cfg.norm_eps)
    x = x + channel_mix(cfg, p, h2, last_tok=last2, mesh=mesh)
    new_last2 = h2[:, -1]
    return x, (wkv_s, new_last1, new_last2)


# ---------------------------------------------------------------------------
# the full model


def rwkv_init(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters from ``gen``: the stacked blocks, the embedding,
    the final norm and the (untied) head."""
    dt = getattr(torch, cfg.param_dtype)
    blocks = _stack([rwkv_block_params(cfg, gen, dt)
                     for _ in range(cfg.n_layers)])
    return {"embed": dense_init(gen, (cfg.vocab, cfg.d_model), dt,
                                scale=0.02),
            "blocks": blocks,
            "final_norm": _full(gen, (cfg.d_model,), 1.0, dt),
            "head": dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                               scale=0.02)}


def rwkv_backbone(cfg, params, tokens, rules=None, state=None,
                  train: bool = False, mesh=None):
    """The layer stack.  ``state`` (decode) is the stacked (wkv [L,B,H,N,N],
    last1 [L,B,D], last2 [L,B,D]); None for train/prefill, which start
    from zeros and take the chunked wkv.  Returns (normed hidden [B,T,D],
    new stacked state); with ``train`` the state is None and each layer
    runs under ``remat`` when ``cfg.remat``.  On a mesh the residual
    stream is replicated over ``model`` and the wkv state holds this
    rank's heads."""
    ctx = mesh.at(tokens.shape[1], seq=False) if mesh is not None else None
    whole = "stored" if mesh is None else None
    x = _embed(cfg, params, tokens, ctx)
    if train:
        def body(bp, h):
            return rwkv_block(cfg, bp, h, rules=rules, train=True,
                              mesh=ctx)[0]

        body = remat(body, cfg.remat)
        for bp in unstack(params["blocks"], cfg.n_layers, mesh):
            x = body(bp, x)
        return rms_norm(x, _w(ctx, params, "final_norm", whole),
                        cfg.norm_eps), None
    decode = state is not None
    new = ([], [], [])
    for i in range(cfg.n_layers):
        st = tuple(a[i] for a in state) if decode else None
        x, st_new = rwkv_block(cfg, layer(params["blocks"], i, mesh), x,
                               rules=rules, state=st, use_chunked=not decode,
                               mesh=ctx)
        for acc, a in zip(new, st_new):
            acc.append(a)
    new_state = tuple(torch.stack(acc) for acc in new)
    return rms_norm(x, _w(ctx, params, "final_norm", whole),
                    cfg.norm_eps), new_state
