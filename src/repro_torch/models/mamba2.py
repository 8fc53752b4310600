"""Mamba2 (SSD) block, the zamba2 backbone: the port of the reference's
``models/mamba2.py``.

State-space duality form: per head (head dim P, state N = ssm_state):
    S_t = a_t * S_{t-1} + x_t (x) B_t          (a_t scalar per head)
    y_t = S_t C_t + D_skip * x_t
with a_t = exp(-exp(A_log) * dt_t), dt = softplus(dt_raw + dt_bias) (both
in float32), and a causal depthwise conv (width 4) on the (x, B, C) stream.

``ssd_scan`` is the recurrence (the decode path); ``ssd_chunked`` the
chunk-parallel prefill path (chunk 64; as the reference's, a length that
the chunk does not divide is one chunk, whose ``[B, 1, T, T, H]`` float32
decay tensor grows with the square of the length).  In training its chunk
steps of the carried state run under ``layers.remat`` when ``cfg.remat``,
the reference's ``jax.checkpoint`` of ``chunk_step``.

On a device mesh (``mesh=``) the residual stream is replicated over
``model`` and the block is head-parallel, as the reference's constraints
on z and xc: ``in_proj``'s column blocks are gathered into the whole
projection, of which this rank keeps z, xc and dt of its heads and the
shared B and C; the carried ssm state holds its heads (the conv state is
whole); ``out_norm``'s statistics over the whole width are psums and the
output projection's partial sums are summed over ``model``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as C
from .layers import _full, _w, dense_init, remat, rms_norm

CONV_W = 4


def mamba_params(cfg, gen: torch.Generator, dtype) -> Dict[str, Any]:
    d = cfg.d_model
    d_in = 2 * d
    n = cfg.ssm_state
    hd = cfg.mamba_head_dim
    nh = d_in // hd
    conv_ch = d_in + 2 * n
    return {
        "norm": _full(gen, (d,), 1.0, dtype),
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * n + nh), dtype),
        "conv_w": dense_init(gen, (CONV_W, conv_ch), dtype, scale=0.5),
        "conv_b": _full(gen, (conv_ch,), 0.0, dtype),
        "a_log": _full(gen, (nh,), 0.0, dtype),
        "dt_bias": _full(gen, (nh,), 0.0, dtype),
        "d_skip": _full(gen, (nh,), 1.0, dtype),
        "out_norm": _full(gen, (d_in,), 1.0, dtype),
        "out_proj": dense_init(gen, (d_in, d), dtype),
    }


def _causal_conv(x, w, b, carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width CONV_W.  x: [B,T,C]; carry: [B,W-1,C]
    (previous inputs, for decode).  Returns (y, new_carry)."""
    if carry is None:
        carry = torch.zeros((x.shape[0], CONV_W - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)                    # [B, T+W-1, C]
    t = x.shape[1]
    y = sum(xp[:, i:i + t] * w[i] for i in range(CONV_W)) + b
    return F.silu(y), xp[:, -(CONV_W - 1):]


def ssd_scan(x, b_in, c_in, a, d_skip, state0):
    """x: [B,T,H,P]; b_in/c_in: [B,T,N]; a: [B,T,H]; state0: [B,H,P,N].
    Returns (y [B,T,H,P], state), both in x's dtype."""
    s = state0.float()
    ys = []
    for t in range(x.shape[1]):
        xt, bt, ct, at = (z[:, t].float() for z in (x, b_in, c_in, a))
        s = at[..., None, None] * s + torch.einsum("bhp,bn->bhpn", xt, bt)
        ys.append(torch.einsum("bhpn,bn->bhp", s, ct))
    y = torch.stack(ys, dim=1) + d_skip[None, None, :, None] * x
    return y.to(x.dtype), s.to(x.dtype)


def _ssd_chunk_step(s, qd, ke, xc, lt):
    """One chunk of the carried state: (the chunk's inter-chunk output,
    the next state)."""
    inter = torch.einsum("bthn,bhpn->bthp", qd, s)
    snew = torch.einsum("bthp,bthn->bhpn", xc, ke)
    return inter, torch.exp(lt)[..., None, None] * s + snew


def ssd_chunked(x, b_in, c_in, a, d_skip, state0, chunk: int = 64,
                remat_steps: bool = False):
    """Chunk-parallel SSD; equal to ``ssd_scan`` within rounding.  The
    chunk steps are recomputed in the backward when ``remat_steps``."""
    b, t, h, p = x.shape
    n = b_in.shape[-1]
    if t % chunk:
        chunk = t
    nc = t // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    bc = b_in.reshape(b, nc, chunk, n).float()
    cc = c_in.reshape(b, nc, chunk, n).float()
    la = torch.log(torch.clamp(a.reshape(b, nc, chunk, h), min=1e-20)).float()
    lcum = torch.cumsum(la, dim=2)                       # inclusive
    ltot = lcum[:, :, -1]                                # [b,nc,h]

    # intra: y_t = sum_{s<=t} e^{L_t - L_s} (C_t.B_s) x_s
    dec = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]   # [b,c,t,s,h]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()                # inclusive
    dec = torch.where(tri[None, None, :, :, None], dec, float("-inf"))
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
    att = torch.exp(dec) * cb[..., None]                    # [b,c,t,s,h]
    intra = torch.einsum("bctsh,bcshp->bcthp", att, xc)

    # inter-chunk carried state; C_t e^{L_t}: [b,c,t,h,n]
    q_dec = torch.exp(lcum)[..., None] * cc[:, :, :, None, :]
    k_end = torch.exp(ltot[:, :, None] - lcum)[..., None] * \
        bc[:, :, :, None, :]                                # [b,c,t,h,n]

    step = remat(_ssd_chunk_step, remat_steps)
    s = state0.float()
    inter = []
    for c in range(nc):
        o, s = step(s, q_dec[:, c], k_end[:, c], xc[:, c], ltot[:, c])
        inter.append(o)
    y = (intra + torch.stack(inter, dim=1)).reshape(b, t, h, p) + \
        d_skip[None, None, :, None] * x.float()
    return y.to(x.dtype), s.to(x.dtype)


def _in_proj_mesh(h, p, mesh):
    """``h @ in_proj`` whole on every model rank: column blocks gathered
    along the last dim (each rank keeps parts of every block, so the
    backward sums the partial gradients), or the whole weight."""
    if mesh.param_dim(p, "in_proj") == 1:
        y = C.copy_to(h, mesh.model) @ mesh.take(p, "in_proj")
        return C.all_gather(y, -1, mesh.model)
    return C.copy_to(h, mesh.model) @ mesh.take(p, "in_proj", None, True)


def mamba_block(cfg, p, x, *, rules=None, state=None, use_chunked=True,
                train: bool = False, mesh=None):
    """x: [B,T,D].  state = (ssm [B,H,P,N], conv [B,W-1,C]) or None.
    Returns (x, new_state); the ssm state in x's dtype.  On a mesh whose
    model axis divides the heads, the ssm state holds this rank's
    heads."""
    bsz, t, d = x.shape
    d_in = 2 * d
    n = cfg.ssm_state
    hd = cfg.mamba_head_dim
    nh = d_in // hd
    tp = mesh is not None and mesh.tp_ok(nh)
    whole = "stored" if mesh is None else None
    ssm_s, conv_s = state if state is not None else (None, None)

    h = rms_norm(x, _w(mesh, p, "norm", whole), cfg.norm_eps)
    zxbcdt = _in_proj_mesh(h, p, mesh) if tp else \
        h @ _w(mesh, p, "in_proj", whole)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * n, nh], dim=-1)
    xbc, conv_s = _causal_conv(xbc, _w(mesh, p, "conv_w", whole, tp or None),
                               _w(mesh, p, "conv_b", whole, tp or None),
                               conv_s)
    xc, b_in, c_in = torch.split(xbc, [d_in, n, n], dim=-1)
    heads = (lambda y: mesh.rows(y, -1)) if tp else (lambda y: y)
    z, xc, dt = heads(z), heads(xc), heads(dt)
    hcol = -1 if tp else whole
    if tp:
        nh, d_in = nh // mesh.m, d_in // mesh.m
    v = dt.float() + _w(mesh, p, "dt_bias", hcol)
    dt_ = torch.logaddexp(v, torch.zeros((), device=x.device))  # softplus
    a = torch.exp(-torch.exp(_w(mesh, p, "a_log", hcol).float()) * dt_)
    xh = (xc * dt_.repeat_interleave(hd, dim=-1)).reshape(bsz, t, nh, hd)
    if ssm_s is None:
        ssm_s = torch.zeros((bsz, nh, hd, n), dtype=x.dtype, device=x.device)
    d_skip = _w(mesh, p, "d_skip", hcol)
    if t == 1 or not use_chunked:
        y, ssm_s = ssd_scan(xh, b_in, c_in, a, d_skip, ssm_s)
    else:
        y, ssm_s = ssd_chunked(xh, b_in, c_in, a, d_skip, ssm_s,
                               remat_steps=train and cfg.remat)
    y = y.reshape(bsz, t, d_in)
    if tp:                 # out_norm's statistics over every rank's heads
        y32 = y.float()
        ms = C.psum((y32 * y32).sum(-1, keepdim=True), mesh.model) / (
            d_in * mesh.m)
        y = ((y32 * torch.rsqrt(ms + cfg.norm_eps) *
              mesh.take(p, "out_norm", -1).float()).to(y.dtype) *
             F.silu(z)).to(x.dtype)
        return x + C.reduce_from(y @ mesh.take(p, "out_proj", 0),
                                 mesh.model), (ssm_s.to(x.dtype), conv_s)
    y = (rms_norm(y, _w(mesh, p, "out_norm", whole), cfg.norm_eps) *
         F.silu(z)).to(x.dtype)
    return x + y @ _w(mesh, p, "out_proj", whole), (ssm_s.to(x.dtype),
                                                     conv_s)
