"""int8 KV-cache quantization (the decode-memory feature), the port of
the reference's ``serving/kv_quant.py``.

Per-(batch, position, head) absmax int8 quantization quarters a float32
cache (halves a bfloat16 one) with ~1e-2 relative error on attention
outputs.  Rounding is half to even, as ``jnp.round``'s.

Layout: values int8 [B, S, H, dh]; scales float16 [B, S, H, 1].
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models.layers import MASK, write_at


class QuantCache(NamedTuple):
    q: torch.Tensor          # int8 [B, S, H, dh]
    scale: torch.Tensor      # float16 [B, S, H, 1]


def quantize(x: torch.Tensor) -> QuantCache:
    """Per-(b, s, h) absmax int8."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return QuantCache(q=q, scale=scale.to(torch.float16))


def dequantize(c: QuantCache, dtype=torch.float32) -> torch.Tensor:
    return (c.q.float() * c.scale.float()).to(dtype)


def update(c: QuantCache, new_kv: torch.Tensor, pos) -> QuantCache:
    """Append one step's K or V at ``pos`` (quantized; new tensors)."""
    nq = quantize(new_kv)
    return QuantCache(q=write_at(c.q, nq.q, pos),
                      scale=write_at(c.scale, nq.scale, pos))


def decode_attention_q(q: torch.Tensor, kc: QuantCache, vc: QuantCache,
                       length_mask: torch.Tensor) -> torch.Tensor:
    """One-token attention against int8 caches, the k/v scales folded into
    the scores and the probabilities instead of dequantizing the caches.
    q: [B,1,H,dh]; caches [B,S,Hkv,dh]-shaped."""
    b, _, h, hd = q.shape
    hkv = kc.q.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(b, hkv, g, hd).float()
    k_scale = kc.scale.float()[..., 0].transpose(1, 2)      # [B, Hkv, S]
    v_scale = vc.scale.float()[..., 0].transpose(1, 2)
    sc = torch.einsum("bhgd,bshd->bhgs", qh, kc.q.float()) * scale
    sc = sc * k_scale[:, :, None, :]
    sc = torch.where(length_mask[:, None, None, :], sc, MASK)
    p = torch.softmax(sc, dim=-1)
    pv = torch.einsum("bhgs,bshd->bhgd", p * v_scale[:, :, None, :],
                      vc.q.float())
    return pv.reshape(b, 1, h, hd).to(q.dtype)


def cache_bytes(shape: Tuple[int, ...], dtype_bytes: int = 2
                ) -> Tuple[int, int]:
    """(full-precision bytes, int8 + scale bytes) of a [B,S,H,dh] cache."""
    b, s, h, dh = shape
    full = b * s * h * dh * dtype_bytes
    quant = b * s * h * dh * 1 + b * s * h * 2
    return full, quant
