"""Counter-based Gaussian test matrices for the sketch constructor.

Every Gaussian block is a pure function of integer counters, never of a
carried generator state: entry ``j`` of node ``i``'s ``[rows, cols]`` block
on stream ``stream`` (one stream per tree level) is read from the Philox
4x32-10 block cipher keyed by the seed, at the counter
``(j // 4, i, stream, cols)``.  So, as in the reference:

- a node's test matrix is the same however the nodes are batched, chunked
  or ordered, and every coupling block of a block row sees the same
  ``Omega_s``;
- the same seed gives the same bits, and a larger budget (``cols``) is a
  fresh draw, not a superset of a smaller one.

The reference keys ``jax.random`` threefry by
``fold_in(fold_in(PRNGKey(seed), level), node)``; torch cannot give those
bits, so the draws differ from the reference's while keeping its
counter-based property.

The CPU and the card draw the same bits: Philox runs on int64 tensors with
32-bit words (products split into 16-bit limbs, so nothing overflows), and
Box-Muller evaluates its logarithm, sine and cosine as float64 polynomials
built from ``+ - * /`` and ``sqrt`` alone -- operations IEEE rounds
correctly on both -- before one rounding to ``dtype``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)          # Philox 4x32 multipliers
_WEYL = (0x9E3779B9, 0xBB67AE85)         # Philox 4x32 key increments
_ROUNDS = 10
_LN2 = math.log(2.0)
_SQRT_HALF = math.sqrt(0.5)
# ln m = 2 atanh(s) = 2 s sum_k s^(2k) / (2k+1), |s| <= 0.1716
_LOG_COEF = [1.0 / (2 * k + 1) for k in range(11)]
# Taylor coefficients on [0, pi/2): cos in x^2 and sin / x in x^2
_COS_COEF = [(-1.0) ** k / math.factorial(2 * k) for k in range(12)]
_SIN_COEF = [(-1.0) ** k / math.factorial(2 * k + 1) for k in range(12)]

Key = Tuple[int, int, int]


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * m`` for int64 words ``a < 2^32``."""
    a1, a0 = a >> 16, a & 0xFFFF
    m1, m0 = m >> 16, m & 0xFFFF
    mid = a1 * m0 + a0 * m1
    t = a0 * m0 + ((mid & 0xFFFF) << 16)
    return a1 * m1 + (mid >> 16) + (t >> 32), t & M32


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
               c3: torch.Tensor, k0: int, k1: int
               ) -> Tuple[torch.Tensor, ...]:
    """Philox 4x32-10 of the counter words ``c0..c3`` (int64 tensors of
    32-bit values, broadcastable) under the key ``(k0, k1)``."""
    for _ in range(_ROUNDS):
        hi0, lo0 = _mulhilo(c0, _MUL[0])
        hi1, lo1 = _mulhilo(c2, _MUL[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _WEYL[0]) & M32, (k1 + _WEYL[1]) & M32
    return c0, c1, c2, c3


def _poly(x: torch.Tensor, coef) -> torch.Tensor:
    """Horner on ``coef`` (lowest order first), one rounding per step."""
    p = torch.full_like(x, coef[-1])
    for c in reversed(coef[:-1]):
        p = p * x
        p = p + c
    return p


def _log_unit(u: torch.Tensor) -> torch.Tensor:
    """ln u for float64 ``u`` in (0, 1]."""
    m, e = torch.frexp(u)                    # u = m 2^e, m in [0.5, 1)
    low = m < _SQRT_HALF
    m = torch.where(low, m * 2.0, m)
    e = (e - low.to(e.dtype)).to(torch.float64)
    s = (m - 1.0) / (m + 1.0)
    return e * _LN2 + (s * 2.0) * _poly(s * s, _LOG_COEF)


def _cos_sin_turn(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of ``2 pi v`` for float64 ``v`` in [0, 1)."""
    t = v * 4.0
    q = torch.floor(t)
    phi = (t - q) * (math.pi / 2.0)          # in [0, pi/2)
    x2 = phi * phi
    c = _poly(x2, _COS_COEF)
    s = phi * _poly(x2, _SIN_COEF)
    # rotate by the quadrant q * pi/2
    cos = torch.where(q == 0, c, torch.where(q == 1, -s,
                                             torch.where(q == 2, -c, s)))
    sin = torch.where(q == 0, s, torch.where(q == 1, c,
                                             torch.where(q == 2, -s, -c)))
    return cos, sin


def _box_muller(x: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two N(0, 1) float64 samples from two 32-bit words."""
    u = (x.to(torch.float64) + 0.5) * 2.0 ** -32     # (0, 1)
    v = y.to(torch.float64) * 2.0 ** -32             # [0, 1)
    r = torch.sqrt(_log_unit(u) * -2.0)
    cos, sin = _cos_sin_turn(v)
    return r * cos, r * sin


def stream_key(seed: int, stream: int) -> Key:
    """Base of a named sampling stream (one per tree level): the Philox key
    words of ``seed`` and the stream number."""
    seed &= (1 << 64) - 1
    if not 0 <= stream <= M32:
        raise ValueError(f"stream {stream} is not a 32-bit counter")
    return seed & M32, seed >> 32, stream


def node_gaussians(base: Key, node_ids: torch.Tensor, *, rows: int,
                   cols: int, dtype=torch.float32) -> torch.Tensor:
    """Per-node Gaussian test matrices ``[len(node_ids), rows, cols]`` on
    ``node_ids``' device: ``out[i]`` depends on ``(base, node_ids[i], rows,
    cols)`` alone."""
    k0, k1, stream = base
    n = rows * cols
    nc = (n + 3) // 4
    if nc > M32 or cols > M32:
        raise ValueError(f"a [{rows}, {cols}] block needs more than 2^32 "
                         "counters")
    ids = node_ids.to(torch.int64)
    j = torch.arange(nc, dtype=torch.int64, device=ids.device)[None, :]
    x = philox4x32(j, ids[:, None], torch.full_like(j, stream),
                   torch.full_like(j, cols), k0, k1)
    z0, z1 = _box_muller(x[0], x[1])
    z2, z3 = _box_muller(x[2], x[3])
    z = torch.stack((z0, z1, z2, z3), dim=-1).reshape(ids.shape[0], 4 * nc)
    return z[:, :n].to(dtype).reshape(ids.shape[0], rows, cols)


def level_gaussians(seed: int, level: int, n_nodes: int, rows: int,
                    cols: int, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
    """Test matrices for every node of a tree level:
    ``[n_nodes, rows, cols]`` on ``device``."""
    ids = torch.arange(n_nodes, dtype=torch.int64, device=device)
    return node_gaussians(stream_key(seed, level), ids, rows=rows,
                          cols=cols, dtype=dtype)
