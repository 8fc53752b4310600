"""H^2 token-mixing layer: the paper's operator as an LM module, the port
of the reference's ``models/h2mixer.py``.

Tokens live on the 1-D grid ``0..S-1``, a smooth kernel defines an S x S
mixing matrix, and the H^2 machinery applies it in O(S) instead of O(S^2)
-- the feature axis rides along as the paper's multi-vector ``nv``:

    y[b, :, d] = A_h2 @ x[b, :, d]        A = exp(-|i - j| / (S corr))

With ``backend="cuda"`` on the card the mixing HGEMV runs the
``batched_gemm`` and ``coupling_mv`` kernels at nv = B*D, and the
structure's ``compress`` the ``batched_qr``/``batched_svd`` kernels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compression import compress
from repro_torch.core.construction import construct_h2
from repro_torch.core.kernels_fn import exponential_kernel
from repro_torch.core.matvec import h2_matvec
from repro_torch.core.structure import H2Data, H2Shape
from .layers import dense_init, rms_norm


def h2mixer_structure(seq_len: int, leaf_size: int = 32, cheb_p: int = 4,
                      eta: float = 0.9, corr: float = 0.05,
                      tol: Optional[float] = 1e-4, dtype=torch.float32,
                      device="cuda", backend: str = "cuda"
                      ) -> Tuple[H2Shape, H2Data]:
    """Build (and recompress at ``tol``, on ``backend``) the H^2 mixing
    operator for positions 0..S-1 on ``device``."""
    pts = (np.arange(seq_len, dtype=np.float64) / seq_len)[:, None]
    shape, data, tree, _ = construct_h2(pts, exponential_kernel(corr),
                                        leaf_size=leaf_size, cheb_p=cheb_p,
                                        eta=eta, dtype=dtype, device=device)
    # 1-D tree on sorted points: the permutation is the identity, so no
    # reordering is needed at apply time
    if not (tree.perm == np.arange(seq_len)).all():
        raise RuntimeError("the 1-D cluster tree reordered the positions")
    if tol is not None:
        shape, data = compress(shape, data, tol=tol, backend=backend)
    return shape, data


def h2mixer_params(cfg, gen: torch.Generator, dtype) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "norm": torch.ones((d,), dtype=dtype, device=gen.device),
        "w_in": dense_init(gen, (d, d), dtype),
        "w_out": dense_init(gen, (d, d), dtype, scale=0.02),
        "gate": torch.zeros((d,), dtype=dtype, device=gen.device),
    }


def h2mixer_apply(cfg, p, x: torch.Tensor, shape: H2Shape, data: H2Data,
                  backend: str = "cuda") -> torch.Tensor:
    """x: [B, S, D] -> x + gated H^2 positional mix (residual layer)."""
    b, s, d = x.shape
    if s != shape.n:
        raise ValueError(f"sequence length {s}, the operator has "
                         f"{shape.n} positions")
    h = rms_norm(x, p["norm"], cfg.norm_eps) @ p["w_in"]
    # tokens-as-points, features-as-multivector: [S, B*D]
    hv = h.transpose(0, 1).reshape(s, b * d)
    mixed = h2_matvec(shape, data, hv.to(data.u_leaf.dtype), backend=backend)
    mixed = mixed.reshape(s, b, d).transpose(0, 1).to(x.dtype)
    out = (mixed @ p["w_out"]) * torch.tanh(p["gate"])
    return x + out
