"""Unified model API, the port of the reference's ``models/api.py``:
every architecture exposes the same entry points.

    init_params(cfg, seed, device)                          -> params
    train_loss(cfg, params, batch)                          -> scalar
    prefill(cfg, params, batch, cache_len)                  -> (logits, cache)
    decode_step(cfg, params, batch, cache, pos)             -> (logits, cache)

``batch`` is a dict holding ``tokens`` (plus the stub modality inputs of
the families not ported yet).  Only the dense family is ported; every
other family raises ``NotImplementedError`` naming its ROADMAP item.

``params_from_numpy`` carries the reference's parameter pytree across (as
numpy arrays, bfloat16 included), so both packages compute the same
function.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from . import transformer
from .config import ModelConfig

_PENDING = {
    "rwkv": "rwkv6 serving (models/rwkv6.py)",
    "hybrid": "mamba2 + zamba2 serving (models/mamba2.py, models/zamba2.py)",
    "vlm": "vision serving (models/vision.py)",
    "audio": "whisper serving (models/whisper.py)",
}


def _dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        item = _PENDING.get(cfg.family, f"the {cfg.family!r} family")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue 1, LM substrate item (a): {item})")


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def init_params(cfg: ModelConfig, seed: Union[int, torch.Generator] = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters of ``cfg`` on ``device``, drawn from ``seed`` (an
    int, or a ``torch.Generator`` whose device is used)."""
    _dense(cfg)
    return transformer.init_params(cfg, _generator(seed, device))


def train_loss(cfg: ModelConfig, params, batch: Dict[str, Any],
               rules=None, msize: int = 1):
    _dense(cfg)
    return transformer.train_loss(cfg, params, batch["tokens"], rules, msize)


def prefill(cfg: ModelConfig, params, batch, rules=None, msize: int = 1,
            cache_len: Optional[int] = None):
    _dense(cfg)
    return transformer.prefill(cfg, params, batch["tokens"], rules, msize,
                               cache_len=cache_len)


def decode_step(cfg: ModelConfig, params, batch, cache, pos, rules=None,
                msize: int = 1):
    _dense(cfg)
    return transformer.decode_step(cfg, params, batch["tokens"], cache, pos,
                                   rules, msize)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg: ModelConfig, tree, device="cuda"
                      ) -> Dict[str, Any]:
    """The reference's parameter pytree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as the port's tensors on
    ``device``, checked against ``cfg``'s shapes."""
    _dense(cfg)
    out = transformer.tree_map(lambda a: _tensor(a, device), dict(tree))
    want = {"embed": (cfg.vocab, cfg.d_model),
            "final_norm": (cfg.d_model,)}
    if not cfg.tie_embed:
        want["head"] = (cfg.d_model, cfg.vocab)
    for k, shape in want.items():
        if k not in out or tuple(out[k].shape) != shape:
            raise ValueError(f"{cfg.name}: parameter {k!r} should be "
                             f"{shape}, got "
                             f"{tuple(out[k].shape) if k in out else None}")
    if out["blocks"]["norm1"].shape[0] != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {out['blocks']['norm1'].shape[0]} "
                         f"stacked layers, the config has {cfg.n_layers}")
    return out
