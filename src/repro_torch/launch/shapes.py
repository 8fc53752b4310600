"""Model inputs and decode caches of every (arch x shape) cell on the
``meta`` device, and their specs: the port of the reference's
``launch/shapes.py``.

``input_specs`` returns a stand-in for every model input (tokens plus the
stub modality embeddings: the frontend of the [audio]/[vlm] archs is a
precomputed-embedding stub) as ``meta`` tensors of the reference's shapes
and dtypes.  Nothing is allocated.

``abstract_cache`` builds the decode cache of a ``seq_len`` context from a
short prefill with ``cache_len = seq_len``: the caches' shapes do not
depend on the prompt's length, and a prefill of ``seq_len`` tokens would
walk the recurrent families' chunk loops once per chunk (minutes to an
hour on ``meta`` at long_500k), where the reference's ``jax.eval_shape``
traces its scan once.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import Rules

# a whole number of RWKV6's 16-token and Mamba2's 64-token chunks (a
# length they do not divide runs as one chunk)
CACHE_PROMPT = 64


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict[str, Any]:
    b = shape.global_batch
    s = shape.seq_len
    dt = getattr(torch, cfg.act_dtype)
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s + 1), torch.int32)}
    elif shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
    else:  # decode: one new token against a seq_len cache
        batch = {"tokens": _meta((b, 1), torch.int32)}
    if cfg.family == "vlm":
        batch["img_embed"] = _meta((b, cfg.n_img_tokens, cfg.d_model), dt)
    if cfg.family == "audio" and shape.kind != "decode":
        batch["frames"] = _meta((b, cfg.n_frames, cfg.d_model), dt)
    return batch


def batch_specs(cfg: ModelConfig, shape: ShapeCfg, rules: Rules
                ) -> Dict[str, Any]:
    """Specs matching ``input_specs``."""
    out = {"tokens": (rules.dp, None)}
    if cfg.family == "vlm":
        out["img_embed"] = (rules.dp, None, None)
    if cfg.family == "audio" and shape.kind != "decode":
        out["frames"] = (rules.dp, None, None)
    return out


def abstract_cache(cfg: ModelConfig, shape: ShapeCfg, params=None):
    """The decode cache of a ``shape.seq_len`` context and
    ``shape.global_batch`` sequences on ``meta``: the cache of a
    ``CACHE_PROMPT``-token prefill with ``cache_len = shape.seq_len``
    (``params``: the tree to run it with, default ``abstract_params``)."""
    if params is None:
        params = api.abstract_params(cfg)
    pre = ShapeCfg(shape.name, min(CACHE_PROMPT, shape.seq_len),
                   shape.global_batch, "prefill")
    batch = input_specs(cfg, pre)
    if cfg.family == "audio":
        batch["frames"] = _meta((shape.global_batch, cfg.n_frames,
                                 cfg.d_model), getattr(torch, cfg.act_dtype))
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, batch, cache_len=shape.seq_len)
    return cache


def cache_spec_tree(cfg: ModelConfig, cache, rules: Rules,
                    msize: int = 16, dsize: int = 16, seq_2d: bool = False):
    """Specs of the decode cache, in its structure.

    KV tensors [..., B, S, H, dh] are sequence-sharded over the model axis
    (decode attention reductions become psums); recurrent states are
    batch-sharded; dims that do not divide the axis (long_500k batch=1,
    whisper's 1500-frame cross cache) stay replicated.  ``seq_2d``: when
    the batch cannot use the data axes (long_500k batch=1), shard the
    sequence over (data x model) jointly.
    """
    def spec_for(key: str, leaf):
        nd = leaf.dim()
        shp = leaf.shape
        base = [None] * nd
        if key.startswith(("k", "v")) and nd >= 5:
            # [L(or G), B, S, H, dh] or [G, per, B, S, H, dh]
            if rules.dp is not None and shp[nd - 4] % dsize == 0:
                base[nd - 4] = rules.dp
            seq_axes = rules.tp
            if seq_2d and rules.dp is None and \
                    shp[nd - 3] % (dsize * msize) == 0:
                seq_axes = tuple(rules.data_axes) + (rules.model_axis,)
            if shp[nd - 3] % msize == 0:
                base[nd - 3] = seq_axes
            return tuple(base)
        # recurrent states [L, B, ...]
        if nd >= 2 and rules.dp is not None and shp[1] % dsize == 0:
            base[1] = rules.dp
        return tuple(base)

    def walk(key, t):
        if isinstance(t, dict):
            return {k: walk(key, v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(key, v) for v in t)
        return spec_for(key, t)

    return {k: walk(str(k), v) for k, v in cache.items()}
