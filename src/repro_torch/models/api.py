"""Unified model API, the port of the reference's ``models/api.py``:
every architecture exposes the same entry points.

    init_params(cfg, seed, device)                          -> params
    abstract_params(cfg)                                    -> params on meta
    train_loss(cfg, params, batch)                          -> scalar
    prefill(cfg, params, batch, cache_len)                  -> (logits, cache)
    decode_step(cfg, params, batch, cache, pos)             -> (logits, cache)

``batch`` is a dict holding ``tokens`` plus the stub modality inputs:
``img_embed`` [B, n_img_tokens, D] for the ``vlm`` family and ``frames``
[B, n_frames, D] for ``audio`` (read by the prefill and the loss; decode
reads the cached cross K/V).  The families dispatch on ``cfg.family``:
``rwkv`` (``rwkv6``), ``hybrid`` (``zamba2``), ``vlm`` (``vision``),
``audio`` (``whisper``) and ``dense`` (``transformer``, with the
mixture-of-experts FFN where ``cfg.moe``).  ``train_loss`` is
differentiable (``torch.autograd.grad`` over the parameter leaves, as
``launch/train.py`` takes it), each family recomputing its layers in the
backward when ``cfg.remat``.

``params_from_numpy`` carries the reference's parameter pytree across (as
numpy arrays, bfloat16 included), so both packages compute the same
function.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from . import rwkv6, transformer, vision, whisper, zamba2
from .config import ModelConfig
from .transformer import _head, chunked_ce_loss


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def _logits_last(params, hidden) -> torch.Tensor:
    return (hidden[:, -1] @ _head(params)).float()


def init_params(cfg: ModelConfig, seed: Union[int, torch.Generator] = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters of ``cfg`` on ``device``, drawn from ``seed`` (an
    int, or a ``torch.Generator`` whose device is used)."""
    gen = _generator(seed, device)
    if cfg.family == "rwkv":
        return rwkv6.rwkv_init(cfg, gen)
    if cfg.family == "hybrid":
        return zamba2.init_params(cfg, gen)
    if cfg.family == "vlm":
        return vision.init_params(cfg, gen)
    if cfg.family == "audio":
        return whisper.init_params(cfg, gen)
    return transformer.init_params(cfg, gen)


def train_loss(cfg: ModelConfig, params, batch: Dict[str, Any],
               rules=None, msize: int = 1):
    """Next-token CE over ``batch["tokens"]`` [B, S+1] (targets = tokens
    shifted), differentiable in ``params``."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    if cfg.family == "rwkv":
        hid, _ = rwkv6.rwkv_backbone(cfg, params, inp, rules, train=True)
    elif cfg.family == "hybrid":
        hid, _ = zamba2.forward(cfg, params, inp, rules=rules, msize=msize,
                                mode="train")
    elif cfg.family == "vlm":
        hid, _ = vision.forward(cfg, params, inp, batch["img_embed"],
                                rules=rules, msize=msize, mode="train")
    elif cfg.family == "audio":
        hid, _ = whisper.forward(cfg, params, inp, batch["frames"],
                                 rules=rules, msize=msize, mode="train")
    else:
        return transformer.train_loss(cfg, params, tokens, rules, msize)
    return chunked_ce_loss(cfg, hid, _head(params), tgt, rules)


def prefill(cfg: ModelConfig, params, batch, rules=None, msize: int = 1,
            cache_len: Optional[int] = None):
    """Process the prompts ``batch["tokens"]`` [B, S]; returns (last
    logits [B, V] float32, cache).  The attention caches are padded to
    ``cache_len`` (default S)."""
    tokens = batch["tokens"]
    if cfg.family == "rwkv":
        hid, state = rwkv6.rwkv_backbone(cfg, params, tokens, rules)
        return _logits_last(params, hid), {"state": state}
    if cfg.family == "hybrid":
        hid, cache = zamba2.forward(cfg, params, tokens, rules=rules,
                                    msize=msize, mode="prefill",
                                    cache_len=cache_len)
    elif cfg.family == "vlm":
        hid, cache = vision.forward(cfg, params, tokens, batch["img_embed"],
                                    rules=rules, msize=msize, mode="prefill",
                                    cache_len=cache_len)
    elif cfg.family == "audio":
        hid, cache = whisper.forward(cfg, params, tokens, batch["frames"],
                                     rules=rules, msize=msize,
                                     mode="prefill", cache_len=cache_len)
    else:
        return transformer.prefill(cfg, params, tokens, rules, msize,
                                   cache_len=cache_len)
    return _logits_last(params, hid), cache


def decode_step(cfg: ModelConfig, params, batch, cache, pos, rules=None,
                msize: int = 1):
    """One token ``batch["tokens"]`` [B, 1] at position ``pos`` (a scalar;
    a 0-d tensor is read on the device).  Returns (logits [B, V] float32,
    new cache)."""
    token = batch["tokens"]
    if cfg.family == "rwkv":
        hid, state = rwkv6.rwkv_backbone(cfg, params, token, rules,
                                         state=cache["state"])
        return _logits_last(params, hid), {"state": state}
    if cfg.family == "hybrid":
        hid, cache = zamba2.forward(cfg, params, token, rules=rules,
                                    msize=msize, mode="decode", cache=cache,
                                    pos=pos)
    elif cfg.family == "vlm":
        hid, cache = vision.forward(cfg, params, token, None, rules=rules,
                                    msize=msize, mode="decode", cache=cache,
                                    pos=pos)
    elif cfg.family == "audio":
        hid, cache = whisper.forward(cfg, params, token, None, rules=rules,
                                     msize=msize, mode="decode", cache=cache,
                                     pos=pos)
    else:
        return transformer.decode_step(cfg, params, token, cache, pos,
                                       rules, msize)
    return _logits_last(params, hid), cache


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


class _ShapeOnly(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device: the
    family's init then builds the parameter tree's shapes, allocating
    nothing."""

    @property
    def device(self):
        return torch.device("meta")


def _check_shapes(cfg, got, want, path="") -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(
                f"{cfg.name}: parameters {path or '(root)'} should hold "
                f"{sorted(want)}, got "
                f"{sorted(got) if isinstance(got, dict) else type(got)}")
        for k in want:
            _check_shapes(cfg, got[k], want[k], f"{path}/{k}" if path else k)
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{cfg.name}: parameter {path!r} should be "
                         f"{tuple(want.shape)}, got {tuple(got.shape)}")


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` on the ``meta`` device: every leaf's
    shape and dtype, nothing allocated (the reference's ``jax.eval_shape``
    of ``init_params``; the dry run's stand-in)."""
    return init_params(cfg, _ShapeOnly())


def params_from_numpy(cfg: ModelConfig, tree, device="cuda"
                      ) -> Dict[str, Any]:
    """The reference's parameter pytree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as the port's tensors on
    ``device``, checked against the keys and shapes of ``cfg``'s
    parameters (every family: rwkv's stacked blocks, zamba2's
    ``super``/``shared``/``tail``, vision's ``plain``/``cross``, whisper's
    ``enc``/``dec``/``enc_norm``, the experts' ``router``/``moe_w*``)."""
    out = transformer.tree_map(lambda a: _tensor(a, device), dict(tree))
    _check_shapes(cfg, out, abstract_params(cfg))
    return out
