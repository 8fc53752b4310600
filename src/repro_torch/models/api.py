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

On a device mesh (``mesh=``, a ``("data", "model")`` or ``("pod", "data",
"model")`` ``DeviceMesh`` from ``launch.mesh.make_device_mesh``/
``make_test_mesh``, or a ``launch.mesh.MeshComms`` -- ``dry_mesh_comms``'s
walks one rank on ``meta`` --, with ``rules=``, a
``parallel.sharding.Rules`` whose data axes are the mesh's) every rank calls the entry points in step
with its blocks: the parameters laid out by ``param_specs`` (``init_params``
and ``params_from_numpy`` slice the seeded global tree, so every layout
starts from the same numbers), its data shard's rows of the batch, and
the cache blocks a prefill returned; the logits come back as its block
of ``transformer.logits_spec`` and the caches as blocks of
``cache_specs``.  The reference's constraints change no values, so a mesh
run computes the one-device function, except the MoE's routing, which
runs per data shard (``models/moe.py``).  ``msize`` > 1 without a mesh
raises ``ValueError``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.launch.mesh import mesh_comms
from repro_torch.parallel import sharding as S
from . import rwkv6, transformer, vision, whisper, zamba2
from .config import ModelConfig
from .transformer import _head, chunked_ce_loss, last_logits


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def _logits_last(params, hidden) -> torch.Tensor:
    return (hidden[:, -1] @ _head(params)).float()


@functools.lru_cache(maxsize=64)
def param_specs(cfg: ModelConfig, rules: S.Rules, layout):
    """The spec of every parameter of ``cfg`` under ``rules`` on a mesh of
    ``layout`` (``sharding.make_param_shardings`` of the tree's shapes)."""
    return S.make_param_shardings(abstract_params(cfg), rules, layout)


def shard_ctx(cfg: ModelConfig, rules, msize: int, mesh
              ) -> Optional[S.ShardCtx]:
    """The ``ShardCtx`` of a call on ``mesh`` (None without one)."""
    if mesh is None:
        if msize > 1:
            raise ValueError(f"msize={msize} needs a device mesh (mesh=) "
                             f"whose model axis it is")
        return None
    mc = mesh_comms(mesh)
    rules = rules if rules is not None else S.Rules()
    m = mc.layout.axis_size(rules.tp)
    if msize not in (1, m):
        raise ValueError(f"msize={msize}, but the mesh's {rules.tp!r} axis "
                         f"has {m} ranks")
    return S.ShardCtx(mc, rules, param_specs(cfg, rules, mc.layout))


def _prepare(cfg, params, rules, msize, mesh):
    ctx = shard_ctx(cfg, rules, msize, mesh)
    return ctx, (params if ctx is None else ctx.tree(params))


def _seq(cfg) -> bool:
    """Whether the family's residual stream is sequence-parallel on a mesh
    (the recurrent ones keep it whole)."""
    return cfg.family not in ("rwkv", "hybrid")


def shard_params(cfg: ModelConfig, params, rules, mesh):
    """This rank's blocks of the global parameter tree ``params``."""
    rules = rules if rules is not None else S.Rules()
    return S.tree_local(params, param_specs(
        cfg, rules, mesh_comms(mesh).layout), mesh)


def gather_params(cfg: ModelConfig, params, rules, mesh):
    """The global parameter tree from every rank's blocks (every rank
    calls it and gets the whole tree)."""
    rules = rules if rules is not None else S.Rules()
    return S.tree_assemble(params, param_specs(
        cfg, rules, mesh_comms(mesh).layout), mesh)


def cache_specs(cfg: ModelConfig, cache, rules, mesh):
    """The layout of every leaf of a cache a prefill or decode step
    returned on ``mesh``: the self-attention K/V sequence-sharded
    (``rules.kv_cache_decode()``), the cross K/V as the prefill computed
    them (KV heads over ``model`` in heads mode, else whole), the ssm and
    wkv states over their heads, the conv and token-shift states whole."""
    ctx = shard_ctx(cfg, rules, 1, mesh)
    dp, tp = ctx.rules.dp, ctx.rules.tp
    heads = tp if ctx.heads_tp(cfg) else None

    def spec(key, x):
        lead = (None,) * (x.dim() - 4)
        if key in ("k", "v", "k_plain", "v_plain", "k_cself", "v_cself"):
            return lead + (dp, ctx.rules.decode_seq, None, None)
        if key in ("k_cross", "v_cross"):
            return lead + (dp, None, heads, None)
        if key == "ssm":
            nh = 2 * cfg.d_model // cfg.mamba_head_dim
            return (None, dp, tp if ctx.tp_ok(nh) else None, None, None)
        if key == "conv":
            return (None, dp, None, None)
        raise KeyError(key)

    if "state" in cache:
        wkv, l1, l2 = cache["state"]
        nh = cfg.d_model // cfg.rwkv_head_size
        return {"state": ((None, dp, tp if ctx.tp_ok(nh) else None, None,
                           None), (None, dp, None), (None, dp, None))}
    return {k: spec(k, v) for k, v in cache.items()}


def init_params(cfg: ModelConfig, seed: Union[int, torch.Generator] = 0,
                device="cuda", mesh=None, rules=None) -> Dict[str, Any]:
    """Random parameters of ``cfg`` on ``device``, drawn from ``seed`` (an
    int, or a ``torch.Generator`` whose device is used); on a mesh, this
    rank's blocks of that global tree."""
    if mesh is not None:
        return shard_params(cfg, init_params(cfg, seed, device), rules, mesh)
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
               rules=None, msize: int = 1, mesh=None):
    """Next-token CE over ``batch["tokens"]`` [B, S+1] (targets = tokens
    shifted), differentiable in ``params``.  On a mesh: this rank's
    parameter blocks and data shard's rows; every rank returns the global
    loss, and the gradients of its blocks are the global gradients'
    blocks."""
    ctx, params = _prepare(cfg, params, rules, msize, mesh)
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    if cfg.family == "rwkv":
        hid, _ = rwkv6.rwkv_backbone(cfg, params, inp, rules, train=True,
                                     mesh=ctx)
    elif cfg.family == "hybrid":
        hid, _ = zamba2.forward(cfg, params, inp, rules=rules, msize=msize,
                                mode="train", mesh=ctx)
    elif cfg.family == "vlm":
        hid, _ = vision.forward(cfg, params, inp, batch["img_embed"],
                                rules=rules, msize=msize, mode="train",
                                mesh=ctx)
    elif cfg.family == "audio":
        hid, _ = whisper.forward(cfg, params, inp, batch["frames"],
                                 rules=rules, msize=msize, mode="train",
                                 mesh=ctx)
    else:
        return transformer.train_loss(cfg, params, tokens, rules, msize,
                                      mesh=ctx)
    if ctx is not None:
        ctx = ctx.at(inp.shape[1], _seq(cfg))
    return chunked_ce_loss(cfg, hid, _head(params, ctx, cfg), tgt, rules,
                           ctx)


def prefill(cfg: ModelConfig, params, batch, rules=None, msize: int = 1,
            cache_len: Optional[int] = None, mesh=None):
    """Process the prompts ``batch["tokens"]`` [B, S]; returns (last
    logits [B, V] float32, cache).  The attention caches are padded to
    ``cache_len`` (default S; on a mesh it must divide over the decode
    cache's sequence shards)."""
    ctx, params = _prepare(cfg, params, rules, msize, mesh)
    tokens = batch["tokens"]
    kw = dict(rules=rules, msize=msize, mesh=ctx)
    if cfg.family == "rwkv":
        hid, cache = rwkv6.rwkv_backbone(cfg, params, tokens, rules,
                                         mesh=ctx)
        cache = {"state": cache}
    elif cfg.family == "hybrid":
        hid, cache = zamba2.forward(cfg, params, tokens, mode="prefill",
                                    cache_len=cache_len, **kw)
    elif cfg.family == "vlm":
        hid, cache = vision.forward(cfg, params, tokens, batch["img_embed"],
                                    mode="prefill", cache_len=cache_len,
                                    **kw)
    elif cfg.family == "audio":
        hid, cache = whisper.forward(cfg, params, tokens, batch["frames"],
                                     mode="prefill", cache_len=cache_len,
                                     **kw)
    else:
        return transformer.prefill(cfg, params, tokens, rules, msize,
                                   cache_len=cache_len, mesh=ctx)
    if ctx is None:
        return _logits_last(params, hid), cache
    return last_logits(cfg, params, hid,
                       ctx.at(tokens.shape[1], _seq(cfg))), cache


def decode_step(cfg: ModelConfig, params, batch, cache, pos, rules=None,
                msize: int = 1, mesh=None):
    """One token ``batch["tokens"]`` [B, 1] at position ``pos`` (a scalar;
    a 0-d tensor is read on the device).  Returns (logits [B, V] float32,
    new cache)."""
    ctx, params = _prepare(cfg, params, rules, msize, mesh)
    token = batch["tokens"]
    kw = dict(rules=rules, msize=msize, mesh=ctx, mode="decode",
              cache=cache, pos=pos)
    if cfg.family == "rwkv":
        hid, state = rwkv6.rwkv_backbone(cfg, params, token, rules,
                                         state=cache["state"], mesh=ctx)
        cache = {"state": state}
    elif cfg.family == "hybrid":
        hid, cache = zamba2.forward(cfg, params, token, **kw)
    elif cfg.family == "vlm":
        hid, cache = vision.forward(cfg, params, token, None, **kw)
    elif cfg.family == "audio":
        hid, cache = whisper.forward(cfg, params, token, None, **kw)
    else:
        return transformer.decode_step(cfg, params, token, cache, pos,
                                       rules, msize, mesh=ctx)
    if ctx is None:
        return _logits_last(params, hid), cache
    return last_logits(cfg, params, hid, ctx.at(1)), cache


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


def params_from_numpy(cfg: ModelConfig, tree, device="cuda", mesh=None,
                      rules=None) -> Dict[str, Any]:
    """The reference's parameter pytree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as the port's tensors on
    ``device``, checked against the keys and shapes of ``cfg``'s
    parameters (every family: rwkv's stacked blocks, zamba2's
    ``super``/``shared``/``tail``, vision's ``plain``/``cross``, whisper's
    ``enc``/``dec``/``enc_norm``, the experts' ``router``/``moe_w*``); on a
    mesh, this rank's blocks of it."""
    out = transformer.tree_map(lambda a: _tensor(a, device), dict(tree))
    _check_shapes(cfg, out, abstract_params(cfg))
    if mesh is not None:
        return shard_params(cfg, out, rules, mesh)
    return out
