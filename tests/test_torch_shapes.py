"""PyTorch port: the model inputs, parameters and decode caches of every
(arch x shape) cell on ``meta`` (``repro_torch.launch.shapes``,
``models.api.abstract_params``), against the reference's ``jax.eval_shape``
values.

- ``input_specs`` and ``batch_specs`` equal the reference's in shape, dtype
  and spec for every applicable cell (10 archs x 4 shapes, long_500k only
  for the sub-quadratic families) at both production layouts' rules;
- ``abstract_params`` has the reference's leaves, shapes and dtypes for
  all 10 configs, allocates nothing and equals ``init_params``' tree;
- ``abstract_cache`` has the reference's leaves, shapes and dtypes for
  every decode cell (decode_32k for all 10, long_500k for RWKV6 and
  Zamba2) and ``cache_spec_tree`` the reference's specs at both layouts,
  with and without ``seq_2d``; long_500k's cache is built in seconds (a
  short prefill, not a walk of 524,288 tokens).

Everything runs at published width and full depth: the trees are ``meta``
tensors.  JAX is imported inside fixtures and helpers only.
"""
import functools
import time

import pytest
import torch

from repro_torch.configs.base import ARCHS, SHAPES, get_config, \
    shape_applicable
from repro_torch.launch import shapes as TS
from repro_torch.launch.dryrun import cell_rules
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, data_axes
from repro_torch.models import api
from repro_torch.parallel.sharding import mesh_axis_size

torch.set_num_threads(2)

LAYOUTS = {"1pod": SINGLE_POD, "2pod": MULTI_POD}
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if shape_applicable(get_config(a), s)[0]]
DECODE = [(a, s) for a, s in CELLS if SHAPES[s].kind == "decode"]
LONG_CACHE_S = 30.0          # long_500k's abstract cache, wall seconds


def _flat(tree, path=""):
    """path -> leaf of a nested dict/tuple tree (the reference's
    ``tree_flatten_with_path`` names)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
    elif isinstance(tree, (list, tuple)) and not _is_spec(tree):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}" if path else str(i)))
    else:
        out[path] = tree
    return out


def _is_spec(t) -> bool:
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, str) or
        (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in t)


def _jflat(tree, is_leaf=None):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): leaf for p, leaf in flat}


def _sig(leaf):
    """(shape, dtype name) of a torch tensor or a ShapeDtypeStruct."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    import jax.numpy as jnp
    return tuple(leaf.shape), jnp.dtype(leaf.dtype).name


def _ref_rules(rules):
    from repro.parallel.sharding import Rules
    return Rules(**{f: getattr(rules, f) for f in (
        "data_axes", "model_axis", "fsdp", "seq_parallel", "attn_tp",
        "batch_shardable", "seq_axes_decode")})


def _ref_shape(name):
    from repro.configs.base import SHAPES as RS
    return RS[name]


@functools.lru_cache(maxsize=None)
def _ref_cfg(arch):
    from repro.configs.base import get_config as rget
    return rget(arch)


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape):
    from repro.launch.shapes import abstract_cache
    return abstract_cache(_ref_cfg(arch), _ref_shape(shape))


@functools.lru_cache(maxsize=None)
def _port_cache(arch, shape):
    t0 = time.perf_counter()
    cache = TS.abstract_cache(get_config(arch), SHAPES[shape])
    return cache, time.perf_counter() - t0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_batch_specs_equal_reference(arch, layout):
    from repro.launch import shapes as RSH
    cfg, rcfg = get_config(arch), _ref_cfg(arch)
    lay = LAYOUTS[layout]
    n = 0
    for a, s in CELLS:
        if a != arch:
            continue
        shape = SHAPES[s]
        got = TS.input_specs(cfg, shape)
        want = RSH.input_specs(rcfg, _ref_shape(s))
        assert sorted(got) == sorted(want), (arch, s)
        for k in want:
            assert got[k].device.type == "meta"
            assert _sig(got[k]) == _sig(want[k]), (arch, s, k)
        rules = cell_rules(cfg, shape, lay)
        specs = TS.batch_specs(cfg, shape, rules)
        rspecs = RSH.batch_specs(rcfg, _ref_shape(s), _ref_rules(rules))
        assert {k: tuple(v) for k, v in rspecs.items()} == specs
        n += 1
    assert n == (4 if get_config(arch).sub_quadratic else 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_reference(arch):
    from repro.models import api as rapi
    cfg = get_config(arch)
    mem = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    got = _flat(api.abstract_params(cfg))
    want = _jflat(rapi.abstract_params(_ref_cfg(arch)))
    assert sorted(got) == sorted(want)
    for k, leaf in got.items():
        assert leaf.device.type == "meta"
        assert _sig(leaf) == _sig(want[k]), (arch, k)
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == mem


def test_abstract_params_equal_init_params():
    cfg = get_config("qwen3_0_6b").reduced()
    real = _flat(api.init_params(cfg, 0, "cpu"))
    meta = _flat(api.abstract_params(cfg))
    assert {k: _sig(v) for k, v in real.items()} == \
        {k: _sig(v) for k, v in meta.items()}


@pytest.mark.parametrize("arch,shape", DECODE)
def test_abstract_cache_equals_reference(arch, shape):
    cache, secs = _port_cache(arch, shape)
    got = _flat(cache)
    want = _jflat(_ref_cache(arch, shape))
    assert sorted(got) == sorted(want), (arch, shape)
    for k, leaf in got.items():
        assert leaf.device.type == "meta"
        assert _sig(leaf) == _sig(want[k]), (arch, shape, k)
    if shape == "long_500k":
        assert secs < LONG_CACHE_S, f"{arch} long_500k cache took {secs} s"


@pytest.mark.parametrize("arch,shape", DECODE)
def test_cache_spec_tree_equals_reference(arch, shape):
    from repro.launch.shapes import cache_spec_tree as ref_tree
    from jax.sharding import PartitionSpec
    cfg = get_config(arch)
    cache, _ = _port_cache(arch, shape)
    rcache = _ref_cache(arch, shape)
    sharded = 0
    for lay in LAYOUTS.values():
        msize = lay.axis_size("model")
        dsize = mesh_axis_size(lay, data_axes(lay))
        for variant in (None, "cache-2d"):
            rules = cell_rules(cfg, SHAPES[shape], lay, variant)
            kw = dict(msize=msize, dsize=dsize, seq_2d=variant == "cache-2d")
            got = _flat(TS.cache_spec_tree(cfg, cache, rules, **kw))
            want = _jflat(ref_tree(_ref_cfg(arch), rcache,
                                   _ref_rules(rules), **kw),
                          is_leaf=lambda x: isinstance(x, PartitionSpec))
            assert sorted(got) == sorted(want)
            for k, spec in got.items():
                assert spec == tuple(want[k]), (arch, shape, k, variant)
                sharded += any(e is not None for e in spec)
    # RWKV6's long_500k state has batch 1 and no sequence: replicated
    assert sharded > 0 or (arch, shape) == ("rwkv6_7b", "long_500k")
