"""PyTorch port: the sharding rules (``repro_torch.parallel.sharding``) and
``core.admissibility.structure_stats``, against the reference.

- ``param_spec`` of every leaf of all 10 configs at published width (the
  tree from ``models.api.abstract_params``, on ``meta``) at both production
  layouts, with ``fsdp`` and ``attn_tp`` on and off, equals the reference's
  ``param_spec``.  The reference's is called in-process with a stub mesh
  whose ``shape`` is the layout's dict: it reads only ``mesh.shape``.
  ``make_param_shardings`` gives the same spec leaf by leaf, in the tree's
  structure;
- ``Rules``' activation specs equal the reference's ``PartitionSpec``s
  (entries compared as tuples) for every combination of its switches;
- ``shard_shape`` divides each dim by its axes' sizes and raises where
  ``NamedSharding.shard_shape`` would; ``constrain`` passes its input
  through without a device mesh and raises ``NotImplementedError`` with
  one;
- ``BlockStructure.sparsity_constant`` and ``structure_stats`` equal the
  reference's on small trees (2D and 3D).

JAX is imported inside fixtures and helpers only.  No depth or sequence is
cut here: the parameter trees are built on ``meta`` at full size.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCHS, get_config
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, MeshLayout, \
    data_axes
from repro_torch.models import api
from repro_torch.parallel import sharding as S

torch.set_num_threads(2)

LAYOUTS = {"1pod": SINGLE_POD, "2pod": MULTI_POD}


class _StubMesh:
    """What the reference's ``param_spec`` reads of a mesh: its shape."""

    def __init__(self, layout: MeshLayout):
        self.shape = dict(zip(layout.axes, layout.shape))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _ref_rules(rules: S.Rules):
    from repro.parallel.sharding import Rules
    return Rules(**{f: getattr(rules, f) for f in (
        "data_axes", "model_axis", "fsdp", "seq_parallel", "attn_tp",
        "batch_shardable", "seq_axes_decode")})


@pytest.fixture(scope="module")
def trees():
    """Every config's parameter tree on ``meta``, at published width."""
    return {arch: api.abstract_params(get_config(arch)) for arch in ARCHS}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_reference(trees, arch, layout):
    from repro.parallel.sharding import param_spec as ref_spec
    lay = LAYOUTS[layout]
    mesh = _StubMesh(lay)
    leaves = list(_leaves(trees[arch]))
    assert leaves and all(t.device.type == "meta" for _, t in leaves)
    sharded = 0
    for fsdp, attn_tp in itertools.product((True, False), repeat=2):
        rules = S.Rules(data_axes=data_axes(lay), fsdp=fsdp,
                        attn_tp=attn_tp)
        rrules = _ref_rules(rules)
        specs = dict(_leaves(S.make_param_shardings(trees[arch], rules,
                                                    lay)))
        for path, t in leaves:
            got = S.param_spec(path, tuple(t.shape), rules, lay)
            want = tuple(ref_spec(path, tuple(t.shape), rrules, mesh))
            assert got == want, (arch, layout, fsdp, attn_tp, path)
            assert specs[path] == got
            sharded += any(e is not None for e in got)
            # every spec lays the leaf out evenly
            S.shard_shape(t.shape, got, lay)
    assert sharded > 0


def test_fsdp_and_attn_tp_change_specs(trees):
    """The switches matter on a real tree: FSDP shards a leaf over the data
    axes, ``attn_tp=False`` keeps the attention weights off the model
    axis."""
    tree = trees["qwen3_0_6b"]
    on = S.make_param_shardings(tree, S.Rules(), SINGLE_POD)
    off = S.make_param_shardings(tree, S.Rules(fsdp=False, attn_tp=False),
                                 SINGLE_POD)
    assert on["blocks"]["attn"]["wq"] != off["blocks"]["attn"]["wq"]
    assert off["blocks"]["attn"]["wq"] == (None, None, None)
    assert "data" in on["embed"] and "data" not in off["embed"]
    assert on["blocks"]["norm1"][0] is None      # the layer dim never


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_activation_specs_equal_reference(layout):
    lay = LAYOUTS[layout]
    for sp, shardable, seq in itertools.product(
            (True, False), (True, False),
            (None, data_axes(lay) + ("model",))):
        rules = S.Rules(data_axes=data_axes(lay), seq_parallel=sp,
                        batch_shardable=shardable, seq_axes_decode=seq)
        ref = _ref_rules(rules)
        assert rules.dp == ref.dp and rules.tp == ref.tp
        assert rules.decode_seq == ref.decode_seq
        for name in ("act", "act_full", "kv_cache_decode", "logits"):
            assert getattr(rules, name)() == \
                tuple(getattr(ref, name)()), (name, sp, shardable, seq)
        for h in (16, 20, 8):
            assert rules.heads(h, 16) == tuple(ref.heads(h, 16))


def test_mesh_axis_size():
    from repro.parallel.sharding import mesh_axis_size as ref_size
    for lay in LAYOUTS.values():
        for axes in ("model", data_axes(lay), data_axes(lay) + ("model",)):
            assert S.mesh_axis_size(lay, axes) == \
                ref_size(_StubMesh(lay), axes)
    assert S.mesh_axis_size(MULTI_POD, ("pod", "data", "model")) == 512


def test_shard_shape():
    assert S.shard_shape((128, 32768, 8, 128), ("data", "model", None, None),
                         SINGLE_POD) == (8, 2048, 8, 128)
    assert S.shard_shape((1, 524288, 32, 112),
                         (None, ("pod", "data", "model"), None, None),
                         MULTI_POD) == (1, 1024, 32, 112)
    assert S.shard_shape((3, 5), (), SINGLE_POD) == (3, 5)
    with pytest.raises(ValueError):
        S.shard_shape((1500, 384), ("model", None), SINGLE_POD)
    with pytest.raises(ValueError):
        S.shard_shape((16,), (None, None), SINGLE_POD)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shard_shape_equals_named_sharding(layout):
    """``NamedSharding(AbstractMesh(layout), spec).shard_shape`` (no
    devices needed) on every spec kind, and the same refusals."""
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
    lay = LAYOUTS[layout]
    mesh = AbstractMesh(lay.shape, lay.axes)
    dp = data_axes(lay) if len(data_axes(lay)) > 1 else "data"
    cases = [((128, 32768, 8, 128), (dp, "model", None, None)),
             ((1, 524288, 4), (None, data_axes(lay) + ("model",), None)),
             ((4096, 151936), (None, "model")),
             ((28, 1024, 2048), (None, dp, "model")),
             ((1500, 384), ("model", None)),
             ((7, 3), (None, None))]
    for shape, spec in cases:
        try:
            want = NamedSharding(mesh, P(*spec)).shard_shape(shape)
        except ValueError:
            with pytest.raises(ValueError):
                S.shard_shape(shape, spec, lay)
            continue
        assert S.shard_shape(shape, spec, lay) == tuple(want)


def test_constrain_without_a_mesh_is_the_identity():
    """``constrain`` without a mesh returns its input; on a one-rank mesh
    every layout is the whole tensor, so it is the identity too (and so
    are ``local_block`` and ``assemble``).  The layout changes on 2 and 4
    ranks are in ``test_torch_collectives.py``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    x = torch.randn(4, 8)
    assert S.constrain(x, S.Rules().act_full()) is x
    assert S.local_block(x, ("data", "model"), None) is x
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = make_test_mesh(1, 1)
            for spec in (("data", "model"), ("model", None), (None, None)):
                y = S.constrain(x, spec, mesh)
                assert torch.equal(y, x)
                assert torch.equal(S.local_block(x, spec, mesh), x)
                assert torch.equal(S.assemble(x, spec, mesh), x)
            with pytest.raises(ValueError, match="mesh"):
                S.constrain(x, (("model", "data"), None), mesh,
                            src=(None, None))
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("dim,side", [(2, 32), (3, 8)])
def test_structure_stats_equal_reference(dim, side):
    from repro.core import admissibility as RA
    from repro.core import clustering as RC
    from repro_torch.core import admissibility as TA
    from repro_torch.core import clustering as TC
    pts = TC.regular_grid_points(side, dim)
    assert np.array_equal(pts, RC.regular_grid_points(side, dim))
    bs = TA.build_block_structure(TC.build_cluster_tree(pts, 16), 0.9)
    rbs = RA.build_block_structure(RC.build_cluster_tree(pts, 16), 0.9)
    assert TA.structure_stats(bs) == RA.structure_stats(rbs)
    assert bs.sparsity_constant() == rbs.sparsity_constant() > 0
