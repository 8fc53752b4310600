"""The port's level-by-level cluster tree against the reference's
per-node recursion, on the CPU: ``perm`` and ``points`` bit for bit, and
every level's boxes (a zero side taken as +0.0, ``box_bits``)."""
import numpy as np
import pytest
import torch

from repro.core.clustering import build_cluster_tree as ref_build
from repro_torch.core.clustering import build_cluster_tree
from torch_clustering_sets import SETS, assert_same_tree

torch.set_num_threads(2)


@pytest.mark.parametrize("leaf", [8, 64])
@pytest.mark.parametrize("n", [1 << 12, 1 << 14])
@pytest.mark.parametrize("kind", sorted(SETS))
def test_tree_matches_reference(kind, n, leaf):
    pts = SETS[kind](n, seed=n + leaf)
    assert_same_tree(build_cluster_tree(pts, leaf), ref_build(pts, leaf))


def test_meta_device_builds_on_the_cpu():
    pts = SETS["ties"](1 << 12, seed=3)
    assert_same_tree(build_cluster_tree(pts, 16, device="meta"),
                     ref_build(pts, 16))


def test_float32_points_are_taken_as_float64():
    pts = SETS["cloud3d"](1 << 12, seed=4).astype(np.float32)
    tree = build_cluster_tree(pts, 32)
    assert tree.points.dtype == np.float64
    assert_same_tree(tree, ref_build(pts, 32))


def test_single_leaf_tree():
    pts = SETS["cloud3d"](64, seed=5)
    tree = build_cluster_tree(pts, 64)
    assert tree.depth == 0 and len(tree.box_min) == 1
    assert_same_tree(tree, ref_build(pts, 64))


@pytest.mark.parametrize("n,leaf,match", [
    (1000, 64, "multiple of leaf_size"),
    (3 * 64, 64, "power of two"),
])
def test_bad_sizes_raise(n, leaf, match):
    pts = SETS["cloud3d"](n, seed=6)
    with pytest.raises(ValueError, match=match):
        build_cluster_tree(pts, leaf)
    with pytest.raises(ValueError, match=match):
        ref_build(pts, leaf)
