"""PyTorch port: tree, block lists, plan and Chebyshev values against the
JAX reference on the same points.

The host builders are copies, so the permutation, every block list, the
``H2Shape`` and every int32 plan array must be *identical*.  Both packages
evaluate the Chebyshev bases and kernel blocks in float64 and round to
float32, so the values agree to 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.clustering import regular_grid_points
from repro.core.construction import construct_h2 as ref_construct
from repro.core.kernels_fn import exponential_kernel as ref_exp
from repro_torch.core import construction as tc
from repro_torch.core import structure as ts
from repro_torch.core.kernels_fn import exponential_kernel

torch.set_num_threads(2)

# (points, leaf, p): the 16x16 grid of tests/test_plan.py and
# tests/test_compression.py at p in {3, 5, 6}, plus a 3D point cloud
CASES = {
    "grid16-p3": (lambda: regular_grid_points(16, 2), 8, 3),
    "grid16-p5": (lambda: regular_grid_points(16, 2), 8, 5),
    "grid16-p6": (lambda: regular_grid_points(16, 2), 8, 6),
    "cloud3d-p3": (lambda: np.random.default_rng(7).uniform(0, 1, (512, 3)),
                   16, 3),
}


def jax_data_to_numpy(data) -> dict:
    """The reference's H2Data as the flat dict ``data_from_numpy`` takes
    (the V tree is left out when it is an alias of the U tree)."""
    out = {"u_leaf": data.u_leaf, "dense": data.dense,
           "d_rows": data.d_rows, "d_cols": data.d_cols}
    aliased = data.v_leaf is data.u_leaf
    if not aliased:
        out["v_leaf"] = data.v_leaf
    for l in range(len(data.e)):
        out[f"e/{l}"] = data.e[l]
        if not aliased:
            out[f"f/{l}"] = data.f[l]
        out[f"s/{l}"] = data.s[l]
        out[f"s_rows/{l}"] = data.s_rows[l]
        out[f"s_cols/{l}"] = data.s_cols[l]
    if data.plan is not None:
        for name in ("sblk", "scol", "scnt", "cblk"):
            for l, a in enumerate(getattr(data.plan, name)):
                out[f"plan/{name}/{l}"] = a
        for name in ("dblk", "dcol", "dcnt"):
            out[f"plan/{name}"] = getattr(data.plan, name)
    if data.s_mar is not None:
        for l, a in enumerate(data.s_mar):
            out[f"s_mar/{l}"] = a
    if data.dense_mar is not None:
        out["dense_mar"] = data.dense_mar
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    make, leaf, p = CASES[request.param]
    pts = make()
    ref = ref_construct(pts, ref_exp(0.1), leaf, p, 0.9, dtype=jnp.float32)
    port = tc.construct_h2(pts, exponential_kernel(0.1), leaf, p, 0.9,
                           device="cpu")
    return ref, port


def test_tree_identical(built):
    (_, _, rtree, _), (_, _, ptree, _) = built
    np.testing.assert_array_equal(ptree.perm, rtree.perm)
    np.testing.assert_array_equal(ptree.points, rtree.points)
    for l in range(rtree.depth + 1):
        np.testing.assert_array_equal(ptree.box_min[l], rtree.box_min[l])
        np.testing.assert_array_equal(ptree.box_max[l], rtree.box_max[l])


def test_block_lists_identical(built):
    (_, _, _, rbs), (_, _, _, pbs) = built
    for l in range(rbs.depth + 1):
        np.testing.assert_array_equal(pbs.s_rows[l], rbs.s_rows[l])
        np.testing.assert_array_equal(pbs.s_cols[l], rbs.s_cols[l])
    np.testing.assert_array_equal(pbs.d_rows, rbs.d_rows)
    np.testing.assert_array_equal(pbs.d_cols, rbs.d_cols)
    assert pbs.row_maxb() == rbs.row_maxb()
    assert pbs.col_maxb() == rbs.col_maxb()


def test_shape_identical(built):
    (rshape, _, _, _), (pshape, pdata, _, _) = built
    assert dataclasses.asdict(pshape) == dataclasses.asdict(rshape)
    assert dataclasses.asdict(ts.shape_of(pdata, pshape.leaf_size)) == \
        dataclasses.asdict(pshape)


def test_plan_identical(built):
    (_, rdata, _, _), (_, pdata, _, _) = built
    for name in ("sblk", "scol", "scnt", "cblk"):
        for r, p in zip(getattr(rdata.plan, name), getattr(pdata.plan, name)):
            assert p.dtype == torch.int32
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    for name in ("dblk", "dcol", "dcnt"):
        p = getattr(pdata.plan, name)
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(),
                                      np.asarray(getattr(rdata.plan, name)))
    for r, p in zip(rdata.s_rows + rdata.s_cols, pdata.s_rows + pdata.s_cols):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def _close(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    assert port.dtype == torch.float32
    if ref.size:
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert np.abs(port.numpy() - ref).max() <= 1e-6 * scale


def test_values_close(built):
    (rshape, rdata, _, _), (_, pdata, _, _) = built
    _close(pdata.u_leaf, rdata.u_leaf)
    _close(pdata.dense, rdata.dense)
    _close(pdata.dense_mar, rdata.dense_mar)
    for l in range(rshape.depth + 1):
        _close(pdata.e[l], rdata.e[l])
        _close(pdata.s[l], rdata.s[l])
        _close(pdata.s_mar[l], rdata.s_mar[l])


def test_symmetric_alias(built):
    _, (_, pdata, _, _) = built
    assert pdata.v_leaf is pdata.u_leaf
    assert all(f is e for f, e in zip(pdata.f, pdata.e))


def test_carry_across_roundtrip_exact(built):
    (_, rdata, _, _), (_, pdata, _, _) = built
    arrays = jax_data_to_numpy(rdata)
    data = ts.data_from_numpy(arrays, device="cpu")
    assert data.v_leaf is data.u_leaf
    back = ts.data_to_numpy(data)
    assert sorted(back) == sorted(arrays)
    for key, a in arrays.items():
        assert back[key].dtype == a.dtype, key
        np.testing.assert_array_equal(back[key], a)
    # the port's own operator flattens to the same keys
    assert sorted(ts.data_to_numpy(pdata)) == sorted(arrays)


def test_carry_across_keeps_two_trees():
    rng = np.random.default_rng(0)
    arrays = {"u_leaf": rng.standard_normal((2, 4, 3)).astype(np.float32),
              "v_leaf": rng.standard_normal((2, 4, 3)).astype(np.float32),
              "dense": np.zeros((0, 4, 4), np.float32),
              "d_rows": np.zeros(0, np.int32), "d_cols": np.zeros(0, np.int32)}
    for l, nn in enumerate((1, 2)):
        k0 = 0 if l == 0 else 3
        arrays[f"e/{l}"] = rng.standard_normal((0 if l == 0 else nn, k0, k0)
                                               ).astype(np.float32)
        arrays[f"f/{l}"] = arrays[f"e/{l}"] + 1
        arrays[f"s/{l}"] = np.zeros((0, 3, 3), np.float32)
        arrays[f"s_rows/{l}"] = np.zeros(0, np.int32)
        arrays[f"s_cols/{l}"] = np.zeros(0, np.int32)
    data = ts.data_from_numpy(arrays, device="cpu")
    assert data.v_leaf is not data.u_leaf
    back = ts.data_to_numpy(data)
    assert set(arrays) < set(back)          # plus the plan built for it
    for key, a in arrays.items():
        np.testing.assert_array_equal(back[key], a)


def test_carry_across_builds_missing_plan(built):
    """Without the plan and the marshaled buffers, ``data_from_numpy``
    builds them from the block lists, identical to the reference's."""
    (_, rdata, _, _), _ = built
    arrays = jax_data_to_numpy(rdata)
    bare = {k: a for k, a in arrays.items()
            if not k.startswith(("plan/", "s_mar/", "dense_mar"))}
    assert len(bare) < len(arrays)
    back = ts.data_to_numpy(ts.data_from_numpy(bare, device="cpu"))
    assert sorted(back) == sorted(arrays)
    for key, a in arrays.items():
        assert back[key].dtype == a.dtype, key
        np.testing.assert_array_equal(back[key], a, err_msg=key)


def test_remarshal_matches_construction(built):
    _, (_, pdata, _, _) = built
    again = ts.remarshal(dataclasses.replace(pdata, s_mar=None,
                                             dense_mar=None))
    for a, b in zip(again.s_mar, pdata.s_mar):
        assert torch.equal(a, b)
    assert torch.equal(again.dense_mar, pdata.dense_mar)


def test_zeros_data_shapes(built):
    _, (pshape, pdata, _, _) = built
    z = ts.data_to_numpy(ts.zeros_data(pshape, device="cpu"))
    want = ts.data_to_numpy(pdata)
    assert set(z) == set(want) | {"v_leaf"} | {
        f"f/{l}" for l in range(pshape.depth + 1)}
    for key, a in want.items():
        assert z[key].shape == a.shape and z[key].dtype == a.dtype, key
        assert not z[key].any(), key


def test_dense_reference_matches():
    pts = regular_grid_points(8, 2)
    from repro.core.clustering import build_cluster_tree
    from repro.core.construction import dense_reference as ref_dense
    tree = build_cluster_tree(pts, 8)
    want = ref_dense(pts, ref_exp(0.1), tree.perm)
    got = tc.dense_reference(pts, exponential_kernel(0.1), tree.perm)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_sketch_method_not_ported():
    """The sketch method is ported now: ``method="sketch"`` builds (on the
    tree and block lists of the cheb path) and an unknown method raises."""
    pts = regular_grid_points(8, 2)
    shape, data, tree, bs = tc.construct_h2(
        pts, exponential_kernel(0.1), 8, 3, 0.9, method="sketch",
        device="cpu")
    cshape, _, ctree, cbs = tc.construct_h2(pts, exponential_kernel(0.1), 8,
                                            3, 0.9, device="cpu")
    assert (tree.perm == ctree.perm).all()
    assert shape.coupling_counts == cshape.coupling_counts
    assert data.u_leaf.shape[:2] == (shape.n_leaves, 8)
    with pytest.raises(ValueError, match="unknown construction method"):
        tc.construct_h2(pts, exponential_kernel(0.1), 8, 3, 0.9,
                        method="aca", device="cpu")


@pytest.mark.parametrize("p", [2, 4])
def test_degenerate_boxes_match(p):
    """Points on lines: leaf boxes with a zero-width dimension take the
    constant-weight branch on both sides."""
    pts = np.stack([np.repeat(np.linspace(0, 1, 4), 32),
                    np.tile(np.linspace(0, 1, 32), 4)], axis=-1)
    rshape, rdata, _, _ = ref_construct(pts, ref_exp(0.2), 8, p, 0.9)
    pshape, pdata, _, _ = tc.construct_h2(pts, exponential_kernel(0.2), 8, p,
                                          0.9, device="cpu")
    assert dataclasses.asdict(pshape) == dataclasses.asdict(rshape)
    _close(pdata.u_leaf, rdata.u_leaf)
    for l in range(rshape.depth + 1):
        _close(pdata.e[l], rdata.e[l])
        _close(pdata.s[l], rdata.s[l])
