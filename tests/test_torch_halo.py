"""PyTorch port: the host halo plans and the send-row packing against the
JAX reference.

``partition_level``/``build_send_lists`` at p in {2, 4, 8} on the two
geometries of ``tests/dist_worker.py`` (uniform 2D, N = 1024, leaf 16,
Chebyshev 4; graded 1D ``((i+0.5)/n)^8``, leaf 8, Chebyshev 6): every int32
map equal, every value buffer bitwise equal (the port gathers them through
slot -> block maps; a copy changes no bit).  ``ops.halo_pack`` against the
Pallas kernel in interpret mode: exact (a gather).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import halo as th
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

MAP_FIELDS = ("sr", "sc", "pb", "pc", "comb_idx", "diag_blk", "diag_col",
              "bnd_rows", "rowpos", "off_blk", "off_idx", "blk_idx")
VALUE_FIELDS = ("sv", "sv_mar", "sv_mar_diag", "sv_mar_off")


@pytest.fixture(scope="module", params=["uniform2d", "graded1d"])
def geometry(request):
    """The reference operator's per-level block lists and values."""
    from repro.core.clustering import regular_grid_points
    from repro.core.construction import construct_h2
    from repro.core.kernels_fn import exponential_kernel
    if request.param == "uniform2d":
        shape, data, _, _ = construct_h2(regular_grid_points(32, 2),
                                         exponential_kernel(0.1), 16, 4, 0.9)
    else:
        n = 1024
        pts = (((np.arange(n) + 0.5) / n) ** 8)[:, None]
        shape, data, _, _ = construct_h2(pts, exponential_kernel(0.2), 8, 6,
                                         0.9)
    levels = [(np.asarray(data.s_rows[l]), np.asarray(data.s_cols[l]),
               np.asarray(data.s[l]), l) for l in range(shape.depth + 1)]
    levels.append((np.asarray(data.d_rows), np.asarray(data.d_cols),
                   np.asarray(data.dense), shape.depth))
    return shape, levels


@pytest.mark.parametrize("p", [2, 4, 8])
def test_partition_level_matches_reference(geometry, p):
    from repro.core import halo as rh
    shape, levels = geometry
    lc = int(np.log2(p))
    n_off = 0
    for rows, cols, vals, l in levels:
        if l < lc:
            continue
        want = rh.partition_level(rows, cols, vals, p, l - lc)
        got = th.partition_level(rows, cols, torch.as_tensor(vals), p,
                                 l - lc)
        assert (got.nbmax, got.rad, got.offsets, got.caps) == \
            (want.nbmax, want.rad, want.offsets, want.caps)
        for f in MAP_FIELDS:
            a, b = getattr(want, f), getattr(got, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (l, f)
        assert len(got.send) == len(want.send)
        for a, b in zip(want.send, got.send):
            assert a.dtype == b.dtype and np.array_equal(a, b), l
        for f in VALUE_FIELDS:
            a, b = getattr(want, f), getattr(got, f).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (l, f)
            assert np.array_equal(a, b), (l, f)
        plan = got.plan("cpu")
        assert all(t.dtype == torch.int32 for t in plan.send)
        n_off += len(got.offsets)
    assert n_off > 0                      # the levels do exchange


@pytest.mark.parametrize("p", [2, 4, 8])
def test_build_send_lists_matches_reference(geometry, p):
    from repro.core import halo as rh
    shape, levels = geometry
    lc = int(np.log2(p))
    for rows, cols, _, l in levels:
        if l < lc:
            continue
        want = rh.build_send_lists(rows, cols, p, l - lc)
        got = th.build_send_lists(rows, cols, p, l - lc)
        assert got[:2] == want[:2]
        for a, b in zip(want[2], got[2]):
            assert np.array_equal(a, b)
        assert np.array_equal(np.asarray(want[3], np.int64), got[3])


def test_partition_level_of_an_empty_level():
    """A level without blocks: one padding slot per rank, no exchange."""
    from repro.core import halo as rh
    e = np.zeros(0, np.int32)
    vals = np.zeros((0, 3, 3), np.float32)
    want = rh.partition_level(e, e, vals, 4, 2)
    got = th.partition_level(e, e, torch.as_tensor(vals), 4, 2)
    assert got.offsets == want.offsets == ()
    for f in MAP_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in VALUE_FIELDS:
        assert getattr(got, f).shape == getattr(want, f).shape, f
        assert not getattr(got, f).any()


@pytest.mark.parametrize("n,k,nv,cap", [(40, 6, 4, 13), (16, 36, 16, 9),
                                        (9, 7, 1, 5), (12, 5, 3, 0)])
def test_halo_pack_matches_pallas(n, k, nv, cap):
    """The plain version against the Pallas kernel (interpret mode), with
    padding entries repeating row 0, nv = 1, and odd row lengths.  The
    Pallas kernel refuses cap = 0 (its callers' caps are >= 1), so that
    case is held to the empty ``[0, k, nv]`` result."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(n * k + nv + cap)
    x = rng.standard_normal((n, k, nv)).astype(np.float32)
    idx = rng.integers(0, n, cap).astype(np.int32)
    idx[cap // 2:] = 0
    want = np.asarray(jops.halo_pack(jnp.asarray(x), jnp.asarray(idx))) \
        if cap else np.zeros((0, k, nv), np.float32)
    before = ops.launch_counts()
    for backend in ops.BACKENDS:
        got = ops.halo_pack(torch.as_tensor(x), torch.as_tensor(idx),
                            backend)
        assert got.shape == (cap, k, nv) and np.array_equal(got, want)
    assert ops.launch_counts() == before        # no kernel on the CPU


def test_halo_pack_into_a_slice():
    """``out=`` writes the packed rows into a slice of a flat send buffer
    and leaves the rest of the buffer alone."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((20, 3, 2)).astype(np.float32))
    idx = torch.tensor([4, 0, 19, 4, 0], dtype=torch.int32)
    flat = torch.full((5 * 6 + 10,), -1.0)
    out = flat[7:7 + 30].view(5, 3, 2)
    got = ops.halo_pack(x, idx, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, ref.halo_pack(x, idx))
    assert (flat[:7] == -1).all() and (flat[37:] == -1).all()
