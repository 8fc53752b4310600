"""The shape-based counts of work (``h2bench/work``) against a hand count
and against the port's ``h2_matvec_flops``; the roofline's guards."""
import numpy as np
import pytest
import torch

from h2bench import work


def tiny():
    # depth 2: 4 leaves of 8 points, ranks (2, 3, 4), blocks (0, 2, 6),
    # 10 dense blocks
    return work.OpShape(n=32, leaf=8, depth=2, ranks=(2, 3, 4),
                        counts=(0, 2, 6), dense_count=10)


def test_hgemv_counts_by_hand():
    sh, nv = tiny(), 5
    ph = work.hgemv_phases(sh, nv)
    # upsweep: V^T x (4 leaves, 8x4) + F^T at level 2 (4 nodes, 4x3) and
    # level 1 (2 nodes, 3x2)
    up_fl = 2 * 4 * 8 * 4 * nv + 2 * 4 * 4 * 3 * nv + 2 * 2 * 3 * 2 * nv
    up_by = 4 * (4 * 8 * 4 + 32 * nv + 4 * 4 * nv   # V, x, xhat_2
                 + 4 * 4 * 3 + 2 * 3 * nv            # F_2, xhat_1
                 + 2 * 3 * 2 + 1 * 2 * nv)           # F_1, xhat_0
    assert ph["hgemv/upsweep"] == work.Work(up_fl, up_by)
    cp_fl = 2 * 2 * 9 * nv + 2 * 6 * 16 * nv
    cp_by = 4 * (2 * 9 + 2 * 2 * 3 * nv + 6 * 16 + 2 * 4 * 4 * nv) \
        + 8 * (2 + 6)
    assert ph["hgemv/coupling-gemm"] == work.Work(cp_fl, cp_by)
    dn_fl = 2 * 2 * 3 * 2 * nv + 2 * 4 * 4 * 3 * nv + 2 * 4 * 8 * 4 * nv
    dn_by = 4 * (1 * 2 * nv                          # yhat_0
                 + 2 * 3 * 2 + 2 * 3 * nv            # E_1, yhat_1
                 + 4 * 4 * 3 + 4 * 4 * nv            # E_2, yhat_2
                 + 4 * 8 * 4 + 32 * nv)              # U, y
    assert ph["hgemv/downsweep"] == work.Work(dn_fl, dn_by)
    de = work.Work(2 * 10 * 64 * nv, 4 * (10 * 64 + 2 * 32 * nv) + 8 * 10)
    assert ph["hgemv/dense"] == de
    total = sum((w for w in ph.values()), work.ZERO)
    assert total.flops == work.hgemv_flops(sh, nv)
    call = work.hgemv_call(sh, nv)
    assert call.flops == total.flops
    assert call.bytes == 4 * (4 * 8 * 4 + 4 * 4 * 3 + 2 * 3 * 2 + 2 * 9
                              + 6 * 16 + 10 * 64 + 2 * 32 * nv) \
        + 8 * (8 + 10)
    assert call.bytes < total.bytes


@pytest.mark.parametrize("nv", [1, 16])
def test_hgemv_flops_match_the_port(nv):
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    from repro_torch.core.matvec import h2_matvec_flops
    shape, data, _, _ = construct_h2(regular_grid_points(64, 2),
                                     exponential_kernel(0.1), leaf_size=16,
                                     cheb_p=4, eta=0.9, device="cpu")
    sh = work.op_shape(data.u_leaf, data.e, data.s, data.dense,
                       symmetric=True)
    assert sh.ranks == shape.ranks and sh.counts == shape.coupling_counts
    assert sh.dense_count == shape.dense_count and sh.n == shape.n
    assert work.hgemv_flops(sh, nv) == h2_matvec_flops(shape, nv)


def test_factorization_counts():
    # Householder QR of a 6x4: 2*6*16 - 2*64/3 for R, the same for Q
    assert work.qr_flops(3, 6, 4) == pytest.approx(3 * 2 * (192 - 128 / 3))
    assert work.qr_flops(1, 6, 4, want_q=False) == pytest.approx(
        192 - 128 / 3)
    # sigma and U of a square n x n: min(14 n^3 - 2 n^3, 6 n^3 + 11 n^3)
    assert work.svd_flops(2, 5, 5, want_vt=False) == 2 * 12 * 125
    sh = tiny()
    o = work.orthogonalize_work(sh)
    assert o.flops == pytest.approx(
        work.qr_flops(4, 8, 4) + 2 * 4 * 4 * 4 * 3 + work.qr_flops(2, 8, 3)
        + 2 * 2 * 3 * 3 * 2 + work.qr_flops(1, 6, 2))
    t = work.truncate_work(sh, (1, 2, 2))
    assert t.flops > 0 and t.bytes > 0


def test_roofline_names_its_bound_and_refuses_over_one():
    w = work.Work(flops=67e12 * 1e-3, bytes=3.35e12 * 2e-3)
    share, by = work.roofline(w, 4e-3)
    assert by == "bytes" and share == pytest.approx(50.0)
    share, by = work.roofline(work.Work(67e12 * 1e-3, 1.0), 1e-3)
    assert by == "flops" and share == pytest.approx(100.0)
    with pytest.raises(work.RooflineError):
        work.roofline(w, 1e-3)
    with pytest.raises(work.RooflineError):
        work.roofline(w, 0.0)
    assert np.isfinite(work.PEAKS["power_limit_w"])


def test_counts_read_shapes_only():
    meta = dict(u_leaf=torch.empty((4, 8, 4), device="meta"),
                e=[torch.empty((0, 0, 0), device="meta"),
                   torch.empty((2, 3, 2), device="meta"),
                   torch.empty((4, 4, 3), device="meta")],
                s=[torch.empty((0, 2, 2), device="meta"),
                   torch.empty((2, 3, 3), device="meta"),
                   torch.empty((6, 4, 4), device="meta")],
                dense=torch.empty((10, 8, 8), device="meta"))
    assert work.op_shape(symmetric=True, **meta) == tiny()
