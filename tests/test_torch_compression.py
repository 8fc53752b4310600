"""PyTorch port: orthogonalization and recompression against the JAX
reference on the same (carried-across) operator.

``compress(tol)`` must pick the same ranks as ``repro``; the compressed
products agree within 1e-4 relative; the reconstruction error stays under
50 * tol (tests/test_compression.py:59); orthogonalization leaves the
product unchanged within 2e-3 (tests/test_compression.py:48).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.clustering import regular_grid_points
from repro.core.compression import compress as ref_compress
from repro.core.construction import construct_h2 as ref_construct
from repro.core.kernels_fn import exponential_kernel as ref_exp
from repro.core.matvec import h2_matvec as ref_matvec
from repro_torch.core import compression as tcp
from repro_torch.core import matvec as tm
from repro_torch.core import orthogonalize as tor
from repro_torch.core import structure as ts
from repro_torch.core.reconstruct import check_orthogonal, reconstruct_dense
from repro_torch.core.structure import H2Shape
from repro_torch.kernels import ops

from test_torch_structure import jax_data_to_numpy

torch.set_num_threads(2)
BACKENDS = ("cuda", "torch")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", params=[4, 6])
def operator(request):
    pts = regular_grid_points(16, 2)
    shape, data, _, _ = ref_construct(pts, ref_exp(0.1), 8, request.param,
                                      0.9)
    pdata = ts.data_from_numpy(jax_data_to_numpy(data), device="cpu")
    return shape, data, H2Shape(**dataclasses.asdict(shape)), pdata


@pytest.fixture(scope="module")
def x16():
    return np.random.default_rng(1).standard_normal((256, 3)
                                                    ).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
def test_orthogonalize(operator, x16, backend):
    _, _, pshape, pdata = operator
    od = tor.orthogonalize(pshape, pdata, backend)
    oshape = ts.shape_of(od, pshape.leaf_size)
    assert check_orthogonal(oshape, od) < 1e-4
    assert od.v_leaf is od.u_leaf
    assert all(f is e for f, e in zip(od.f, od.e))
    x = torch.as_tensor(x16)
    y0 = tm.h2_matvec(pshape, pdata, x, backend=backend).numpy()
    y1 = tm.h2_matvec(oshape, od, x, backend=backend).numpy()
    np.testing.assert_allclose(y1, y0, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("aliased", [True, False])
def test_orthogonalize_factors_one_tree_when_symmetric(operator,
                                                       monkeypatch, aliased):
    _, _, pshape, pdata = operator
    if not aliased:
        pdata = dataclasses.replace(pdata, v_leaf=pdata.u_leaf.clone(),
                                    f=[t.clone() for t in pdata.e])
    calls = []
    real = ops.backend_qr

    def counting(a, backend="cuda"):
        calls.append(tuple(a.shape))
        return real(a, backend)

    monkeypatch.setattr(ops, "backend_qr", counting)
    tor.orthogonalize(pshape, pdata)
    one_tree = pshape.depth + 1
    assert len(calls) == (one_tree if aliased else 2 * one_tree)


@pytest.mark.parametrize("tol", [1e-2, 1e-3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_compress_tol_matches_reference(operator, x16, tol, backend):
    shape, data, pshape, pdata = operator
    cs, cd = ref_compress(shape, data, tol=tol)
    ps, pd = tcp.compress(pshape, pdata, tol=tol, backend=backend)
    assert ps.ranks == cs.ranks
    assert dataclasses.asdict(ps) == dataclasses.asdict(cs)
    assert pd.v_leaf is pd.u_leaf
    want = np.asarray(ref_matvec(cs, cd, jnp.asarray(x16)))
    got = tm.h2_matvec(ps, pd, torch.as_tensor(x16), backend=backend)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("tol", [1e-2, 1e-3])
def test_compress_reconstruction_error(operator, tol):
    _, _, pshape, pdata = operator
    a0 = reconstruct_dense(pshape, pdata)
    ps, pd = tcp.compress(pshape, pdata, tol=tol)
    a1 = reconstruct_dense(ps, pd)
    assert np.linalg.norm(a1 - a0) / np.linalg.norm(a0) < 50 * tol
    assert ps.memory_lowrank() < pshape.memory_lowrank()


@pytest.mark.parametrize("backend", BACKENDS)
def test_compress_target_ranks_matches_reference(operator, x16, backend):
    shape, data, pshape, pdata = operator
    tgt = tuple(min(5, k) for k in shape.ranks)
    cs, cd = ref_compress(shape, data, target_ranks=tgt)
    ps, pd = tcp.compress(pshape, pdata, target_ranks=tgt, backend=backend)
    assert ps.ranks == cs.ranks
    want = np.asarray(ref_matvec(cs, cd, jnp.asarray(x16)))
    got = tm.h2_matvec(ps, pd, torch.as_tensor(x16), backend=backend)
    assert _rel(got, want) <= 1e-4


def test_compress_assume_orthogonal(operator, x16):
    _, _, pshape, pdata = operator
    od = tor.orthogonalize(pshape, pdata)
    oshape = dataclasses.replace(ts.shape_of(od, pshape.leaf_size),
                                 row_maxb=pshape.row_maxb,
                                 col_maxb=pshape.col_maxb)
    s1, d1 = tcp.compress(oshape, od, tol=1e-3, assume_orthogonal=True)
    s2, d2 = tcp.compress(pshape, pdata, tol=1e-3)
    assert s1.ranks == s2.ranks
    x = torch.as_tensor(x16)
    assert _rel(tm.h2_matvec(s1, d1, x), tm.h2_matvec(s2, d2, x)) <= 1e-5


def test_weights_shapes_and_symmetric_sweep(operator):
    _, _, pshape, pdata = operator
    od = tor.orthogonalize(pshape, pdata)
    oshape = ts.shape_of(od, pshape.leaf_size)
    ru, rv = tcp.compression_weights(oshape, od, aliased=True)
    assert rv is ru
    _, rv2 = tcp.compression_weights(oshape, od, aliased=False)
    for l in range(oshape.depth + 1):
        assert ru[l].shape == (oshape.nodes(l), oshape.ranks[l],
                               oshape.ranks[l])
        # S is symmetric block for block, so both sweeps factor the same
        # stacks: R^T R (free of the QR's arbitrary trailing rows) agrees
        gu = ru[l].transpose(-1, -2) @ ru[l]
        gv = rv2[l].transpose(-1, -2) @ rv2[l]
        assert _rel(gv, gu) <= 1e-4


def test_compress_needs_tol_or_ranks(operator):
    _, _, pshape, pdata = operator
    with pytest.raises(ValueError, match="tol or target_ranks"):
        tcp.compress(pshape, pdata)
