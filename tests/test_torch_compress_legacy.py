"""PyTorch port: the two-sweep tolerance compress (``pick_ranks_by_tol``,
``compress(legacy_two_sweep=True)``) against the JAX reference's, on the
cheb operators of tests/test_torch_compression.py (the 16x16 grid, leaf 8,
Chebyshev p in {4, 6}).

The rank probe picks the reference's ranks; the two-sweep compress gives
the reference's ranks and, on a random block of vectors, products within
1e-5 relative of the reference's two-sweep operator and of the port's own
fused single sweep (the same ranks, the same truncation).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import compression as rcp
from repro.core.clustering import regular_grid_points
from repro.core.construction import construct_h2 as ref_construct
from repro.core.kernels_fn import exponential_kernel as ref_exp
from repro.core.matvec import h2_matvec as ref_matvec
from repro_torch.core import compression as tcp
from repro_torch.core import matvec as tm
from repro_torch.core import structure as ts
from repro_torch.core.structure import H2Shape

from test_torch_structure import jax_data_to_numpy

torch.set_num_threads(2)
BACKENDS = ("cuda", "torch")
TOLS = (1e-2, 1e-3)


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


@pytest.fixture(scope="module")
def ref_legacy(operator):
    """The reference's two-sweep compress at each tolerance."""
    shape, data, _, _ = operator
    return {tol: rcp.compress(shape, data, tol=tol, legacy_two_sweep=True)
            for tol in TOLS}


@pytest.mark.parametrize("tol", TOLS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_pick_ranks_by_tol_matches_reference(operator, tol, backend):
    """Each package probes its own orthogonalized operator and weights
    (both trees apart, as the two-sweep schedule runs them)."""
    shape, data, pshape, pdata = operator
    rs, rd = rcp._orthogonalized(shape, data, "jnp", aliased=False)
    ru, rv = rcp.compression_weights(rs, rd, "jnp")
    want = rcp.pick_ranks_by_tol(rs, rd, ru, rv, tol)
    od = tcp.orthogonalize(pshape, tcp._unaliased(pdata), backend)
    os_ = ts.shape_of(od, pshape.leaf_size, pshape.symmetric)
    pu, pv = tcp.compression_weights(os_, od, backend)
    assert tcp.pick_ranks_by_tol(os_, od, pu, pv, tol, backend) == want


@pytest.mark.parametrize("tol", TOLS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_legacy_compress_matches_reference(operator, ref_legacy, x16, tol,
                                           backend):
    _, _, pshape, pdata = operator
    cs, cd = ref_legacy[tol]
    ps, pd = tcp.compress(pshape, pdata, tol=tol, backend=backend,
                          legacy_two_sweep=True)
    assert ps.ranks == cs.ranks
    want = np.asarray(ref_matvec(cs, cd, jnp.asarray(x16)))
    got = tm.h2_matvec(ps, pd, torch.as_tensor(x16), backend=backend)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("tol", TOLS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_legacy_compress_matches_the_fused_sweep(operator, x16, tol,
                                                 backend):
    _, _, pshape, pdata = operator
    ls, ld = tcp.compress(pshape, pdata, tol=tol, backend=backend,
                          legacy_two_sweep=True)
    fs, fd = tcp.compress(pshape, pdata, tol=tol, backend=backend)
    assert ls.ranks == fs.ranks
    x = torch.as_tensor(x16)
    assert _rel(tm.h2_matvec(ls, ld, x, backend=backend),
                tm.h2_matvec(fs, fd, x, backend=backend)) <= 1e-5


def test_legacy_compress_factors_both_trees(operator, monkeypatch):
    """No symmetry aliasing: every QR of the orthogonalization and the
    weights runs once per tree, and the result keeps two trees."""
    _, _, pshape, pdata = operator
    from repro_torch.kernels import ops
    calls = {"qr": 0, "qr_r": 0}
    real_qr, real_qr_r = ops.backend_qr, ops.backend_qr_r

    def qr(a, backend="cuda"):
        calls["qr"] += 1
        return real_qr(a, backend)

    def qr_r(a, backend="cuda"):
        calls["qr_r"] += 1
        return real_qr_r(a, backend)

    monkeypatch.setattr(ops, "backend_qr", qr)
    monkeypatch.setattr(ops, "backend_qr_r", qr_r)
    _, pd = tcp.compress(pshape, pdata, tol=1e-3, legacy_two_sweep=True)
    levels = pshape.depth + 1
    # on CPU tensors backend_qr_r takes backend_qr's R: counted in both
    assert calls["qr_r"] == 2 * pshape.depth
    assert calls["qr"] == 2 * levels + calls["qr_r"]
    assert pd.v_leaf is not pd.u_leaf
    # the column sweep stacks S by columns, the row sweep S^T by rows: the
    # same blocks in another order, so the trees agree to rounding
    assert _rel(pd.v_leaf, pd.u_leaf) <= 1e-4


def test_legacy_flag_leaves_target_ranks_alone(operator, x16):
    _, _, pshape, pdata = operator
    tgt = tuple(min(5, k) for k in pshape.ranks)
    s1, d1 = tcp.compress(pshape, pdata, target_ranks=tgt,
                          legacy_two_sweep=True)
    s2, d2 = tcp.compress(pshape, pdata, target_ranks=tgt)
    assert s1.ranks == s2.ranks
    x = torch.as_tensor(x16)
    assert torch.equal(tm.h2_matvec(s1, d1, x), tm.h2_matvec(s2, d2, x))
