"""PyTorch port: HGEMV against the JAX reference on the same operator.

The reference builds the operator; ``data_from_numpy`` carries it across
unchanged, so construction differences cannot hide here.  Both of the
port's backends (``"cuda"``, which takes the kernels' plain versions on CPU
tensors, and ``"torch"``) are held to ``repro``'s ``h2_matvec`` with
``backend="jnp"`` and ``"pallas"`` (interpret mode) at 1e-5 relative norm
error, for nv in {1, 16}, rank-0 levels and ``dense_count == 0``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.clustering import regular_grid_points
from repro.core.construction import construct_h2 as ref_construct
from repro.core.kernels_fn import exponential_kernel as ref_exp
from repro.core.matvec import h2_matvec as ref_matvec
from repro.core.matvec import h2_matvec_flops as ref_flops
from repro_torch.core import construction as tc
from repro_torch.core import matvec as tm
from repro_torch.core import structure as ts
from repro_torch.core.kernels_fn import exponential_kernel
from repro_torch.core.structure import H2Shape

from test_plan import _random_structure
from test_torch_structure import jax_data_to_numpy

torch.set_num_threads(2)


def _port_shape(shape) -> H2Shape:
    return H2Shape(**dataclasses.asdict(shape))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", params=[3, 5])
def operator(request):
    pts = regular_grid_points(16, 2)
    shape, data, tree, _ = ref_construct(pts, ref_exp(0.1), 8, request.param,
                                         0.9)
    port = ts.data_from_numpy(jax_data_to_numpy(data), device="cpu")
    return pts, tree, shape, data, _port_shape(shape), port


@pytest.mark.parametrize("nv", [1, 16])
@pytest.mark.parametrize("ref_backend", ["jnp", "pallas"])
def test_matvec_matches_reference(operator, nv, ref_backend):
    _, _, shape, data, pshape, pdata = operator
    x = np.random.default_rng(nv).standard_normal((shape.n, nv)
                                                  ).astype(np.float32)
    want = np.asarray(ref_matvec(shape, data, jnp.asarray(x),
                                 backend=ref_backend))
    for backend in ("cuda", "torch"):
        got = tm.h2_matvec(pshape, pdata, torch.as_tensor(x), backend=backend)
        assert got.shape == (shape.n, nv) and got.dtype == torch.float32
        assert _rel(got, want) <= 1e-5, backend


def test_matvec_against_dense_reference():
    """The exact dense product, at a size where the Chebyshev interpolation
    itself reaches 1e-4 (l = 0.5, p = 6: the reference's own error there is
    4.8e-5; at l = 0.1 it is 9e-4 on this 16x16 grid)."""
    pts = regular_grid_points(16, 2)
    pshape, pdata, tree, _ = tc.construct_h2(pts, exponential_kernel(0.5), 8,
                                             6, 0.9, device="cpu")
    a = tc.dense_reference(pts, exponential_kernel(0.5), tree.perm).numpy()
    x = np.random.default_rng(0).standard_normal((pshape.n, 4)
                                                 ).astype(np.float32)
    for backend in ("cuda", "torch"):
        y = tm.h2_matvec(pshape, pdata, torch.as_tensor(x), backend=backend)
        assert _rel(y, a @ x) <= 1e-4


def test_port_built_operator_matches_reference(operator):
    """The port's own construction gives the same product."""
    pts, _, shape, data, _, _ = operator
    p = round(shape.ranks[-1] ** 0.5)
    pshape, pdata, _, _ = tc.construct_h2(pts, exponential_kernel(0.1), 8, p,
                                          0.9, device="cpu")
    x = np.random.default_rng(1).standard_normal((shape.n, 3)
                                                 ).astype(np.float32)
    want = np.asarray(ref_matvec(shape, data, jnp.asarray(x)))
    got = tm.h2_matvec(pshape, pdata, torch.as_tensor(x))
    assert _rel(got, want) <= 1e-5


def _carried(rng, depth, leaf, rank0, with_dense):
    shape, legacy, planned = _random_structure(rng, depth, leaf, rank0,
                                               with_dense)
    return (shape, legacy, planned, _port_shape(shape),
            ts.data_from_numpy(jax_data_to_numpy(legacy), device="cpu"),
            ts.data_from_numpy(jax_data_to_numpy(planned), device="cpu"))


@pytest.mark.parametrize("nv", [1, 16])
@pytest.mark.parametrize("case", range(6))
def test_random_structures(nv, case):
    """tests/test_plan.py's random structures: rank-0 levels (odd cases),
    dense_count == 0 (cases 0 and 3), carried across in both of the
    reference's layouts: with its plan, and without one, where the port
    builds the same plan from the block lists."""
    rng = np.random.default_rng(1000 * case + nv)
    depth = int(rng.integers(2, 5))
    leaf = int(rng.choice([4, 8]))
    r0 = int(rng.integers(1, depth + 1)) if case % 2 else None
    shape, legacy, planned, pshape, plegacy, pplanned = _carried(
        rng, depth, leaf, r0, case % 3 != 0)
    assert legacy.plan is None and planned.plan is not None
    built, carried = ts.data_to_numpy(plegacy), ts.data_to_numpy(pplanned)
    for key, a in carried.items():
        if key.startswith(("plan/", "s_mar/", "dense_mar")):
            np.testing.assert_array_equal(built[key], a, err_msg=key)
    x = rng.standard_normal((shape.n, nv)).astype(np.float32)
    want = np.asarray(ref_matvec(shape, legacy, jnp.asarray(x)))
    for name, data in (("built plan", plegacy), ("carried plan", pplanned)):
        for backend in ("cuda", "torch"):
            got = tm.h2_matvec(pshape, data, torch.as_tensor(x),
                               backend=backend)
            assert _rel(got, want) <= 1e-5, (backend, name)


def test_rank0_level_and_no_dense_against_pallas():
    rng = np.random.default_rng(3)
    shape, _, planned, pshape, _, pplanned = _carried(rng, 3, 4, 2, False)
    assert shape.ranks[2] == 0 and shape.dense_count == 0
    x = rng.standard_normal((shape.n, 2)).astype(np.float32)
    want = np.asarray(ref_matvec(shape, planned, jnp.asarray(x),
                                 backend="pallas"))
    got = tm.h2_matvec(pshape, pplanned, torch.as_tensor(x))
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("nv", [1, 16])
def test_flops_model_matches(operator, nv):
    _, _, shape, _, pshape, _ = operator
    assert tm.h2_matvec_flops(pshape, nv) == ref_flops(shape, nv)


def test_phases_recorded(operator):
    from repro_torch.obs.trace import PHASES_SEEN, reset_span_totals
    _, _, shape, _, pshape, pdata = operator
    reset_span_totals()
    tm.h2_matvec(pshape, pdata, torch.zeros(shape.n, 1))
    assert {"hgemv/upsweep", "hgemv/coupling-gemm", "hgemv/downsweep",
            "hgemv/dense"} <= PHASES_SEEN


def test_unknown_backend_raises(operator):
    _, _, shape, _, pshape, pdata = operator
    with pytest.raises(ValueError, match="backend"):
        tm.h2_matvec(pshape, pdata, torch.zeros(shape.n, 1), backend="jnp")
