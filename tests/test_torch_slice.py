"""PyTorch port: the whole slice against the JAX reference, and the port's
independence from JAX.

``construct_h2 -> h2_matvec -> compress(tol=1e-3) -> h2_matvec`` runs in
each package on the same points; products agree within 1e-5 (uncompressed)
and 1e-4 (compressed) relative, and the picked ranks are equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.clustering import regular_grid_points
from repro.core.compression import compress as ref_compress
from repro.core.construction import construct_h2 as ref_construct
from repro.core.kernels_fn import exponential_kernel as ref_exp
from repro.core.matvec import h2_matvec as ref_matvec
from repro_torch.core.clustering import regular_grid_points as port_grid
from repro_torch.core.compression import compress
from repro_torch.core.construction import construct_h2
from repro_torch.core.kernels_fn import exponential_kernel
from repro_torch.core.matvec import h2_matvec

torch.set_num_threads(2)
SRC = Path(__file__).resolve().parents[1] / "src"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("side,leaf,p", [(16, 8, 6), (32, 16, 6),
                                         (32, 8, 4)])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_slice_matches_reference(side, leaf, p, backend):
    pts = regular_grid_points(side, 2)
    np.testing.assert_array_equal(port_grid(side, 2), pts)
    x = np.random.default_rng(side + p).standard_normal(
        (side * side, 16)).astype(np.float32)

    rshape, rdata, _, _ = ref_construct(pts, ref_exp(0.1), leaf, p, 0.9)
    ry = np.asarray(ref_matvec(rshape, rdata, jnp.asarray(x)))
    rcs, rcd = ref_compress(rshape, rdata, tol=1e-3)
    ryc = np.asarray(ref_matvec(rcs, rcd, jnp.asarray(x)))

    shape, data, _, _ = construct_h2(pts, exponential_kernel(0.1), leaf, p,
                                     0.9, device="cpu")
    assert dataclasses.asdict(shape) == dataclasses.asdict(rshape)
    y = h2_matvec(shape, data, torch.as_tensor(x), backend=backend)
    assert _rel(y, ry) <= 1e-5
    cs, cd = compress(shape, data, tol=1e-3, backend=backend)
    assert cs.ranks == rcs.ranks
    assert cs.memory_lowrank() == rcs.memory_lowrank()
    yc = h2_matvec(cs, cd, torch.as_tensor(x), backend=backend)
    assert torch.isfinite(yc).all()
    assert _rel(yc, ryc) <= 1e-4
    # the compressed operator stays close to the uncompressed one, as the
    # reference's does
    assert abs(_rel(yc, y) - _rel(ryc, ry)) <= 1e-4


def test_entry_points_default_to_the_card():
    """Every entry point defaults to device="cuda" / backend="cuda"."""
    import inspect
    from repro_torch.core import compression, construction, dist, matvec
    from repro_torch.core import orthogonalize
    for fn in (construction.construct_h2, dist.partition_h2):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (matvec.h2_matvec, orthogonalize.orthogonalize,
               compression.compress, dist.make_dist_matvec,
               dist.make_dist_compress):
        assert inspect.signature(fn).parameters["backend"].default == "cuda"
    from repro_torch.apps import fractional
    from repro_torch.solvers import mg
    for fn in (fractional.solve, fractional.make_preconditioner,
               mg.build_grid_mg):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (fractional.solve, fractional.make_operator):
        assert inspect.signature(fn).parameters["backend"].default == "cuda"
    prob = fractional.FractionalProblem(8)
    assert prob.device == "cuda" and prob.backend == "cuda"


def test_port_imports_neither_jax_nor_repro():
    """Import repro_torch and every module under it in a fresh interpreter:
    neither jax nor repro may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 25, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
