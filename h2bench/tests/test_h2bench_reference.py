"""The plain reference (``h2bench/reference``) against dense products at a
small size, and its import graph."""
import json
import subprocess
import sys

import torch

from _small import GRID, ROOT
from h2bench.cells import kernel_operator
from h2bench.reference import h2ops, rows


def test_kernel_rows_equal_the_dense_product():
    cfg = {"points": dict(GRID, side=24),
           "kernel": {"name": "exponential", "length": 0.1}}
    p = torch.as_tensor(kernel_operator.points(cfg), dtype=torch.float64)
    assert p.shape == (576, 2) and float(p.max()) == 1.0
    k = kernel_operator.reference_kernel(cfg)
    dense = torch.exp(-torch.cdist(p, p) / 0.1)
    x = torch.randn(p.shape[0], 3, dtype=torch.float64)
    r = torch.tensor([0, 5, 77, 300, 575])
    got = rows.kernel_rows(p, k, r, x, chunk=2)
    assert torch.allclose(got, (dense @ x)[r], rtol=1e-12, atol=1e-12)
    low = rows.kernel_rows_low(p, k, r, x)
    assert torch.allclose(low, got, rtol=1e-5, atol=1e-5)


def test_h2_apply_equals_the_dense_operator_from_its_arrays():
    # a random H² operator on 4 leaves of 4 points; its dense matrix built
    # from explicit nested bases
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa
    u = rnd(4, 4, 3)
    e = [torch.zeros(0, 0, 0, dtype=torch.float64), rnd(2, 2, 2),
         rnd(4, 3, 2)]
    s = [torch.zeros(0, 2, 2, dtype=torch.float64), rnd(2, 2, 2),
         rnd(4, 3, 3)]
    s_rows = [torch.zeros(0, dtype=torch.int32), torch.tensor([0, 1]),
              torch.tensor([0, 1, 2, 3])]
    s_cols = [torch.zeros(0, dtype=torch.int32), torch.tensor([1, 0]),
              torch.tensor([2, 3, 0, 1])]
    dense = rnd(4, 4, 4)
    d_rows = torch.tensor([0, 1, 2, 3])
    d_cols = torch.tensor([0, 1, 2, 3])
    # explicit bases: level 2 the leaf bases, level 1 the children's
    # bases times their transfers, stacked
    b2 = [u[i] for i in range(4)]
    a = torch.zeros(16, 16, dtype=torch.float64)
    for i in range(4):
        a[4 * i:4 * i + 4, 4 * i:4 * i + 4] += dense[i]
    for bi in range(4):
        r, c = int(s_rows[2][bi]), int(s_cols[2][bi])
        a[4 * r:4 * r + 4, 4 * c:4 * c + 4] += b2[r] @ s[2][bi] @ b2[c].T
    w = [torch.cat([b2[2 * t] @ e[2][2 * t],
                    b2[2 * t + 1] @ e[2][2 * t + 1]]) for t in range(2)]
    for bi in range(2):
        r, c = int(s_rows[1][bi]), int(s_cols[1][bi])
        a[8 * r:8 * r + 8, 8 * c:8 * c + 8] += w[r] @ s[1][bi] @ w[c].T
    x = rnd(16, 2)
    y = h2ops.h2_apply(u, e, s, s_rows, s_cols, dense, d_rows, d_cols, x,
                       chunk=8)
    assert torch.allclose(y, a @ x, rtol=1e-12, atol=1e-12)


def test_basis_defect():
    q, _ = torch.linalg.qr(torch.randn(4, 6, 3, dtype=torch.float64))
    t, _ = torch.linalg.qr(torch.randn(2, 6, 3, dtype=torch.float64))
    e = [torch.zeros(0, 0, 0), t.reshape(4, 3, 3)]
    assert h2ops.basis_defect(q, e) < 1e-12
    assert h2ops.basis_defect(2 * q, e) > 1.0


def test_reference_imports_nothing_of_jax_or_the_port():
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "import h2bench.reference.rows, h2bench.reference.h2ops,"
        " h2bench.work, glob, runpy;"
        "[runpy.run_path(f) for d in ('reference/kernels', 'points')"
        " for f in glob.glob(sys.argv[1] + '/h2bench/' + d + '/*.py')];"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    assert "torch" in tops and "h2bench" in tops
