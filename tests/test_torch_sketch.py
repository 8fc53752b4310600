"""PyTorch port: the sketch construction (``repro_torch.sketch``) against
the JAX reference (``repro.sketch``, ``backend="jnp"``) on the CPU.

The port's Gaussians come from its own counter-based RNG (Philox 4x32-10
and Box-Muller from exactly rounded float64 operations), not from
``jax.random``; so the construction is held to the reference two ways:

- bitwise inputs: with the reference's Gaussians injected (the port's
  ``rng.level_gaussians`` replaced by the reference's draws), the ranks
  and the sample budget equal the reference's and the two operators'
  products agree within 1e-4;
- statistically: with its own RNG the port's operator is within 1e-3 of
  the dense kernel matrix (the reference's own acceptance at tol 1e-4).

The RNG's own properties are held in tests/test_torch_sketch_rng.py (no
JAX there, so its card test collects on a machine without it).  The
primitives take the same seeded numpy inputs as the reference's:
kernel-block products within 1e-5 relative; the rangefinder's sigma within
1e-5 and its projectors ``U U^T`` within 1e-4 (its bases equal the
reference's only up to column signs: wide R factors go through the R
factor of their transpose, ROADMAP Queue 3).  The black box rebuilds an
operator within 1e-4 and ``B B`` within 5e-3, the reference's bounds.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.clustering import regular_grid_points
from repro.core.kernels_fn import exponential_kernel as ref_exp
from repro.core.matvec import h2_matvec as ref_matvec
from repro.sketch import blackbox as rbb
from repro.sketch import construct as rcon
from repro.sketch import rangefinder as rrf
from repro.sketch import rng as rrng
from repro.sketch import sample as rsm
from repro_torch.core import construction as tc
from repro_torch.core.admissibility import build_block_structure
from repro_torch.core.clustering import build_cluster_tree
from repro_torch.core.kernels_fn import (exponential_kernel,
                                         fractional_kernel_2d)
from repro_torch.core.matvec import h2_matvec
from repro_torch.core.reconstruct import check_orthogonal
from repro_torch.core.structure import build_coupling_plan
from repro_torch.sketch import blackbox as tbb
from repro_torch.sketch import construct as tcon
from repro_torch.sketch import rangefinder as trf
from repro_torch.sketch import rng as trng
from repro_torch.sketch import sample as tsm

torch.set_num_threads(2)

KERN = exponential_kernel(0.1)
KERN_J = ref_exp(0.1, xp=jnp)
OPTS = dict(tol=1e-4, max_rank=48, seed=0)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _np(t):
    return np.asarray(t)


def _level_setup(side=16, leaf=16, level=None, r=8, seed=0):
    """One level of the 2D grid: points per node, block lists, plan and
    seeded numpy test matrices."""
    pts = regular_grid_points(side, 2)
    tree = build_cluster_tree(pts, leaf)
    bs = build_block_structure(tree, 0.9)
    l = tree.depth if level is None else level
    nn, w = 1 << l, tree.n >> l
    pts_lvl = tree.points.astype(np.float32).reshape(nn, w, 2)
    om = np.random.default_rng(seed).standard_normal(
        (nn, w, r)).astype(np.float32)
    plan = build_coupling_plan(tree.depth, bs.s_rows, bs.s_cols, bs.d_rows,
                               bs.d_cols)
    return tree, bs, l, pts_lvl, om, plan


def _inject_reference_gaussians(mp, record=None):
    """Replace the port's draws by the reference's (numpy in between);
    ``record`` collects the budgets both packages draw."""
    real = rrng.level_gaussians

    def ref_draw(seed, level, n_nodes, rows, cols, dtype=jnp.float32):
        if record is not None:
            record["ref"].append(cols)
        return real(seed, level, n_nodes, rows, cols, dtype)

    def port_draw(seed, level, n_nodes, rows, cols, dtype=torch.float32,
                  device="cpu"):
        if record is not None:
            record["port"].append(cols)
        g = np.array(real(seed, level, n_nodes, rows, cols))
        return torch.as_tensor(g, device=device).to(dtype)

    mp.setattr(rrng, "level_gaussians", ref_draw)
    mp.setattr(trng, "level_gaussians", port_draw)


# ---------------------------------------------------------------------------
# sample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 64, 256])
def test_apply_kernel_blocks_matches_reference(chunk):
    rng = np.random.default_rng(1)
    xt = rng.uniform(0, 1, (5, 32, 2)).astype(np.float32)
    xs = rng.uniform(0, 1, (5, 32, 2)).astype(np.float32)
    b = rng.standard_normal((5, 32, 6)).astype(np.float32)
    want = rsm.apply_kernel_blocks(jnp.asarray(xt), jnp.asarray(xs),
                                   jnp.asarray(b), kernel=KERN_J, chunk=chunk)
    got = tsm.apply_kernel_blocks(torch.as_tensor(xt), torch.as_tensor(xs),
                                  torch.as_tensor(b), kernel=KERN,
                                  chunk=chunk)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("with_plan", [True, False])
@pytest.mark.parametrize("level", [2, 4])
def test_sample_block_rows_matches_reference(with_plan, level):
    tree, bs, l, pts_lvl, om, plan = _level_setup(level=level, r=8)
    sr, sc = bs.s_rows[l].astype(np.int32), bs.s_cols[l].astype(np.int32)
    ref_plan = None
    if with_plan:
        from repro.core.structure import build_coupling_plan as ref_plan_fn
        ref_plan = ref_plan_fn(tree.depth, bs.s_rows, bs.s_cols, bs.d_rows,
                               bs.d_cols).sblk[l]
    want = rsm.sample_block_rows(jnp.asarray(pts_lvl), jnp.asarray(sr),
                                 jnp.asarray(sc), jnp.asarray(om), ref_plan,
                                 kernel=KERN_J, chunk=64)
    got = tsm.sample_block_rows(torch.as_tensor(pts_lvl),
                                torch.as_tensor(sr), torch.as_tensor(sc),
                                torch.as_tensor(om),
                                plan.sblk[l] if with_plan else None,
                                kernel=KERN, chunk=64)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def test_block_chunking_does_not_move_results(monkeypatch):
    """Chunking over blocks (the byte budget) leaves each block's sum and
    its chunk order alone."""
    tree, bs, l, pts_lvl, om, plan = _level_setup(level=4, r=8)
    args = (torch.as_tensor(pts_lvl), torch.as_tensor(bs.s_rows[l]),
            torch.as_tensor(bs.s_cols[l]), torch.as_tensor(om),
            plan.sblk[l])
    whole = tsm.sample_block_rows(*args, kernel=KERN, chunk=8)
    monkeypatch.setattr(tsm, "BLOCK_BYTES", 16 * 8 * 4 * 3)   # 3 blocks
    parts = tsm.sample_block_rows(*args, kernel=KERN, chunk=8)
    assert _rel(parts, whole) <= 1e-6


def test_eval_dense_blocks_matches_reference(monkeypatch):
    tree, bs, _, _, _, _ = _level_setup()
    pts_leaf = tree.points.astype(np.float32).reshape(1 << tree.depth, 16, 2)
    dr, dc = bs.d_rows.astype(np.int32), bs.d_cols.astype(np.int32)
    kern = fractional_kernel_2d(0.75)
    from repro.core.kernels_fn import fractional_kernel_2d as ref_frac
    want = rsm.eval_dense_blocks(jnp.asarray(pts_leaf), jnp.asarray(dr),
                                 jnp.asarray(dc),
                                 kernel=ref_frac(0.75, xp=jnp))
    monkeypatch.setattr(tsm, "BLOCK_BYTES", 16 * 16 * 4 * 5)
    got = tsm.eval_dense_blocks(torch.as_tensor(pts_leaf),
                                torch.as_tensor(dr), torch.as_tensor(dc),
                                kernel=kern)
    assert _rel(got, want) <= 1e-5


def test_project_coupling_blocks_matches_reference():
    tree, bs, l, pts_lvl, _, _ = _level_setup(level=3)
    rng = np.random.default_rng(2)
    nn, w = pts_lvl.shape[:2]
    u = np.linalg.qr(rng.standard_normal((nn, w, 5)))[0].astype(np.float32)
    v = np.linalg.qr(rng.standard_normal((nn, w, 5)))[0].astype(np.float32)
    sr, sc = bs.s_rows[l].astype(np.int32), bs.s_cols[l].astype(np.int32)
    want = rsm.project_coupling_blocks(
        jnp.asarray(pts_lvl), jnp.asarray(sr), jnp.asarray(sc),
        jnp.asarray(u), jnp.asarray(v), kernel=KERN_J, chunk=32)
    got = tsm.project_coupling_blocks(
        torch.as_tensor(pts_lvl), torch.as_tensor(sr), torch.as_tensor(sc),
        torch.as_tensor(u), torch.as_tensor(v), kernel=KERN, chunk=32)
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# rangefinder
# ---------------------------------------------------------------------------

def _projector(u):
    u = np.asarray(u, np.float64)
    return np.einsum("nik,njk->nij", u, u)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("shape", [(8, 32, 12), (8, 16, 40), (4, 20, 20),
                                   (16, 64, 300)])
def test_orthonormal_basis_matches_reference(shape, backend):
    """Tall, wide (the composition through the R factor of r^T), square,
    and a leaf-like [., 64, 300] stack; graded spectra so the leading
    subspaces are well separated."""
    rng = np.random.default_rng(3)
    nn, rows, cols = shape
    p = min(rows, cols)
    a = rng.standard_normal((nn, rows, p)) * np.logspace(0, -3, p)
    b = (a @ rng.standard_normal((nn, p, cols))).astype(np.float32)
    basis_r, s_r = rrf.orthonormal_basis(jnp.asarray(b))
    basis, s = trf.orthonormal_basis(torch.as_tensor(b), backend)
    assert basis.shape == basis_r.shape and s.shape == s_r.shape
    assert _rel(s, s_r) <= 1e-5
    k = p // 2                       # a subspace split at a wide gap
    assert np.abs(_projector(basis[..., :k]) -
                  _projector(_np(basis_r)[..., :k])).max() <= 1e-4
    gram = basis.transpose(-1, -2) @ basis
    assert float((gram - torch.eye(p)).abs().max()) <= 1e-4


def test_wide_r_goes_through_the_transposed_r_factor(monkeypatch):
    """A wide R factor is reduced by an R-only QR of its transpose before
    its SVD, on the plain path too: every SVD is square."""
    from repro_torch.kernels import ops
    seen = []
    real = ops.backend_svd

    def rec(a, backend="cuda", **kw):
        seen.append(tuple(a.shape))
        return real(a, backend, **kw)

    monkeypatch.setattr(ops, "backend_svd", rec)
    b = torch.randn(4, 16, 40, generator=torch.Generator().manual_seed(0))
    trf.orthonormal_basis(b, "torch")
    assert seen == [(4, 16, 16)]


def test_sketch_spectrum_and_pick_rank_match_reference():
    rng = np.random.default_rng(4)
    y = (rng.standard_normal((6, 64, 10)) @ np.diag(np.logspace(0, -6, 10))
         @ rng.standard_normal((6, 10, 14))).astype(np.float32)
    s_r = rrf.sketch_spectrum(jnp.asarray(y))
    s = trf.sketch_spectrum(torch.as_tensor(y), "torch")
    s2 = trf.sketch_spectrum(torch.as_tensor(y), "cuda")
    top = float(s_r.max())
    assert np.abs(_np(s) - _np(s_r)).max() <= 1e-5 * top
    assert torch.equal(s, s2)
    for tol in (1e-2, 1e-4):
        assert trf.pick_rank(s, tol * top, 12) == \
            rrf.pick_rank(s_r, tol * top, 12)
    assert trf.pick_rank(s, 10 * top, 12) == 1


@pytest.fixture(scope="module")
def ref_sketches():
    """The reference's sketches of the 32x32 grid (leaf 16) at a budget of
    20, and the same arrays as torch tensors."""
    pts = regular_grid_points(32, 2)
    tree = build_cluster_tree(pts, 16)
    bs = build_block_structure(tree, 0.9)
    p = jnp.asarray(tree.points, jnp.float32)
    out = []
    for l in range(tree.depth + 1):
        if not bs.s_rows[l].size:
            out.append(None)
            continue
        nn, w = 1 << l, tree.n >> l
        om = rrng.level_gaussians(0, l, nn, w, 20)
        out.append(rsm.sample_block_rows(
            p.reshape(nn, w, -1), jnp.asarray(bs.s_rows[l], jnp.int32),
            jnp.asarray(bs.s_cols[l], jnp.int32), om, kernel=KERN_J,
            chunk=64))
    return out, [None if y is None else torch.tensor(_np(y))
                 for y in out]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_build_nested_bases_matches_reference(ref_sketches, backend):
    """Equal ranks and the same spans: the leading half of each level's
    explicit basis to 1e-4 in its projector, the whole basis to a largest
    principal angle under 0.045 rad (cos > 0.999).  The trailing columns
    carry singular values near ``tol * scale``, which float32 resolves to
    ~1e-2 only (both packages; their projectors differ by up to 1e-2)."""
    ref_in, port_in = ref_sketches
    u_r, e_r, ranks_r = rrf.build_nested_bases(ref_in, 16, 1e-4, 48)
    u, e, ranks = trf.build_nested_bases(port_in, 16, 1e-4, 48, backend)
    assert ranks == ranks_r
    exp_r = rrf.explicit_bases(u_r, e_r)
    exp = trf.explicit_bases(u, e)
    for l in range(len(e)):
        assert exp[l].shape == exp_r[l].shape
        if ranks[l]:
            a = exp[l].double().numpy()
            b = np.asarray(exp_r[l], np.float64)
            h = (ranks[l] + 1) // 2
            assert np.abs(_projector(a[..., :h]) -
                          _projector(b[..., :h])).max() <= 1e-4
            cos = np.linalg.svd(np.einsum("nwk,nwj->nkj", a, b),
                                compute_uv=False)
            assert cos.min() > 0.999


def test_build_nested_bases_needs_a_coupling_level():
    with pytest.raises(ValueError, match="no coupling levels"):
        trf.build_nested_bases([None, None], 4, 1e-4, 8)


# ---------------------------------------------------------------------------
# construct
# ---------------------------------------------------------------------------

def _doubling_sample_fn(calls, xp):
    def sample_fn(r):
        calls.append(r)
        nn, w = 2, 32
        rng = np.random.default_rng(0)
        u = np.linalg.qr(rng.standard_normal((w, w)))[0]
        sv = np.concatenate([np.ones(20), np.full(w - 20, 1e-9)])
        a = (u * sv) @ np.linalg.qr(rng.standard_normal((w, w)))[0].T
        om = rng.standard_normal((nn, w, r))
        return [xp((a @ om).astype(np.float32))]
    return sample_fn


def test_adaptive_sketches_doubles_like_the_reference():
    """Flat spectrum until 20 samples can see the decay: the budget doubles
    8 -> 16 -> 32 in both packages."""
    got, want = [], []
    _, used = tcon.adaptive_sketches(
        _doubling_sample_fn(got, torch.as_tensor), tol=1e-4, max_rank=32,
        oversample=8, n_samples0=8, backend="torch")
    _, used_r = rcon.adaptive_sketches(
        _doubling_sample_fn(want, jnp.asarray), tol=1e-4, max_rank=32,
        oversample=8, n_samples0=8)
    assert got == want and used == used_r
    assert len(got) >= 2 and used > 8


@pytest.fixture(scope="module", params=[(16, 16, None), (32, 16, 6)],
                ids=["grid16", "grid32-n0=6"])
def injected(request):
    """Both packages' sketch constructions on the reference's Gaussians,
    with the budgets each drew."""
    side, leaf, n0 = request.param
    pts = regular_grid_points(side, 2)
    record = {"ref": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        _inject_reference_gaussians(mp, record)
        ref = rcon.sketch_construct(pts, KERN_J, leaf, 0.9, n_samples0=n0,
                                    **OPTS)
        port = tcon.sketch_construct(pts, KERN, leaf, 0.9, n_samples0=n0,
                                     device="cpu", **OPTS)
    return ref, port, record


def test_injected_gaussians_give_the_reference_ranks(injected):
    (rs, _, rt, _), (ps, pd, pt, _), record = injected
    assert ps.ranks == rs.ranks
    assert dataclasses.asdict(ps) == dataclasses.asdict(rs)
    assert (pt.perm == rt.perm).all()
    assert record["port"] == record["ref"]          # the same budgets drawn
    assert max(record["port"]) == max(record["ref"])
    assert pd.v_leaf is pd.u_leaf


def test_injected_gaussians_give_the_reference_operator(injected):
    (rs, rd, _, _), (ps, pd, _, _), _ = injected
    x = np.random.default_rng(5).standard_normal((rs.n, 3)).astype(
        np.float32)
    want = ref_matvec(rs, rd, jnp.asarray(x))
    for backend in ("cuda", "torch"):
        got = h2_matvec(ps, pd, torch.as_tensor(x), backend=backend)
        assert _rel(got, want) <= 1e-4


@pytest.fixture(scope="module")
def own4k():
    pts = regular_grid_points(64, 2)
    shape, data, tree, bs = tc.construct_h2(
        pts, KERN, 64, 0, 0.9, method="sketch",
        sketch_opts=dict(tol=1e-4, max_rank=64, seed=0), device="cpu")
    return pts, shape, data, tree


def test_own_rng_4k_points_to_tolerance(own4k):
    """>= 4k points, the port's own Gaussians: the product within 1e-3 of
    exact float64 rows of the kernel matrix."""
    pts, shape, data, tree = own4k
    assert shape.n == 4096
    x = np.random.default_rng(2).standard_normal((shape.n, 2))
    y = h2_matvec(shape, data, torch.as_tensor(x, dtype=torch.float32))
    p = torch.as_tensor(tree.points, dtype=torch.float64)
    y_ref = np.zeros((shape.n, 2))
    for a in range(0, shape.n, 1024):
        y_ref[a:a + 1024] = (KERN(p[a:a + 1024, None, :], p[None, :, :]) @
                             torch.as_tensor(x)).numpy()
    assert _rel(y, y_ref) < 1e-3
    assert check_orthogonal(shape, data) < 1e-4


def test_same_seed_bitwise_identical():
    pts = regular_grid_points(16, 2)
    a = tcon.sketch_construct(pts, KERN, 16, 0.9, device="cpu", **OPTS)
    b = tcon.sketch_construct(pts, KERN, 16, 0.9, device="cpu", **OPTS)
    c = tcon.sketch_construct(pts, KERN, 16, 0.9, device="cpu",
                              **dict(OPTS, seed=1))
    assert a[0] == b[0]
    assert torch.equal(a[1].u_leaf, b[1].u_leaf)
    for l in range(a[0].depth + 1):
        assert torch.equal(a[1].s[l], b[1].s[l])
    assert not torch.equal(a[1].u_leaf, c[1].u_leaf)


def test_all_dense_degenerate():
    """A shallow tree with no admissible blocks: rank-0 H^2, exact dense."""
    pts = np.random.default_rng(0).uniform(0, 1, (32, 2))
    shape, data, tree, _ = tc.construct_h2(pts, KERN, 16, 0, 0.9,
                                           method="sketch", device="cpu")
    assert shape.ranks == (0, 0) and shape.dense_count == 4
    dense = tc.dense_reference(pts, KERN, tree.perm)
    x = np.random.default_rng(1).standard_normal((shape.n, 2))
    y = h2_matvec(shape, data, torch.as_tensor(x, dtype=torch.float32))
    assert _rel(y, dense.numpy() @ x) < 1e-5


def test_numpy_kernel_is_refused():
    from repro.core.kernels_fn import exponential_kernel as np_kernel
    with pytest.raises(TypeError, match="torch tensors"):
        tcon.sketch_construct(regular_grid_points(16, 2), np_kernel(0.1),
                              16, 0.9, device="cpu")


def test_construct_h2_dispatches_to_sketch():
    pts = regular_grid_points(16, 2)
    s1, d1, _, _ = tc.construct_h2(pts, KERN, 16, 0, 0.9, method="sketch",
                                   sketch_opts=OPTS, device="cpu")
    s2, d2, _, _ = tcon.sketch_construct(pts, KERN, 16, 0.9, device="cpu",
                                         **OPTS)
    assert s1 == s2
    assert torch.equal(d1.u_leaf, d2.u_leaf)
    with pytest.raises(ValueError, match="unknown construction method"):
        tc.construct_h2(pts, KERN, 16, 0, 0.9, method="aca", device="cpu")


# ---------------------------------------------------------------------------
# black box
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid16():
    pts = regular_grid_points(16, 2)
    shape, data, tree, bs = tcon.sketch_construct(pts, KERN, 16, 0.9,
                                                  device="cpu", **OPTS)
    return pts, shape, data, tree, bs


def test_node_probe_and_block_reads_match_reference():
    rng = np.random.default_rng(6)
    blocks = rng.standard_normal((4, 8, 3)).astype(np.float32)
    want = rbb._node_probe(jnp.asarray(blocks))
    got = tbb._node_probe(torch.as_tensor(blocks))
    assert np.array_equal(got.numpy(), _np(want))
    z = rng.standard_normal((32, 12)).astype(np.float32)
    sr, sc = np.array([0, 0, 1, 3]), np.array([1, 2, 3, 0])
    want = rbb._gather_block_reads(jnp.asarray(z), 4, 8, 3, jnp.asarray(sr),
                                   jnp.asarray(sc))
    got = tbb._gather_block_reads(torch.as_tensor(z), 4, 8, 3,
                                  torch.as_tensor(sr), torch.as_tensor(sc))
    assert np.array_equal(got.numpy(), _np(want))


def test_leaf_coloring_matches_reference(grid16):
    _, shape, _, _, bs = grid16
    got = tbb._leaf_coloring(bs.d_rows, bs.d_cols, shape.n_leaves)
    want = rbb._leaf_coloring(bs.d_rows, bs.d_cols, shape.n_leaves)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    # same-colored leaves share no dense block row
    color = got[0]
    for t in range(shape.n_leaves):
        cols = bs.d_cols[bs.d_rows == t]
        assert len(set(color[cols])) == len(cols)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_construct_from_matvec_reconstructs(grid16, backend):
    pts, shape, data, _, _ = grid16

    def mv(x):
        return h2_matvec(shape, data, x, backend=backend)

    s2, d2, _, _ = tbb.construct_from_matvec(
        mv, pts, 16, 0.9, tol=1e-4, max_rank=48, backend=backend,
        device="cpu")
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (shape.n, 4)).astype(np.float32))
    assert _rel(h2_matvec(s2, d2, x, backend=backend), mv(x)) < 1e-4


def test_construct_from_matvec_square_workload(grid16):
    pts, shape, data, _, _ = grid16

    def mv2(x):
        return h2_matvec(shape, data, h2_matvec(shape, data, x))

    s2, d2, _, _ = tbb.construct_from_matvec(mv2, pts, 16, 0.9, tol=1e-4,
                                             max_rank=48, device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (shape.n, 2)).astype(np.float32))
    assert _rel(h2_matvec(s2, d2, x), mv2(x)) < 5e-3


def test_nonsymmetric_operator_rejected(grid16):
    pts, shape, data, _, _ = grid16
    dg = torch.as_tensor(np.random.default_rng(6).uniform(
        0.5, 1.5, (shape.n, 1)), dtype=torch.float32)
    with pytest.raises(ValueError, match="symmetric operators only"):
        tbb.construct_from_matvec(lambda v: dg * h2_matvec(shape, data, v),
                                  pts, 16, 0.9, device="cpu")


# ---------------------------------------------------------------------------
# the §6.4 app
# ---------------------------------------------------------------------------

def _reach(history, level: float) -> int:
    """The first iteration whose recurrence residual is <= ``level``."""
    h = np.asarray(history, np.float64)
    return int(np.nonzero(h <= level)[0][0])


@pytest.fixture(scope="module")
def sketch_solves():
    """``solve(16, construction="sketch")``: the reference's, the port's on
    the reference's Gaussians (both backends), and the port's on its own."""
    from repro.apps import fractional as rf
    from repro_torch.apps import fractional as pf
    with pytest.MonkeyPatch.context() as mp:
        _inject_reference_gaussians(mp)
        ref = rf.solve(16, construction="sketch")
        injected = {be: pf.solve(16, construction="sketch", device="cpu",
                                 backend=be) for be in ("cuda", "torch")}
    own = pf.solve(16, construction="sketch", device="cpu")
    return ref, injected, own


def test_sketch_solve_matches_reference(sketch_solves):
    """On the reference's Gaussians: u within 1e-4 and the convergence rate
    (iterations to 1e-6 and 1e-7) within 1 on both backends; the final
    count within 1 on the plain backend.  The cuda backend's final count
    is not held to the reference's: below 1e-7 the float32 recurrence
    hovers on its rounding floor (5.4e-8 to 9.3e-9 over the reference's
    last 4 iterations) and the order of the plain kernels' sums ends it 3
    iterations later (22 against 19), as the cheb-built solves do
    (tests/test_torch_fractional.py).  With its own Gaussians the port
    solves with status 0 within 2 iterations of the reference."""
    ref, injected, own = sketch_solves
    rate = [_reach(ref["history"], lv) for lv in (1e-6, 1e-7)]
    for be, res in injected.items():
        assert res["status"] == 0
        assert "compress" not in res["prob"]["timings"]
        assert _rel(res["u"].numpy(), _np(ref["u"])) <= 1e-4
        got = [_reach(res["history"], lv) for lv in (1e-6, 1e-7)]
        assert all(abs(g - w) <= 1 for g, w in zip(got, rate)), (be, got)
    assert abs(injected["torch"]["iters"] - ref["iters"]) <= 1
    assert own["status"] == 0
    assert abs(own["iters"] - ref["iters"]) <= 2
