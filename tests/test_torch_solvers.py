"""PyTorch port: the Krylov solvers and the multigrid V-cycle against the
JAX reference (``repro.solvers``), on the same inputs made from a numpy
seed.

Tolerances: iteration counts equal within 1 (the two packages sum their
dot products in different orders, so a solve ending right at the
tolerance may take one step more or less); solutions within 1e-5 relative;
residual histories within 1e-5 absolute over the iterations both ran;
status codes equal; the V-cycle within 1e-5 relative.  The port's own
segmentation (``pcg_init`` + ``pcg_segment`` against ``pcg``) is held
bitwise.  The ``cuda`` tests need a card: a segment replayed from its CUDA
graph equals the eager segment bitwise, a second solve with the same
operator captures nothing new, and the captured program goes with its
operator.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.guard import status as pstatus
from repro_torch.solvers import graphs
from repro_torch.solvers import krylov as pk
from repro_torch.solvers import mg as pmg

torch.set_num_threads(2)


def _jax():
    """(jax.numpy, repro.solvers): imported per test."""
    jnp = pytest.importorskip("jax.numpy")
    import repro.solvers as rs
    return jnp, rs


def random_spd(n, seed, lo=1.0, hi=10.0) -> np.ndarray:
    """SPD with eigenvalues in [lo, hi] (``tests/test_solvers.py``)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((q * rng.uniform(lo, hi, n)) @ q.T).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _same_run(port, ref, per_column=False):
    """Iterations within 1, x within 1e-5, statuses equal, histories
    within 1e-5 over the common prefix."""
    pi, ri = _np(port.iters), _np(ref.iters)
    assert np.all(np.abs(pi.astype(np.int64) - ri) <= 1), (pi, ri)
    assert _rel(_np(port.x), _np(ref.x)) <= 1e-5
    np.testing.assert_array_equal(_np(port.status), _np(ref.status))
    assert bool(port.converged) == bool(ref.converged)
    hp, hr = _np(port.res_history), _np(ref.res_history)
    assert hp.shape == hr.shape
    rows = int(min(pi.max(), ri.max())) + 1
    np.testing.assert_allclose(hp[:rows], hr[:rows], rtol=0, atol=1e-5)
    if np.all(pi == ri) and not per_column:
        np.testing.assert_array_equal(np.isnan(hp), np.isnan(hr))


PCG_CASES = [(8, 11), (16, 3), (24, 77), (32, 1234)]


@pytest.mark.parametrize("n,seed", PCG_CASES)
@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_pcg_matches_reference(n, seed, precond):
    jnp, rs = _jax()
    a = random_spd(n, seed, 1.0, 50.0 if precond == "jacobi" else 10.0)
    b = np.random.default_rng(seed + 1).standard_normal(n).astype(np.float32)
    d = np.diag(a).copy()
    ja, jd = jnp.asarray(a), jnp.asarray(d)
    ta, td = torch.as_tensor(a), torch.as_tensor(d)
    ref = rs.pcg(lambda x: ja @ x, jnp.asarray(b),
                 precond=(lambda r: r / jd) if precond == "jacobi" else None,
                 tol=1e-6, maxiter=6 * n)
    port = pk.pcg(lambda x: ta @ x, torch.as_tensor(b),
                  precond=(lambda r: r / td) if precond == "jacobi" else None,
                  tol=1e-6, maxiter=6 * n)
    assert bool(port.converged)
    _same_run(port, ref)
    assert port.iters.dtype == torch.int32
    assert port.res_history.shape == (6 * n + 1,)


@pytest.mark.parametrize("n,nv,seed", [(12, 3, 5), (20, 4, 21), (16, 1, 8)])
def test_block_cg_matches_reference(n, nv, seed):
    jnp, rs = _jax()
    a = random_spd(n, seed)
    bb = np.random.default_rng(seed + 3).standard_normal((n, nv)
                                                         ).astype(np.float32)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    ref = rs.block_cg(lambda x: ja @ x, jnp.asarray(bb), tol=1e-6,
                      maxiter=4 * n)
    port = pk.block_cg(lambda x: ta @ x, torch.as_tensor(bb), tol=1e-6,
                       maxiter=4 * n)
    assert bool(port.converged)
    assert port.iters.shape == (nv,) and port.status.shape == (nv,)
    _same_run(port, ref, per_column=True)


@pytest.mark.parametrize("n,m,seed", [(16, 5, 2), (24, 8, 9), (12, 10, 4)])
def test_gmres_matches_reference(n, m, seed):
    jnp, rs = _jax()
    rng = np.random.default_rng(seed)
    a = (2 * np.eye(n) + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
         ).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    ref = rs.gmres(lambda x: ja @ x, jnp.asarray(b), m=m, tol=1e-6,
                   maxiter=60)
    port = pk.gmres(lambda x: ta @ x, torch.as_tensor(b), m=m, tol=1e-6,
                    maxiter=60)
    assert bool(port.converged)
    assert int(port.iters) == int(ref.iters)
    _same_run(port, ref)


def test_pcg_segments_equal_pcg_bitwise():
    a = torch.as_tensor(random_spd(40, 17, 1.0, 1e3))
    d = torch.diagonal(a).clone()
    b = torch.as_tensor(np.random.default_rng(6).standard_normal(40)
                        .astype(np.float32))

    def op(x):
        return a @ x

    def pre(r):
        return r / d

    whole = pk.pcg(op, b, precond=pre, tol=1e-6, maxiter=200)
    state = pk.pcg_init(op, b, precond=pre)
    for _ in range(200 // 7 + 1):
        state = pk.pcg_segment(op, b, state, precond=pre, tol=1e-6, steps=7,
                               maxiter=200)
    assert int(state.k) == int(whole.iters) > 7
    assert torch.equal(state.x, whole.x)
    assert int(state.status) == int(whole.status) == pk.STATUS_OK


def test_block_cg_warm_start_matches_cold_reference():
    """Warm-started segments (the serving layer's continuation) reach the
    same tolerance as one cold reference solve; a further segment takes no
    iteration.  Held to a cold reference solve, not to the reference's own
    warm-start test (ROADMAP Queue 3)."""
    jnp, rs = _jax()
    n = 20
    a = random_spd(n, 31)
    bb = np.random.default_rng(36).standard_normal((n, 3)).astype(np.float32)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    cold = rs.block_cg(lambda x: ja @ x, jnp.asarray(bb), tol=1e-6,
                       maxiter=8 * n)
    x = torch.zeros((n, 3))
    total = np.zeros(3, np.int64)
    for _ in range(8 * n // 3 + 2):
        r = pk.block_cg(lambda v: ta @ v, torch.as_tensor(bb), tol=1e-6,
                        maxiter=3, x0=x)
        x = r.x
        total += _np(r.iters)
        if bool(r.converged):
            break
    assert bool(r.converged)
    assert _rel(_np(x), _np(cold.x)) < 1e-4
    again = pk.block_cg(lambda v: ta @ v, torch.as_tensor(bb), tol=1e-6,
                        maxiter=3, x0=x)
    assert _np(again.iters).tolist() == [0, 0, 0]
    assert bool(again.converged)


def test_zero_rhs_returns_zero_without_iterating():
    a = torch.as_tensor(random_spd(12, 7))

    def op(x):
        return a @ x

    res = pk.pcg(op, torch.zeros(12), tol=1e-8)
    assert int(res.iters) == 0 and float(res.relres) == 0.0
    assert bool(res.converged) and float(res.x.abs().max()) == 0.0
    assert float(res.res_history[0]) == 0.0
    resg = pk.gmres(op, torch.zeros(12), m=4, tol=1e-8)
    assert bool(resg.converged) and int(resg.iters) == 0
    resb = pk.block_cg(op, torch.zeros((12, 3)), tol=1e-8)
    assert bool(resb.converged) and int(resb.iters.max()) == 0


def _drill(lam_min, seed):
    from repro.guard.drills import drill_near_singular
    a, b = drill_near_singular(lam_min=lam_min, seed=seed)
    return np.array(a), np.array(b)


@pytest.mark.parametrize("case", ["nan", "indefinite", "stagnation"])
def test_breakdown_status_matches_reference(case):
    jnp, rs = _jax()
    if case == "stagnation":
        a, b = _drill(1e-7, 1)
        tol, maxiter = 1e-10, 500
    else:
        a, b = _drill(-0.1, 0)
        tol, maxiter = 1e-6, 200 if case == "indefinite" else 50
        if case == "nan":
            a[0, 0] = np.nan
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    ref = rs.pcg(lambda x: ja @ x, jnp.asarray(b), tol=tol, maxiter=maxiter)
    port = pk.pcg(lambda x: ta @ x, torch.as_tensor(b), tol=tol,
                  maxiter=maxiter)
    want = {"nan": pk.STATUS_NAN, "indefinite": pk.STATUS_INDEFINITE,
            "stagnation": pk.STATUS_STAGNATION}[case]
    assert pstatus.worst_status(port.status) == want
    assert pstatus.worst_status(port.status) == \
        int(np.max(np.asarray(ref.status)))
    assert pstatus.status_name(port.status) == pstatus.STATUS_NAMES[want]
    assert not bool(port.converged)
    assert int(port.iters) < maxiter
    if case != "stagnation":
        # where the rounding floor stalls the solve is a matter of the
        # order of the sums, so only the verdict is compared there
        assert abs(int(port.iters) - int(ref.iters)) <= 1


def test_block_cg_status_per_column():
    """One poisoned column trips NAN for that column only, as in the
    reference."""
    jnp, rs = _jax()
    a = random_spd(24, 3)
    bb = np.random.default_rng(0).standard_normal((24, 3)).astype(np.float32)
    bb[:, 1] = np.nan
    ref = rs.block_cg(lambda x: jnp.asarray(a) @ x, jnp.asarray(bb),
                      tol=1e-6, maxiter=100)
    res = pk.block_cg(lambda x: torch.as_tensor(a) @ x, torch.as_tensor(bb),
                      tol=1e-6, maxiter=100)
    st = _np(res.status)
    assert st.tolist() == [pk.STATUS_OK, pk.STATUS_NAN, pk.STATUS_OK]
    np.testing.assert_array_equal(st, np.asarray(ref.status))
    assert pstatus.worst_status(res.status) == pk.STATUS_NAN
    ok = [0, 2]
    assert _rel(_np(res.x)[:, ok], np.asarray(ref.x)[:, ok]) <= 1e-5


def test_gmres_nan_is_breakdown_or_nan():
    a, b = _drill(-0.1, 0)
    a[0, 0] = np.nan
    res = pk.gmres(lambda x: torch.as_tensor(a) @ x, torch.as_tensor(b),
                   m=5, tol=1e-6, maxiter=20)
    assert pstatus.worst_status(res.status) in (pk.STATUS_BREAKDOWN,
                                                pk.STATUS_NAN)


def test_scalar_dtype_float64():
    """The fp64 rung accumulates the scalars in float64 and keeps the
    iterates in float32; it solves the system as the float32 reference
    does (the reference's rung is a no-op without x64)."""
    jnp, rs = _jax()
    n = 24
    a = random_spd(n, 13)
    b = np.random.default_rng(14).standard_normal(n).astype(np.float32)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    ref = rs.pcg(lambda x: ja @ x, jnp.asarray(b), tol=1e-6, maxiter=100)
    port = pk.pcg(lambda x: ta @ x, torch.as_tensor(b), tol=1e-6,
                  maxiter=100, scalar_dtype=torch.float64)
    assert port.x.dtype == torch.float32
    assert port.relres.dtype == torch.float32
    assert port.res_history.dtype == torch.float32
    _same_run(port, ref)
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    assert _rel(_np(port.x), x64) < 1e-5


def test_guard_off_same_iterates():
    a = torch.as_tensor(random_spd(16, 3))
    b = torch.ones(16)
    on = pk.pcg(lambda x: a @ x, b, tol=1e-6)
    off = pk.pcg(lambda x: a @ x, b, tol=1e-6, guard=False)
    assert torch.equal(on.x, off.x) and int(on.iters) == int(off.iters)
    assert int(off.status) == pk.STATUS_OK
    pk.set_guards_enabled(False)
    try:
        assert not pk.guards_enabled()
        killed = pk.pcg(lambda x: a @ x, b, tol=1e-6)
    finally:
        pk.set_guards_enabled(True)
    assert torch.equal(killed.x, off.x)


def test_status_helpers():
    assert pstatus.worst_status(None) == pk.STATUS_OK
    assert pstatus.worst_status(torch.tensor([0, 3, 1],
                                             dtype=torch.int32)) == 3
    assert pstatus.status_name(2) == "indefinite"
    assert pstatus.status_name(np.int32(4)) == "breakdown"


def test_eager_on_cpu_captures_nothing():
    a = torch.as_tensor(random_spd(10, 3))
    before = dict(pk.TRACE_COUNTS)
    pk.pcg(lambda x: a @ x, torch.ones(10), tol=1e-6)
    assert pk.TRACE_COUNTS == before
    with pytest.raises(ValueError):
        pk.pcg(lambda x: a @ x, torch.ones(10), graph=True)


# ---------------------------------------------------------------------------
# multigrid V-cycle
# ---------------------------------------------------------------------------

def _mg_inputs(n: int):
    from repro_torch.apps.fractional import interior_grid
    from repro_torch.core.kernels_fn import diffusivity_2d
    kappa = diffusivity_2d(torch.as_tensor(interior_grid(n))).reshape(n, n)
    rng = np.random.default_rng(n)
    d = rng.uniform(0.5, 2.0, (n, n)).astype(np.float32) * n
    r = rng.standard_normal(n * n).astype(np.float32)
    return kappa.numpy().astype(np.float32), d, r


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("nu,n_cycles", [(3, 2), (2, 1)])
def test_mg_precond_matches_reference(n, nu, n_cycles):
    jnp, _ = _jax()
    from repro.solvers.mg import build_grid_mg as ref_build
    from repro.solvers.mg import mg_precond_local as ref_apply
    kappa, d, r = _mg_inputs(n)
    h, gamma = 2.0 / n, (2.0 / n) ** -1.5
    rmg, rarr = ref_build(jnp.asarray(kappa), jnp.asarray(d), gamma, h, n,
                          nu=nu, n_cycles=n_cycles)
    pmg_, parr = pmg.build_grid_mg(torch.as_tensor(kappa),
                                   torch.as_tensor(d), gamma, h, n, nu=nu,
                                   n_cycles=n_cycles, device="cpu")
    assert pmg_.levels == rmg.levels and pmg_.hs == rmg.hs
    for field in ("ke", "kw", "kn", "ks", "dd", "jd"):
        for got, want in zip(getattr(parr, field), getattr(rarr, field)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(ref_apply(rmg, rarr, jnp.asarray(r)))
    got = pmg.mg_precond_local(pmg_, parr, torch.as_tensor(r))
    assert got.shape == (n * n,)
    assert _rel(got.numpy(), want) <= 1e-5


def test_mg_stencil_matches_reference():
    jnp, _ = _jax()
    from repro.solvers.mg import _apply_op as ref_op
    from repro.solvers.mg import _prolong as ref_prolong
    from repro.solvers.mg import build_grid_mg as ref_build
    kappa, d, r = _mg_inputs(16)
    h, gamma = 2.0 / 16, 8.0 ** 1.5
    rmg, rarr = ref_build(jnp.asarray(kappa), jnp.asarray(d), gamma, h, 16)
    pmg_, parr = pmg.build_grid_mg(kappa, d, gamma, h, 16, device="cpu")
    u = r.reshape(16, 16)
    for l in range(len(pmg_.levels)):
        n_l = pmg_.levels[l]
        ul = u[:n_l, :n_l]
        got = pmg._apply_op(pmg_, parr, l, torch.as_tensor(ul)).numpy()
        want = np.asarray(ref_op(rmg, rarr, l, jnp.asarray(ul), None))
        assert _rel(got, want) <= 1e-6
    e = u[:8, :8]
    np.testing.assert_array_equal(pmg._prolong(torch.as_tensor(e)).numpy(),
                                  np.asarray(ref_prolong(jnp.asarray(e))))
    np.testing.assert_array_equal(pmg._restrict(torch.as_tensor(u)).numpy(),
                                  pmg._restrict_np(u))


def test_build_grid_mg_distributed_not_ported():
    """The sharded V-cycle is ported: ``p = 2`` builds the row-strip
    pyramid (every level of n = 8 sharded, with its deep-halo strips),
    and a ``p`` that does not divide n raises as in the reference
    (``tests/test_torch_dist_solve.py`` holds it to the reference)."""
    kappa, d, _ = _mg_inputs(8)
    mg, arrs = pmg.build_grid_mg(kappa, d, 1.0, 0.25, 8, p=2, device="cpu")
    assert mg.p == 2 and mg.n_sharded == len(mg.levels) == 2
    assert [tuple(t.shape) for t in arrs.hc] == [(2 * (4 + 6), 6, 8),
                                                 (2 * (2 + 6), 6, 4)]
    with pytest.raises(ValueError, match="not divisible"):
        pmg.build_grid_mg(kappa, d, 1.0, 0.25, 8, p=3, device="cpu")


# ---------------------------------------------------------------------------
# on the card: graphs against eager
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_system(cuda, n=64, seed=5):
    a = torch.as_tensor(random_spd(n, seed, 1.0, 100.0)).to(cuda)
    d = torch.diagonal(a).clone()
    b = torch.as_tensor(np.random.default_rng(seed).standard_normal(n)
                        .astype(np.float32)).to(cuda)

    def op(x):
        return a @ x

    def pre(r):
        return r / (d[:, None] if r.dim() == 2 else d)

    return op, pre, b


@pytest.mark.cuda
def test_cuda_graph_segment_equals_eager(cuda):
    op, pre, b = _card_system(cuda)
    state = pk.pcg_init(op, b, precond=pre)
    before = pk.TRACE_COUNTS["pcg_segment"]
    eager = pk.pcg_segment(op, b, state, precond=pre, tol=1e-7, steps=7,
                           maxiter=200, graph=False)
    replay = pk.pcg_segment(op, b, state, precond=pre, tol=1e-7, steps=7,
                            maxiter=200, graph=True)
    assert pk.TRACE_COUNTS["pcg_segment"] == before + 1
    for f in ("k", "x", "r", "p", "rz", "res", "status"):
        assert torch.equal(getattr(eager, f), getattr(replay, f)), f
    assert int(replay.k) == 7


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pcg", "block_cg", "gmres"])
def test_cuda_second_solve_captures_nothing(cuda, method):
    op, pre, b = _card_system(cuda)
    run = {"pcg": lambda rhs, g: pk.pcg(op, rhs, pre, tol=1e-6, graph=g),
           "block_cg": lambda rhs, g: pk.block_cg(
               op, torch.stack([rhs, 2 * rhs], 1), pre, tol=1e-6, graph=g),
           "gmres": lambda rhs, g: pk.gmres(op, rhs, pre, m=8, tol=1e-6,
                                            maxiter=80, graph=g)}[method]
    before = pk.TRACE_COUNTS[method]
    first = run(b, True)
    second = run(3.0 * b, True)
    assert pk.TRACE_COUNTS[method] == before + 1
    eager = run(b, False)
    assert torch.equal(first.x, eager.x)
    assert torch.equal(first.iters, eager.iters)
    assert bool(first.converged) and bool(second.converged)
    # the captured program lives as long as its operator, and no longer
    assert len(graphs._PROGRAMS[op]) == 1
    alive = weakref.ref(op)
    del op, run
    gc.collect()
    assert alive() is None
    assert all(len(p) for p in graphs._PROGRAMS.values())
