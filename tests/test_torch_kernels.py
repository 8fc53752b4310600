"""PyTorch port: the plain version of each kernel against the JAX Pallas
kernel (interpret mode, as the reference's own tests run it), the backend
dispatch, and -- on a CUDA card only -- each hand-written kernel against its
plain version.

Tolerances: batched GEMM and the block-sparse MV 1e-5 relative (fp32 sums
in another order); QR elementwise 1e-4 (the unique sign-fixed form); SVD
sigma within 1e-4 * sigma_max, ``||A - U S V^T|| <= 1e-4 ||A||`` and
``U^T U`` within 1e-4 of I (U is unique only up to column signs).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import batched_gemm as kbg
from repro_torch.kernels import batched_qr as kbq
from repro_torch.kernels import batched_svd as kbs
from repro_torch.kernels import coupling_mv as kcm
from repro_torch.kernels import halo_pack as khp
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _jax():
    """(jax.numpy, repro.kernels.ops): imported per test, so that the
    ``cuda`` tests below also run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    return jnp, jops


def _rand(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def random_plan(rng, rows, maxb, nodes):
    """(blk, col, cnt, nb): cnt[r] blocks in the leading slots of row r,
    at least one empty row, padding slots hold the sentinel nb."""
    cnt = rng.integers(0, maxb + 1, rows).astype(np.int32)
    cnt[0] = maxb
    if rows > 1:
        cnt[1] = 0
    nb = int(cnt.sum())
    blk = np.full(rows * maxb, nb, np.int32)
    col = np.zeros(rows * maxb, np.int32)
    b = 0
    for r in range(rows):
        for j in range(int(cnt[r])):
            blk[r * maxb + j] = b
            col[r * maxb + j] = rng.integers(0, nodes)
            b += 1
    return blk, col, cnt, nb


def _conditioned(rng, b, n, k, log_cond):
    out = np.empty((b, n, k), np.float32)
    for i in range(b):
        u, _ = np.linalg.qr(rng.standard_normal((n, k)))
        v, _ = np.linalg.qr(rng.standard_normal((k, k)))
        out[i] = (u * np.logspace(0, -log_cond, k)) @ v.T
    return out


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

GEMM_SHAPES = [(1, 8, 8, 8), (4, 16, 32, 8), (3, 64, 16, 1), (5, 36, 36, 16),
               (2, 64, 36, 16), (3, 7, 5, 3)]


@pytest.mark.parametrize("b,m,k,n", GEMM_SHAPES)
def test_gemm_plain_matches_pallas(b, m, k, n):
    jnp, jops = _jax()
    rng = np.random.default_rng(b * 1000 + m + k + n)
    a, bb = _rand(rng, b, m, k), _rand(rng, b, k, n)
    want = jops.batched_gemm(jnp.asarray(a), jnp.asarray(bb))
    got = ref.batched_gemm(torch.as_tensor(a), torch.as_tensor(bb))
    assert _rel(got, want) <= 1e-5


def test_gemm_plain_transposed_view():
    """The upsweep's V^T is a strided view of the leaf bases."""
    jnp, jops = _jax()
    rng = np.random.default_rng(3)
    v, x = _rand(rng, 6, 64, 36), _rand(rng, 6, 64, 16)
    want = jops.batched_gemm(jnp.swapaxes(jnp.asarray(v), -1, -2),
                             jnp.asarray(x))
    vt = torch.as_tensor(v).transpose(-1, -2)
    assert not vt.is_contiguous()
    got = ops.batched_gemm(vt, torch.as_tensor(x), backend="cuda")
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape_a,shape_b", [
    ((0, 4, 4), (0, 4, 2)), ((3, 0, 4), (3, 4, 2)), ((3, 4, 0), (3, 0, 2)),
    ((3, 4, 5), (3, 5, 0))])
def test_gemm_zero_size_dims(shape_a, shape_b):
    jnp, jops = _jax()
    a, b = torch.randn(shape_a), torch.randn(shape_b)
    want = np.asarray(jops.batched_gemm(jnp.asarray(a.numpy()),
                                        jnp.asarray(b.numpy())))
    for backend in ops.BACKENDS:
        got = ops.batched_gemm(a, b, backend=backend)
        assert tuple(got.shape) == want.shape
        assert not got.any()


@pytest.mark.parametrize("rows,maxb,k,nv", [
    (4, 3, 8, 1), (8, 5, 16, 16), (2, 1, 4, 2), (16, 4, 7, 1),
    (16, 4, 7, 16)])
def test_coupling_mv_plain_matches_pallas(rows, maxb, k, nv):
    jnp, jops = _jax()
    rng = np.random.default_rng(rows * 100 + maxb + nv)
    blk, col, cnt, nb = random_plan(rng, rows, maxb, rows)
    s, x = _rand(rng, nb, k, k), _rand(rng, rows, k, nv)
    want = jops.coupling_mv(jnp.asarray(s), jnp.asarray(x), jnp.asarray(blk),
                            jnp.asarray(col), jnp.asarray(cnt), maxb=maxb)
    t = [torch.as_tensor(a) for a in (s, x, blk, col, cnt)]
    got = ref.coupling_mv(*t, maxb=maxb)
    assert _rel(got, want) <= 1e-5
    # the empty row is zero and the plan is left as it was
    assert not got[1].any()
    assert t[2].dtype == torch.int32 and np.array_equal(t[2].numpy(), blk)


def test_coupling_mv_rectangular_blocks():
    """Dense leaves are m x m; the kernel takes any k1 x k2."""
    rng = np.random.default_rng(5)
    blk, col, cnt, nb = random_plan(rng, 6, 3, 9)
    s, x = _rand(rng, nb, 5, 3), _rand(rng, 9, 3, 4)
    want = np.zeros((6, 5, 4), np.float32)
    for r in range(6):
        for j in range(int(cnt[r])):
            want[r] += s[blk[r * 3 + j]] @ x[col[r * 3 + j]]
    got = ops.coupling_mv(*[torch.as_tensor(a) for a in (s, x, blk, col, cnt)],
                          maxb=3)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("case", ["maxb0", "nb0"])
def test_coupling_mv_empty_plans_give_zeros(case):
    """The JAX matvec never calls its kernel on an empty level; the port's
    wrapper returns zeros without launching."""
    rows, k, nv = 4, 3, 2
    if case == "maxb0":
        maxb, nb = 0, 0
        blk = col = torch.zeros(0, dtype=torch.int32)
    else:
        maxb, nb = 2, 0
        blk = torch.zeros(rows * maxb, dtype=torch.int32)   # all sentinels
        col = torch.zeros(rows * maxb, dtype=torch.int32)
    cnt = torch.zeros(rows, dtype=torch.int32)
    s, x = torch.randn(nb, k, k), torch.randn(rows, k, nv)
    got = ops.coupling_mv(s, x, blk, col, cnt, maxb=maxb)
    assert got.shape == (rows, k, nv) and not got.any()


def _qr_pair(a):
    jnp, jops = _jax()
    qj, rj = jops.batched_qr(jnp.asarray(a))
    qt, rt = ref.batched_qr(torch.as_tensor(a))
    return (np.asarray(qj), np.asarray(rj)), (qt.numpy(), rt.numpy())


@pytest.mark.parametrize("b,n,k", [(3, 24, 8), (2, 40, 10), (2, 72, 36),
                                   (3, 8, 36), (2, 16, 16), (2, 9, 1)])
def test_qr_plain_matches_pallas_elementwise(b, n, k):
    """Sign-fixed QR is unique: Q and R compare elementwise, including the
    wide n < k panels of high-order Chebyshev leaves."""
    rng = np.random.default_rng(b * 100 + n + k)
    (qj, rj), (qt, rt) = _qr_pair(_rand(rng, b, n, k))
    kn = min(n, k)
    assert qt.shape == (b, n, kn) and rt.shape == (b, kn, k)
    assert np.abs(qt - qj).max() <= 1e-4
    assert np.abs(rt - rj).max() <= 1e-4 * max(np.abs(rj).max(), 1.0)


def test_qr_plain_rank_deficient():
    """A rank-3 panel: R and the first three Q columns agree elementwise;
    the columns past the rank complete the basis arbitrarily and are held
    to orthonormality instead."""
    rng = np.random.default_rng(5)
    a = _rand(rng, 2, 20, 3) @ _rand(rng, 2, 3, 9)
    (qj, rj), (qt, rt) = _qr_pair(a)
    assert np.abs(rt - rj).max() <= 1e-4 * np.abs(rj).max()
    assert np.abs(qt[..., :3] - qj[..., :3]).max() <= 1e-4
    gram = np.einsum("bnk,bnj->bkj", qt, qt)
    assert np.abs(gram - np.eye(9)).max() <= 1e-4


def test_qr_plain_zero_column():
    """A vanishing column gets a zero reflector on both sides."""
    rng = np.random.default_rng(6)
    a = _rand(rng, 2, 12, 5)
    a[:, :, 2] = 0.0
    (qj, rj), (qt, rt) = _qr_pair(a)
    assert np.isfinite(qt).all() and np.isfinite(rt).all()
    assert np.abs(qt - qj).max() <= 1e-4
    assert np.abs(rt - rj).max() <= 1e-4 * np.abs(rj).max()


def _svd_checks(a, u, s, vt, s_want):
    a = np.asarray(a, np.float64)
    u, s, vt = (np.asarray(t, np.float64) for t in (u, s, vt))
    smax = np.abs(np.asarray(s_want)).max(axis=-1, keepdims=True)
    assert (np.abs(s - np.asarray(s_want)) / smax).max() <= 1e-4
    rec = np.einsum("bnk,bk,bkj->bnj", u, s, vt)
    assert (np.linalg.norm(rec - a, axis=(1, 2)) /
            np.linalg.norm(a, axis=(1, 2))).max() <= 1e-4
    gram = np.einsum("bnk,bnj->bkj", u, u)
    assert np.abs(gram - np.eye(gram.shape[-1])).max() <= 1e-4


@pytest.mark.parametrize("name", ["square", "odd-k", "wide", "graded-1e-7",
                                  "tall-stack"])
def test_svd_plain_matches_pallas(name):
    jnp, jops = _jax()
    rng = np.random.default_rng(len(name))
    a = {"square": lambda: _rand(rng, 2, 8, 8),
         "odd-k": lambda: _rand(rng, 3, 18, 7),
         "wide": lambda: _rand(rng, 2, 4, 9),
         "graded-1e-7": lambda: _conditioned(rng, 2, 24, 12, 7),
         "tall-stack": lambda: _rand(rng, 2, 20, 10)}[name]()
    uj, sj, vtj = jops.batched_svd(jnp.asarray(a))
    ut, st, vtt = ref.batched_svd(torch.as_tensor(a))
    kn = min(a.shape[1], a.shape[2])
    assert ut.shape == (a.shape[0], a.shape[1], kn)
    assert vtt.shape == (a.shape[0], kn, a.shape[2])
    # the plain version and the Pallas kernel both hold the contract
    _svd_checks(a, ut, st, vtt, np.asarray(sj))
    _svd_checks(a, uj, sj, vtj, st.numpy())


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_backends_on_cpu_take_the_plain_versions():
    rng = np.random.default_rng(0)
    a = torch.as_tensor(_rand(rng, 3, 10, 4))
    before = ops.launch_counts()
    for backend in ops.BACKENDS:
        q, r = ops.backend_qr(a, backend)
        q0, r0 = ref.batched_qr(a)
        assert torch.equal(q, q0) and torch.equal(r, r0)
        assert torch.equal(ops.backend_qr_r(a, backend), r0)
        u, s, vt = ops.backend_svd(a, backend)
        assert torch.equal(s, ref.batched_svd(a)[1])
    assert ops.launch_counts() == before


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        ops.batched_gemm(torch.zeros(1, 2, 2), torch.zeros(1, 2, 2),
                         backend="pallas")


@pytest.mark.parametrize("call", ["gemm", "coupling", "qr", "qr_r", "svd",
                                  "halo_pack"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper launches on the card or raises; it never computes
    on the CPU itself (that choice belongs to ``ops``)."""
    a = torch.zeros(2, 4, 4)
    i = torch.zeros(2, dtype=torch.int32)
    fn = {"gemm": lambda: kbg.batched_gemm(a, a),
          "coupling": lambda: kcm.coupling_mv(a, a, i, i, i, maxb=1),
          "qr": lambda: kbq.batched_qr(a),
          "qr_r": lambda: kbq.batched_qr_r(a),
          "svd": lambda: kbs.batched_svd(a),
          "halo_pack": lambda: khp.halo_pack(a, i)}[call]
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fn()
    assert ops.launch_counts() == before


def test_launch_counter_reset():
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    assert sorted(ops.launch_counts()) == sorted(
        ["batched_gemm", "coupling_mv", "batched_qr", "batched_svd",
         "halo_pack"])


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,n", GEMM_SHAPES + [(16, 36, 64, 16)])
def test_cuda_gemm_matches_plain(cuda, b, m, k, n):
    gen = torch.Generator().manual_seed(b + m + k + n)
    a = torch.randn(b, k, m, generator=gen).to(cuda).transpose(-1, -2)
    bb = torch.randn(b, k, n, generator=gen).to(cuda)
    before = kbg.LAUNCHES
    got = kbg.batched_gemm(a, bb)
    assert kbg.LAUNCHES == before + 1
    assert _rel(got.cpu(), ref.batched_gemm(a, bb).cpu()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows,maxb,k,nv", [(64, 17, 36, 16), (64, 5, 64, 16),
                                            (33, 3, 7, 1), (9, 2, 130, 20),
                                            (64, 17, 3, 16), (64, 13, 5, 16),
                                            (64, 13, 15, 16), (64, 5, 64, 1)])
def test_cuda_coupling_mv_matches_plain(cuda, rows, maxb, k, nv):
    rng = np.random.default_rng(rows + maxb + k + nv)
    blk, col, cnt, nb = random_plan(rng, rows, maxb, rows)
    t = [torch.as_tensor(a).to(cuda) for a in
         (_rand(rng, nb, k, k), _rand(rng, rows, k, nv), blk, col, cnt)]
    got = kcm.coupling_mv(*t, maxb=maxb)
    assert _rel(got.cpu(), ref.coupling_mv(*t, maxb=maxb).cpu()) <= 1e-5


def _qr_input(gen, kind, b, n, k):
    """A QR test panel: random, rank-deficient (rank 3), a zero column, or
    graded columns (scales 1 ... 1e-7)."""
    a = torch.randn(b, n, k, generator=gen)
    if kind == "rank-deficient":
        a = torch.randn(b, n, 3, generator=gen) @ \
            torch.randn(b, 3, k, generator=gen)
    elif kind == "zero-column":
        a[:, :, k // 2] = 0.0
    elif kind == "graded":
        a = a * torch.logspace(0, -7, k)
    return a


def _qr_close(q, r, q_want, r_want, q_cols):
    assert (q[..., :q_cols] - q_want[..., :q_cols]).abs().max().item() <= 1e-4
    assert (r - r_want).abs().max().item() <= \
        1e-4 * r_want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,kind", [
    (64, 64, 36, "random"), (32, 72, 36, "random"), (8, 648, 36, "random"),
    (8, 8, 36, "random"), (4, 1152, 64, "random"), (5, 9, 1, "random"),
    (16, 36, 36, "random"), (16, 30, 30, "random"), (16, 6, 6, "random"),
    (6, 650, 36, "random"), (3, 396, 36, "random"), (4, 504, 36, "random"),
    (4, 288, 36, "random"), (4, 324, 36, "random"), (4, 144, 36, "random"),
    (8, 40, 9, "rank-deficient"), (4, 300, 9, "rank-deficient"),
    (8, 40, 9, "zero-column"), (4, 300, 36, "zero-column"),
    (8, 64, 36, "graded"), (4, 648, 36, "graded")])
def test_cuda_qr_matches_plain(cuda, b, n, k, kind):
    """Every route against the plain version and a float64 QR, Q at 1e-4
    and R at 1e-4 * max|R|: the route ``qr_plan`` gives the shape in a
    large batch (forced here, as these batches are small), the R-only entry
    likewise (bitwise equal to the full QR's R where both take one route),
    and the general route, whose shared and global paths are bitwise equal.
    Past a rank-deficient panel's rank Q completes the basis arbitrarily:
    compared through R and Q^T Q."""
    from repro_torch.kernels.batched_qr import qr_plan
    gen = torch.Generator().manual_seed(b + n + k)
    a = _qr_input(gen, kind, b, n, k).to(cuda)
    q_cols = 3 if kind == "rank-deficient" else min(n, k)
    q_route, r_route = qr_plan(n, k, True), qr_plan(n, k, False)
    q, r = kbq.batched_qr(a, route=q_route)
    q0, r0 = ref.batched_qr(a)
    q64, r64 = ref.batched_qr(a.double())
    _qr_close(q, r, q0, r0, q_cols)
    _qr_close(q.double(), r.double(), q64, r64, q_cols)
    gram = q.transpose(-1, -2) @ q
    assert (gram - torch.eye(q.shape[-1], device=cuda)).abs().max() <= 1e-4
    rr = kbq.batched_qr_r(a, route=r_route)
    held = (rr, r0, r64)
    if kind == "zero-column" and r_route == "tall":
        # R of a matrix with a zero column is not unique: Householder keeps
        # the transformed row j beside its zero diagonal, the streamed
        # route leaves that row zero.  Both give R^T R = A^T A, which is
        # what the compression weights are used through.
        held = tuple(x.transpose(-1, -2) @ x for x in held)
    got, want, want64 = held
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert (got.double() - want64).abs().max().item() <= \
        1e-4 * want64.abs().max().item()
    if r_route == q_route:
        assert torch.equal(rr, r)
    qs, rs = kbq.batched_qr(a, route="general")
    _qr_close(qs, rs, q0, r0, q_cols)
    qg, rg = kbq.batched_qr(a, force_global=True)
    assert torch.equal(qg, qs) and torch.equal(rg, rs)
    planned = (q, r) if qr_plan(n, k, True, nb=b) == q_route else (qs, rs)
    assert all(torch.equal(x, y) for x, y in zip(kbq.batched_qr(a), planned))


@pytest.mark.cuda
def test_cuda_qr_strided_input(cuda):
    """A transposed view is read through its strides (4-byte copies)."""
    gen = torch.Generator().manual_seed(11)
    a = torch.randn(16, 36, 64, generator=gen).to(cuda).transpose(-1, -2)
    for want_q in (True, False):
        r0 = ref.batched_qr(a)[1]
        r = kbq.batched_qr(a)[1] if want_q else kbq.batched_qr_r(a)
        assert (r - r0).abs().max().item() <= 1e-4 * r0.abs().max().item()
    big = torch.randn(4, 36, 300, generator=gen).to(cuda).transpose(-1, -2)
    r0 = ref.batched_qr(big)[1]
    assert (kbq.batched_qr_r(big) - r0).abs().max().item() <= \
        1e-4 * r0.abs().max().item()


def _svd_input(rng, name):
    if name == "rank-deficient":
        return _rand(rng, 16, 36, 4) @ _rand(rng, 16, 4, 36)
    if name == "zero-column":
        a = _rand(rng, 16, 36, 36)
        a[:, :, 5] = 0.0
        return a
    return {"leaf": lambda: _rand(rng, 64, 36, 36),
            "inner": lambda: _rand(rng, 32, 72, 36),
            "odd-k": lambda: _rand(rng, 8, 18, 7),
            "wide": lambda: _rand(rng, 8, 4, 9),
            "wide-inner-6": lambda: _rand(rng, 64, 6, 36),
            "wide-inner-30": lambda: _rand(rng, 32, 30, 36),
            "wide-graded": lambda: np.swapaxes(
                _conditioned(rng, 4, 36, 12, 7), 1, 2),
            "graded": lambda: _conditioned(rng, 4, 24, 12, 7),
            "wide-k": lambda: _rand(rng, 4, 80, 72)}[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name,route", [
    ("leaf", None), ("leaf", "general"), ("inner", None), ("odd-k", None),
    ("wide", None), ("wide-inner-6", None), ("wide-inner-30", None),
    ("wide-graded", None), ("graded", None), ("graded", "general"),
    ("rank-deficient", None), ("zero-column", None), ("wide-k", None)])
def test_cuda_svd_matches_plain(cuda, name, route):
    """Every route (``svd_plan``; ``general`` forced at square shapes) holds
    the SVD contract against the plain sigma; the U-and-sigma-only call
    gives the same U and sigma bitwise.  The leaf's input is the strided
    ``R^T`` view, as compress passes it."""
    rng = np.random.default_rng(len(name))
    a = _svd_input(rng, name)
    at = torch.as_tensor(a).to(cuda)
    if name == "leaf":
        at = at.transpose(-1, -2).contiguous().transpose(-1, -2)
        assert not at.is_contiguous()
    u, s, vt = kbs.batched_svd(at, route=route)
    s0 = ref.batched_svd(at)[1]
    _svd_checks(a, u.cpu(), s.cpu(), vt.cpu(), s0.cpu().numpy())
    u1, s1, vt1 = kbs.batched_svd(at, route=route, want_vt=False)
    assert vt1 is None and torch.equal(u1, u) and torch.equal(s1, s)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,nv,cap", [(300, 36, 16, 130), (64, 64, 16, 40),
                                        (50, 7, 3, 17), (20, 5, 1, 9),
                                        (10, 4, 4, 0)])
def test_cuda_halo_pack_matches_plain(cuda, n, k, nv, cap):
    """Bitwise equal to ``index_select`` (a copy), with repeated padding
    indices, odd row lengths, and into an ``out=`` slice of a larger
    buffer whose other bytes stay untouched."""
    rng = np.random.default_rng(n + k + nv + cap)
    x = torch.as_tensor(_rand(rng, n, k, nv)).to(cuda)
    idx = rng.integers(0, n, cap).astype(np.int32)
    idx[cap // 2:] = 0                           # padding repeats row 0
    idx = torch.as_tensor(idx).to(cuda)
    before = khp.LAUNCHES
    got = khp.halo_pack(x, idx)
    assert khp.LAUNCHES == before + (cap > 0)
    assert torch.equal(got, ref.halo_pack(x, idx))
    flat = torch.full((cap * k * nv + 7,), -1.0, device=cuda)
    out = flat[3:3 + cap * k * nv].view(cap, k, nv)
    khp.halo_pack(x, idx, out=out)
    assert torch.equal(out, ref.halo_pack(x, idx))
    assert (flat[:3] == -1).all() and (flat[3 + cap * k * nv:] == -1).all()
