"""PyTorch port: the routes ``batched_svd`` and ``batched_qr`` take
(``svd_plan`` / ``qr_plan``), checked on the CPU at every shape one
main-path ``compress(tol=1e-3)`` launches.

The planners are pure functions of the shape, the V^T / Q request and the
shared memory a block has, so no card is needed.  The main path is the
paper's 2D set at N = 2^20 (leaf 64, Chebyshev ranks 36, depth 14) with
the ranks its compress picks (``COMPRESSED_RANKS``) and the coupling rows
per level (``ROW_MAXB``, levels 3-14; levels 1-2 hold no coupling block).
"""
import pytest
import torch

from repro_torch.kernels import batched_qr as kbq
from repro_torch.kernels import batched_svd as kbs
from repro_torch.kernels import coupling_mv as kcm
from repro_torch.kernels import ops

K = 36
DEPTH = 14
LEAF = 64
COMPRESSED_RANKS = (1, 1, 1, 6, 11, 13, 15, 12, 12, 10, 8, 6, 5, 5, 3)
ROW_MAXB = {l: m for l, m in zip(range(3, DEPTH + 1),
                                 (3, 8, 7, 13, 7, 13, 10, 13, 10, 13, 10, 17))}


def _weights_stacks():
    """(level, rows) of each weights stack ``[2^l, 36 + maxb*36, 36]``."""
    return [(l, K + ROW_MAXB.get(l, 0) * K) for l in range(1, DEPTH + 1)]


def _inner_svds():
    """(level, rows) of each inner SVD ``[2^(l-1), 2 r_l, 36]``."""
    return [(l, 2 * COMPRESSED_RANKS[l]) for l in range(1, DEPTH + 1)]


def test_leaf_svd_takes_the_warp_route_without_v():
    assert kbs.svd_plan(K, K, want_vt=False) == "warp"
    assert kbs.svd_plan(K, K, want_vt=True) == "warp"
    assert kbs.warp_bytes(K, K, False) < kbs.warp_bytes(K, K, True)


@pytest.mark.parametrize("level,rows", _inner_svds())
def test_inner_svds_take_the_transposed_route(level, rows):
    """Every inner SVD of the tolerance sweep is a wide panel (2 r_l < 36
    rows): Jacobi on its transpose, whatever V^T request."""
    assert rows < K
    for want_vt in (False, True):
        assert kbs.svd_plan(rows, K, want_vt) == "warp_t"


@pytest.mark.parametrize("n,k,want", [
    (72, 36, "warp"), (18, 7, "warp"), (4, 9, "warp_t"), (256, 64, "warp"),
    (257, 36, "general"), (36, 72, "warp_t"), (36, 300, "general"),
    (80, 72, "general"),
    (72, 66, "general"), (1, 1, "warp"), (1, 64, "warp_t"),
    (2, 65, "warp_t"), (65, 2, "warp")])
def test_svd_plan_edges(n, k, want):
    """Up to 64 Jacobi columns (the shorter side, padded to even) of at
    most 256 rows take a warp route; everything else the general kernel."""
    assert kbs.svd_plan(n, k) == want


def test_svd_plan_respects_shared_memory():
    need = kbs.warp_bytes(K, K, True)
    assert kbs.svd_plan(K, K, True, smem_limit=need) == "warp"
    assert kbs.svd_plan(K, K, True, smem_limit=need - 4) == "general"


@pytest.mark.parametrize("what,n,want_q", [
    ("leaf", LEAF, True), ("transfer stack", 2 * K, True),
    ("leaf SVD polish", K, True)]
    + [(f"polish l={l}", r, True) for l, r in _inner_svds()])
def test_short_panels_take_the_warp_route(what, n, want_q):
    """Orthogonalization's leaf and stacked transfers and the SVD polishes
    ([., 2r, 2r] where a square inner SVD polishes its U): one warp per
    matrix, Q and R."""
    k = n if what.startswith("polish") else K
    assert kbq.qr_plan(n, k, want_q) == "warp"
    assert kbq.qr_plan(n, k, False) == "warp"
    assert kbq.qr_plan(n, k, want_q, nb=1 << DEPTH) == "warp"


@pytest.mark.parametrize("level", range(1, DEPTH + 1))
def test_transfer_stacks_route(level):
    """Orthogonalization stacks [2^(l-1), 72, 36]: the warp route from
    ``MIN_BATCH`` matrices on, the general kernel for the small top levels."""
    nb = 1 << (level - 1)
    want = "warp" if nb >= kbq.MIN_BATCH else "general"
    assert kbq.qr_plan(2 * K, K, True, nb=nb) == want


@pytest.mark.parametrize("level,rows", _weights_stacks())
def test_weights_stacks_route(level, rows):
    """R only: stacks of more than 128 rows stream through the tall route
    (ragged chunks included), the short top levels take the warp route;
    batches under ``MIN_BATCH`` (levels < 9) the general kernel."""
    want = "tall" if rows > kbq.WARP_MAX_ROWS else "warp"
    assert kbq.qr_plan(rows, K, want_q=False) == want
    nb = 1 << level
    assert kbq.qr_plan(rows, K, False, nb=nb) == \
        (want if nb >= kbq.MIN_BATCH else "general")


def test_weights_stacks_include_ragged_chunks():
    rows = {r for _, r in _weights_stacks()}
    assert {396, 504, 288, 324, 648} <= rows
    assert any(r % kbq.TALL_CHUNK for r in rows)


@pytest.mark.parametrize("n,k,want_q,want", [
    (1152, 64, True, "general"), (1152, 64, False, "tall"),
    (1152, 72, False, "general"), (64, 72, True, "general"),
    (648, 36, True, "general"), (129, 36, True, "general"),
    (128, 64, True, "warp"), (8, 36, True, "warp"), (9, 1, True, "warp"),
    (40, 64, False, "warp"), (130, 65, False, "general")])
def test_qr_plan_edges(n, k, want_q, want):
    """Shapes outside the new routes (Q of more than 128 rows, more than 64
    columns) take the general kernel, as do small batches."""
    assert kbq.qr_plan(n, k, want_q) == want
    assert kbq.qr_plan(n, k, want_q, nb=kbq.MIN_BATCH) == want
    assert kbq.qr_plan(n, k, want_q, nb=kbq.MIN_BATCH - 1) == "general"


def test_qr_plan_respects_shared_memory():
    assert kbq.qr_plan(648, K, False, smem_limit=kbq.tall_bytes(K)) == "tall"
    assert kbq.qr_plan(648, K, False,
                       smem_limit=kbq.tall_bytes(K) - 4) == "general"
    need = kbq.warp_bytes(LEAF, K, True)
    assert kbq.qr_plan(LEAF, K, True, smem_limit=need - 4) == "general"


def test_tall_route_shared_memory_is_small():
    """The tall route holds two 32-row chunks and R per matrix: ~15 KB for
    the [648, 36] weights stack instead of its 93 KB."""
    assert kbq.tall_bytes(K) == 4 * (2 * 36 * K + K * K)
    assert kbq.tall_bytes(K) < 648 * K * 4 / 5


def test_route_launch_counts_reset():
    ops.reset_launch_counts()
    counts = ops.route_launch_counts()
    assert counts == {"batched_qr": dict.fromkeys(kbq.ROUTES, 0),
                      "batched_svd": dict.fromkeys(kbs.ROUTES, 0),
                      "coupling_mv": dict.fromkeys(kcm.ROUTES, 0)}


def test_plain_svd_ignores_want_vt():
    a = torch.randn(3, 6, 36, generator=torch.Generator().manual_seed(0))
    full = ops.backend_svd(a, "cuda")
    short = ops.backend_svd(a, "cuda", want_vt=False)
    for x, y in zip(full, short):
        assert torch.equal(x, y)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(36, 36), (72, 36), (6, 36), (30, 36),
                                 (4, 9), (18, 7), (64, 36), (256, 64),
                                 (1, 64), (648, 36)])
def test_cuda_planner_bytes_match_the_kernels(cuda, n, k):
    """The planners' shared-memory counts are the kernels' own."""
    from repro_torch.kernels import _build
    svd = _build.load("batched_svd", kbs._SIGNATURES)
    qr = _build.load("batched_qr", kbq._SIGNATURES)
    for want in (False, True):
        assert 4 * svd.batched_svd_warp_floats(n, k, int(want)) == \
            kbs.warp_bytes(n, k, want)
        assert 4 * qr.batched_qr_warp_floats(n, k, int(want)) == \
            kbq.warp_bytes(n, k, want)
    assert 4 * qr.batched_qr_tall_floats(k) == kbq.tall_bytes(k)


@pytest.mark.parametrize("per_warp,want", [(15552, 2), (19008, 4),
                                           (21312, 2), (5472, 4),
                                           (120000, 1)])
def test_warps_per_block_keeps_the_most_warps_resident(per_warp, want):
    """The tall route's ~15 KB per matrix: 2 warps a block keep 14 resident
    on an SM (4 would keep 12)."""
    from repro_torch.kernels import _build
    assert _build.warps_per_block(per_warp, kbq.SMEM_LIMIT) == want
