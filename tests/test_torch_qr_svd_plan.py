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
    assert svd.batched_svd_smem_bytes(n, k) == kbs.general_bytes(n, k)


@pytest.mark.parametrize("per_warp,want", [(15552, 2), (19008, 4),
                                           (21312, 2), (5472, 4),
                                           (120000, 1)])
def test_warps_per_block_keeps_the_most_warps_resident(per_warp, want):
    """The tall route's ~15 KB per matrix: 2 warps a block keep 14 resident
    on an SM (4 would keep 12)."""
    from repro_torch.kernels import _build
    assert _build.warps_per_block(per_warp, kbq.SMEM_LIMIT) == want


# ---------------------------------------------------------------------------
# the sketch construction's QR and SVD launches (repro_torch.sketch)
# ---------------------------------------------------------------------------

SKETCH_BUDGETS = (26, 52, 74)     # 16 + 10, doubled, capped at 64 + 10


def sketch_launches(depth: int, leaf: int, levels, budgets, ranks) -> list:
    """Every QR and SVD launch of one sketch construction, as
    ``(kind, nb, n, k)``: the spectra of each round's sketches (``qr_r``,
    then ``svals``: sigma only, no polish), then the rangefinder's bases
    at the last budget (``qr``, ``qr_r`` of a wide R factor's transpose,
    ``svd``: U wanted).  ``levels``: the coupling levels; ``ranks``: the
    picked rank per level."""
    out = []
    n = leaf << depth
    for r in budgets:
        for l in levels:
            w = n >> l
            out += [("qr_r", 1 << l, w, r), ("svals", 1 << l, min(w, r), r)]
    r = budgets[-1]
    col_end, acc = [], 0
    for l in range(depth + 1):
        acc += r if l in levels else 0
        col_end.append(acc)

    def basis(nb, rows, cols):
        p = min(rows, cols)
        out.append(("qr", nb, rows, cols))
        if p < cols:
            out.append(("qr_r", nb, cols, p))
        out.append(("svd", nb, p, p))

    basis(1 << depth, leaf, col_end[depth])
    for l in range(depth, 0, -1):
        if col_end[l - 1] == 0:
            break
        basis(1 << (l - 1), 2 * ranks[l], col_end[l - 1])
    return out


def _route_fits(kind: str, nb: int, n: int, k: int) -> str:
    """The route the wrapper takes for one launch; asserts that its shared
    memory fits a block (the general QR keeps a global scratch copy when
    the matrix does not fit, so it always launches)."""
    if kind in ("qr", "qr_r"):
        route = kbq.qr_plan(n, k, kind == "qr", nb=nb)
        if route == "warp":
            assert kbq.warp_bytes(n, k, kind == "qr") <= kbq.SMEM_LIMIT
        elif route == "tall":
            assert kbq.tall_bytes(k) <= kbq.SMEM_LIMIT
        return route
    route = kbs.svd_plan(n, k, want_vt=False)
    if route == "general":
        assert kbs.general_bytes(n, k) <= kbs.SMEM_LIMIT, (n, k)
    else:
        assert kbs.warp_bytes(n, k, False) <= kbs.SMEM_LIMIT
    if kind == "svd" and route != "warp_t":      # U is polished by a QR
        _route_fits("qr", nb, n, min(n, k))
    return route


def _record_sketch_launches(monkeypatch, fn):
    """Run ``fn`` with the QR and SVD dispatch recording each launch."""
    from repro_torch.kernels import ops as kops
    seen, depth = [], [0]

    def wrap(kind, real):
        def rec(a, backend="cuda", **kw):
            if not depth[0]:
                k = ("svals" if not kw.get("polish", True) else "svd") \
                    if kind == "svd" else kind
                seen.append((k,) + tuple(a.shape))
            depth[0] += 1
            try:
                return real(a, backend, **kw)
            finally:
                depth[0] -= 1
        return rec

    for kind, name in (("qr", "backend_qr"), ("qr_r", "backend_qr_r"),
                       ("svd", "backend_svd")):
        monkeypatch.setattr(kops, name, wrap(kind, getattr(kops, name)))
    out = fn()
    return seen, out


@pytest.mark.parametrize("side,leaf,n0", [(16, 16, None), (32, 16, 6),
                                          (64, 64, None)])
def test_sketch_launch_model_matches_a_construction(monkeypatch, side, leaf,
                                                    n0):
    """A CPU construction issues exactly the modelled launches, and each
    maps to a route that fits."""
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.kernels_fn import exponential_kernel
    from repro_torch.sketch import construct as tcon
    from repro_torch.sketch import rng
    budgets = []
    real = rng.level_gaussians

    def draw(seed, level, n_nodes, rows, cols, *a, **kw):
        if not budgets or budgets[-1] != cols:
            budgets.append(cols)
        return real(seed, level, n_nodes, rows, cols, *a, **kw)

    monkeypatch.setattr(rng, "level_gaussians", draw)
    seen, (shape, _, _, bs) = _record_sketch_launches(
        monkeypatch, lambda: tcon.sketch_construct(
            regular_grid_points(side, 2), exponential_kernel(0.1), leaf,
            0.9, tol=1e-4, max_rank=48, n_samples0=n0, device="cpu"))
    levels = [l for l, c in enumerate(bs.coupling_counts()) if c]
    want = sketch_launches(shape.depth, leaf, levels, budgets, shape.ranks)
    assert seen == want
    for launch in seen:
        assert _route_fits(*launch) in kbq.ROUTES + kbs.ROUTES


def _k512_structure():
    from repro_torch.apps.fractional import interior_grid
    from repro_torch.core.admissibility import build_block_structure
    from repro_torch.core.clustering import build_cluster_tree
    tree = build_cluster_tree(interior_grid(512), 64)
    return tree, build_block_structure(tree, 0.9)


def _k512_levels():
    tree, bs = _k512_structure()
    return tree.depth, [l for l, c in enumerate(bs.coupling_counts()) if c]


def test_k512_sampling_pass_entries():
    """The kernel entries one sampling pass of K at n = 512 evaluates (every
    admissible block's w^2 entries): the count the sketch's time is read
    against."""
    tree, bs = _k512_structure()
    per_level = [len(bs.s_rows[l]) * (tree.n >> l) ** 2
                 for l in range(tree.depth + 1)]
    assert sum(per_level) == 68_636_639_232
    assert per_level[3] == 17_179_869_184 and per_level[4] == 24_696_061_952


@pytest.mark.parametrize("k", [1, 8, 26, 36, 52, 64])
@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_sketch_launches_at_n512_fit(k, rounds):
    """K of the §6.4 problem at n = 512 (N = 262,144, leaf 64, depth 12,
    coupling levels 3-12), every budget sequence the adaptive sampler can
    draw and ranks up to max_rank = 64 at every level: no launch raises,
    and the wide leaf R factor [64, 10 r] goes through its transpose."""
    depth, levels = _k512_levels()
    assert depth == 12 and levels == list(range(3, 13))
    launches = sketch_launches(depth, 64, levels, SKETCH_BUDGETS[:rounds],
                               [k] * (depth + 1))
    r = SKETCH_BUDGETS[rounds - 1]
    assert ("qr", 4096, 64, 10 * r) in launches
    assert ("qr_r", 4096, 10 * r, 64) in launches
    assert ("svd", 4096, 64, 64) in launches
    routes = {_route_fits(*launch) for launch in launches}
    assert routes <= set(kbq.ROUTES + kbs.ROUTES)


def test_wide_leaf_r_would_not_fit_the_svd_kernel():
    """The trap the composition avoids: the leaf R factor [64, 740] as one
    SVD needs more shared memory than a block has."""
    assert kbs.svd_plan(64, 740, want_vt=False) == "general"
    assert kbs.general_bytes(64, 740) > kbs.SMEM_LIMIT
    assert kbs.general_bytes(128, 128) <= kbs.SMEM_LIMIT
