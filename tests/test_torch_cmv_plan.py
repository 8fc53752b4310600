"""PyTorch port: the route ``coupling_mv`` takes (``cmv_plan``), the
pipelined kernel's lane mapping, and -- on a CUDA card only -- every route
against the plain version.

``cmv_plan`` is a pure function of shapes and pointer alignment, so it is
checked here on the CPU: every ``coupling_mv`` launch of the main path
(N = 2^20, leaf 64, eta 0.9: coupling levels 3-14 with 36x36 blocks, the
compressed ranks, the dense leaves 64x64; nv = 16, and nv = 1) must take a
pipelined route with the intended configuration; other shapes take ``general``.
``owner_counts`` replays the kernel's index arithmetic: every output has
exactly one owner.  On the card: 1e-5 relative to the plain version (fp32
sums in another order).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import coupling_mv as kcm
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

NV = 16
COMPRESSED_RANKS = (1, 1, 1, 6, 11, 13, 15, 12, 12, 10, 8, 6, 5, 5, 3)
# (level, rows, max blocks per row) of the uncompressed coupling levels at
# N = 2^20 (the port's build_block_structure, leaf 64, eta 0.9)
LEVELS = [(3, 8, 3), (4, 16, 6), (5, 32, 9), (6, 64, 11), (7, 128, 13),
          (8, 256, 13), (9, 512, 13), (10, 1024, 13), (11, 2048, 10),
          (12, 4096, 13), (13, 8192, 10), (14, 16384, 17)]
DENSE = (16384, 64, 5)           # rows, leaf size, max dense blocks per row


# the configuration of each compressed level: the bucket of its rank,
# split down to 8-row tiles up to level 10 (fewer than SPLIT_BELOW items)
COMPRESSED_KB = {3: 8, 4: 8, 5: 8, 6: 8, 7: 8, 8: 8, 9: 8, 10: 8, 11: 8,
                 12: 8, 13: 8, 14: 4}


@pytest.mark.parametrize("level,rows,maxb", LEVELS)
def test_uncompressed_levels_take_warp16(level, rows, maxb):
    """k = 36 takes the 40-row tile; levels of 512 and 1024 rows split each
    row over three warps (16-row tiles), smaller ones over five (8 rows)."""
    kb = 40 if rows >= kcm.SPLIT_BELOW else 16 if rows >= 512 else 8
    assert kcm.cmv_plan(rows, 36, 36, NV, maxb) == ("warp16", kb, True)


@pytest.mark.parametrize("level,rank", list(enumerate(COMPRESSED_RANKS))[3:])
def test_compressed_levels_take_warp16(level, rank):
    rows, maxb = 1 << level, 13
    plan = kcm.cmv_plan(rows, rank, rank, NV, maxb)
    assert plan == ("warp16", COMPRESSED_KB[level], rank % 4 == 0)


def test_dense_leaves_take_warp16():
    rows, m, maxb = DENSE
    assert kcm.cmv_plan(rows, m, m, NV, maxb) == ("warp16", 64, True)


@pytest.mark.parametrize("k,kb", [(36, 32), (64, 32), (3, 8), (8, 8),
                                  (12, 16), (15, 16), (32, 32)])
def test_one_column_takes_warp1(k, kb):
    """k above 32 takes 32-row tiles, two warps a row."""
    assert kcm.cmv_plan(16384, k, k, 1, 17) == ("warp1", kb, k % 4 == 0)


def test_wider_nv_tiles():
    assert kcm.cmv_plan(4096, 36, 36, 32, 5) == ("warp16", 40, True)
    assert kcm.cmv_plan(64, 36, 36, 32, 5) == ("warp16", 8, True)
    assert kcm.cmv_plan(64, 12, 12, 32, 5) == ("warp16", 8, True)


def test_small_grids_split_rows():
    """Under SPLIT_BELOW items the next smaller configuration, again while
    the grid stays small, down to 8-row tiles: more row tiles, so more
    warps walk the same slots; a k <= 4 tile is never split into."""
    assert kcm.items("warp16", 40, 1535, 36, NV) < kcm.SPLIT_BELOW
    assert kcm.cmv_plan(1535, 36, 36, NV, 5).kb == 16
    assert kcm.cmv_plan(1536, 36, 36, NV, 5).kb == 40
    assert kcm.items("warp16", 16, 1535, 36, NV) == 3 * 1535
    assert kcm.cmv_plan(1535, 16, 16, NV, 5).kb == 8
    assert kcm.cmv_plan(8, 3, 3, NV, 5).kb == 4
    assert kcm.cmv_plan(8, 64, 64, 1, 5) == ("warp1", 8, True)
    assert kcm.cmv_plan(8, 36, 36, NV, 5).kb == 8
    assert kcm.cmv_plan(1024, 8, 8, NV, 5).kb == 8


@pytest.mark.parametrize("rows,k1,k2,nv,maxb", [
    (33, 130, 130, 20, 4), (64, 36, 36, 20, 5), (64, 36, 36, 8, 5),
    (64, 65, 65, 16, 5), (64, 36, 80, 16, 5), (8, 4, 4, 2, 0),
    (0, 36, 36, 16, 5), (64, 36, 36, 3, 5)])
def test_odd_shapes_take_general(rows, k1, k2, nv, maxb):
    assert kcm.cmv_plan(rows, k1, k2, nv, maxb).route == "general"


def test_rectangular_blocks_bucket_by_rows():
    assert kcm.cmv_plan(4096, 20, 36, NV, 4) == ("warp16", 40, True)
    assert kcm.cmv_plan(4096, 36, 7, NV, 4) == ("warp16", 40, False)
    assert kcm.cmv_plan(4096, 7, 36, NV, 4) == ("warp16", 8, True)


def test_misaligned_pointers_drop_vector_loads():
    assert kcm.cmv_plan(4096, 36, 36, NV, 5, aligned=False) == \
        ("warp16", 40, False)


def test_forced_routes_must_fit():
    """A route asked for by name (the card's comparisons) gets the
    configuration its own tiles give the shape; ``fits`` says which can."""
    assert kcm.cmv_plan(4096, 36, 36, NV, 5, route="warp16") == \
        ("warp16", 40, True)
    assert kcm.cmv_plan(64, 36, 36, NV, 5, route="general").route == \
        "general"
    assert kcm.fits("general", 130, 130, 20)
    assert not kcm.fits("warp1", 36, 36, NV)
    assert not kcm.fits("warp16", 36, 36, 1)
    assert not kcm.fits("warp16", 65, 65, NV)


@pytest.mark.parametrize("route,kb", sorted(kcm.FMA_TILES))
@pytest.mark.parametrize("rows", [1, 7])
def test_every_output_has_one_owner(route, kb, rows):
    """Each configuration at k1 from 1 to 64 (several row tiles where k1
    exceeds the tile), over one and two column tiles: the kernel's grid
    stores each y[r, i, v] once."""
    nvs = (1,) if route == "warp1" else (16, 32)
    for k1 in sorted({kb, max(1, kb - 3), 1, 36, 64}):
        for nv in nvs:
            plan = kcm.CmvPlan(route, kb, True)
            counts = kcm.owner_counts(plan, rows, k1, nv)
            assert counts.shape == (rows, k1, nv)
            assert (counts == 1).all(), (route, kb, k1, nv)


def test_dense_leaf_rows_take_two_warps():
    """At k1 = 64 a row's 1024 outputs are shared by two warps (row tiles
    of 32 rows), each lane holding 16 of them."""
    plan = kcm.cmv_plan(*DENSE[:2], DENSE[1], NV, DENSE[2])
    assert kcm.row_tile(plan.route, plan.kb) == 32
    assert kcm.items(plan.route, plan.kb, 1, 64, NV) == 2
    _, _, rpl, cw = kcm.FMA_TILES[(plan.route, plan.kb)]
    assert rpl * cw == 16


def test_kernel_table_matches_planner():
    """``coupling_mv_ring`` instantiates exactly ``FMA_TILES``, under the
    route codes the wrapper sends."""
    src = (Path(kcm.__file__).resolve().parent.parent / "csrc" /
           "coupling_mv.cu").read_text()
    body = src[src.index("static int coupling_mv_ring("):
               src.index('extern "C" int coupling_mv_f32')]
    parts = re.split(r"if \(route == (\d)\) \{  // (\w+)\n", body)[1:]
    pat = re.compile(r"case (\d+): return launch_ring<FmaTile<([\d, ]+)>>")
    table = {}
    for code, name, text in zip(parts[::3], parts[1::3], parts[2::3]):
        assert kcm._CODES[name] == int(code)
        for kb, args in pat.findall(text):
            table[(name, int(kb))] = tuple(int(a) for a in args.split(","))
    assert table == kcm.FMA_TILES


def test_route_counters_reset():
    assert set(kcm.ROUTE_LAUNCHES) == set(kcm.ROUTES)
    kcm.ROUTE_LAUNCHES["warp16"] += 3
    assert ops.route_launch_counts()["coupling_mv"]["warp16"] >= 3
    ops.reset_launch_counts()
    assert set(ops.route_launch_counts()["coupling_mv"].values()) == {0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _plan(rng, rows, maxb, nodes, lo=0):
    cnt = rng.integers(lo, maxb + 1, rows).astype(np.int32)
    cnt[0] = maxb
    if rows > 1:
        cnt[1] = 0
    nb = int(cnt.sum())
    used = np.arange(maxb)[None, :] < cnt[:, None]
    blk = np.full((rows, maxb), nb, np.int32)
    blk[used] = np.arange(nb, dtype=np.int32)
    col = np.zeros((rows, maxb), np.int32)
    col[used] = rng.integers(0, nodes, nb)
    return blk.reshape(-1), col.reshape(-1), cnt, nb


# (rows, maxb, k1, k2, nv) of the card test below: small grids (split
# tiles), the compressed ranks, nv = 1, two column tiles, rectangular
# blocks, odd shapes for the general route, and 2048 rows for the main
# path's tiles (k = 36: 40 rows, k = 64: two 32-row tiles)
CARD_CASES = [
    (64, 17, 36, 36, 16), (64, 5, 64, 64, 16), (64, 17, 3, 3, 16),
    (64, 13, 5, 5, 16), (64, 13, 15, 15, 16), (64, 13, 12, 12, 16),
    (64, 13, 6, 6, 16), (40, 6, 36, 36, 1), (20, 4, 64, 64, 1),
    (20, 4, 7, 7, 1), (16, 3, 36, 36, 32), (30, 4, 20, 36, 16),
    (30, 4, 36, 7, 16), (9, 2, 130, 130, 20), (9, 2, 36, 36, 20),
    (2048, 5, 64, 64, 16), (2048, 6, 36, 36, 16), (2048, 4, 36, 36, 1),
    (2048, 6, 12, 12, 16), (2048, 4, 12, 12, 1)]


def test_card_cases_reach_every_configuration():
    planned = {kcm.cmv_plan(rows, k1, k2, nv, maxb)[:2]
               for rows, maxb, k1, k2, nv in CARD_CASES}
    assert set(kcm.FMA_TILES) | {("general", None)} == planned


@pytest.mark.cuda
@pytest.mark.parametrize("rows,maxb,k1,k2,nv", CARD_CASES)
def test_cuda_routes_match_plain(cuda, rows, maxb, k1, k2, nv):
    """The planned route and every other route that fits the shape against
    the plain version;
    a sentinel inside the counted slots is skipped.  Small grids take the
    split configurations; 2048 rows take the main path's (k = 36: 40-row
    tiles, k = 64: two 32-row tiles)."""
    rng = np.random.default_rng(rows + maxb + k1 + k2 + nv)
    blk, col, cnt, nb = _plan(rng, rows, maxb, rows)
    blk[1 * maxb - 1 if maxb > 1 else 0] = nb     # a counted sentinel, row 0
    t = [torch.as_tensor(a).to(cuda) for a in (
        rng.standard_normal((nb, k1, k2)).astype(np.float32),
        rng.standard_normal((rows, k2, nv)).astype(np.float32),
        blk, col, cnt)]
    want = ref.coupling_mv(*t, maxb=maxb)
    route = kcm.cmv_plan(rows, k1, k2, nv, maxb).route
    before = dict(kcm.ROUTE_LAUNCHES)
    got = kcm.coupling_mv(*t, maxb=maxb)
    torch.cuda.synchronize()
    assert kcm.ROUTE_LAUNCHES[route] == before[route] + 1
    scale = want.abs().max().item() or 1.0
    assert (got - want).abs().max().item() <= 1e-5 * scale
    assert not got[1].any()
    for other in kcm.ROUTES:       # every other route that takes the shape
        if other != route and kcm.fits(other, k1, k2, nv):
            y = kcm.coupling_mv(*t, maxb=maxb, route=other)
            assert (y - want).abs().max().item() <= 1e-5 * scale, other


@pytest.mark.cuda
def test_cuda_unaligned_input_takes_scalar_loads(cuda):
    rng = np.random.default_rng(3)
    blk, col, cnt, nb = _plan(rng, 32, 5, 32)
    flat = torch.randn(nb * 36 * 36 + 1, device=cuda)[1:]
    s = flat.view(nb, 36, 36)
    x = torch.randn(32, 36, NV, device=cuda)
    p = [torch.as_tensor(a).to(cuda) for a in (blk, col, cnt)]
    assert not kcm.cmv_plan(32, 36, 36, NV, 5, s.data_ptr() % 16 == 0).vec
    got = kcm.coupling_mv(s, x, *p, maxb=5)
    want = ref.coupling_mv(s, x, *p, maxb=5)
    assert (got - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_forced_route_must_fit(cuda):
    z = torch.zeros(4, 36, 36, device=cuda)
    i = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="cannot take"):
        kcm.coupling_mv(z, torch.zeros(4, 36, NV, device=cuda), i, i,
                        torch.ones(4, dtype=torch.int32, device=cuda),
                        maxb=1, route="warp1")
