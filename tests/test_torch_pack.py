"""PyTorch port: the segmented send-row pack (``halo_pack`` over a table of
segments, one launch per exchange) against the JAX reference, and the
segment table of the distributed HGEMV's exchange against its payload
layouts.

- The plain segmented pack (``ops.halo_pack_segments`` on the CPU) against
  the Pallas ``repro.kernels.halo_pack`` in interpret mode, segment by
  segment: bitwise (a gather), with repeated and padding indices, rows of
  [36, 16], [64, 16], [7, 3] and [5, 1], and an empty segment; in the bf16
  mode bitwise equal to packing then ``.to(torch.bfloat16)``.
- ``dist._hp_pack_table`` against ``_hp_payload_layout`` /
  ``_hp_merged_layout``, per offset and merged, at p = 2 and 4, on the two
  geometries of ``tests/test_torch_dist.py`` (uniform 2D, N = 1024, leaf
  16, Chebyshev 4; graded 1D, leaf 8, Chebyshev 6).
- On a CUDA card only: the kernel against the plain pack, f32 and bf16,
  into an unaligned slice whose neighbours stay untouched.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.core import dist as td
from repro_torch.kernels import halo_pack as khp
from repro_torch.kernels import ops

torch.set_num_threads(2)

# (n, k, nv, cap): rows of [36,16], [64,16], [7,3], [5,1], and an empty one
SEGMENTS = [(300, 36, 16, 40), (64, 64, 16, 23), (50, 7, 3, 17),
            (20, 5, 1, 9), (10, 36, 16, 0)]


def _sources_and_plan(rng, gap=3, bf16=False, specs=SEGMENTS):
    """Sources, index lists and a plan packing them ``gap`` elements apart
    into one flat buffer (the gaps must stay untouched)."""
    srcs, segs, off = [], [], gap
    for j, (n, k, nv, cap) in enumerate(specs):
        srcs.append(rng.standard_normal((n, k, nv)).astype(np.float32))
        idx = rng.integers(0, n, cap).astype(np.int32)
        idx[cap // 2:] = 0                    # padding repeats row 0
        idx[:min(cap, 3)] = n - 1             # a repeated row
        segs.append(khp.Segment(j, torch.as_tensor(idx), off, k * nv))
        off += cap * k * nv + gap
    return srcs, khp.PackPlan(segs, bf16=bf16), off


def test_plain_segmented_pack_matches_pallas():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(0)
    srcs, plan, size = _sources_and_plan(rng)
    before = ops.launch_counts()
    for backend in ops.BACKENDS:
        dst = torch.full((size,), -7.0)
        got = ops.halo_pack_segments(
            plan, [torch.as_tensor(s) for s in srcs], dst, backend)
        assert got is dst
        covered = np.zeros(size, bool)
        for s, x in zip(plan.segments, srcs):
            cap = s.idx.shape[0]
            piece = dst[s.off:s.off + cap * s.row].numpy()
            want = np.asarray(jops.halo_pack(jnp.asarray(x),
                                             jnp.asarray(s.idx.numpy()))
                              ).reshape(-1) if cap else np.zeros(0)
            assert np.array_equal(piece, want)
            covered[s.off:s.off + cap * s.row] = True
        assert (dst.numpy()[~covered] == -7.0).all()
    assert ops.launch_counts() == before          # no kernel on the CPU


def test_plain_segmented_pack_bf16_is_pack_then_cast():
    rng = np.random.default_rng(1)
    srcs, plan, size = _sources_and_plan(rng, bf16=True)
    ts = [torch.as_tensor(s) for s in srcs]
    dst = torch.full((size,), -7.0, dtype=torch.bfloat16)
    ops.halo_pack_segments(plan, ts, dst, "torch")
    for s, x in zip(plan.segments, ts):
        cap = s.idx.shape[0]
        want = x.index_select(0, s.idx).to(torch.bfloat16).reshape(-1)
        assert torch.equal(dst[s.off:s.off + cap * s.row], want)


def test_pack_plan_tables():
    """The kernel's parameter tables (built on the host, no card needed):
    empty segments dropped, the row prefix, offsets and a split at
    ``MAX_SEGMENTS``."""
    assert ctypes.sizeof(khp._Table) == \
        16 + 8 + 8 * khp.MAX_SOURCES + 32 * khp.MAX_SEGMENTS
    assert ctypes.sizeof(khp._Table) < 4096       # any CUDA's param limit
    rng = np.random.default_rng(2)
    srcs, plan, _ = _sources_and_plan(rng)
    assert plan.launches == 1
    ((t, addr),) = plan.tables()
    assert addr == ctypes.addressof(t) and t.nsrc == len(srcs)
    live = [s for s in plan.segments if s.idx.shape[0]]
    assert t.nseg == len(live) and t.rows == sum(s.idx.shape[0] for s in live)
    first = 0
    for j, s in enumerate(live):
        e = t.seg[j]
        assert (e.idx, e.dst_off, e.src, e.cap, e.row, e.first) == \
            (s.idx.data_ptr(), s.off, s.src, s.idx.shape[0], s.row, first)
        first += s.idx.shape[0]
    many = [khp.Segment(0, torch.zeros(2, dtype=torch.int32), 8 * j, 4)
            for j in range(2 * khp.MAX_SEGMENTS + 5)]
    big = khp.PackPlan(many)
    assert big.launches == 3 == math.ceil(len(many) / khp.MAX_SEGMENTS)
    assert [t.nseg for t, _ in big.tables()] == \
        [khp.MAX_SEGMENTS] * 2 + [5]
    assert all(t.rows == 2 * t.nseg for t, _ in big.tables())
    with pytest.raises(ValueError, match="sources"):
        khp.PackPlan([khp.Segment(khp.MAX_SOURCES, many[0].idx, 0, 4)])


# ---------------------------------------------------------------------------
# the distributed HGEMV's exchange table
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["uniform2d", "graded1d"])
def port_operator(request):
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    if request.param == "uniform2d":
        shape, data, _, _ = construct_h2(regular_grid_points(32, 2),
                                         exponential_kernel(0.1), 16, 4, 0.9,
                                         device="cpu")
    else:
        n = 1024
        pts = (((np.arange(n) + 0.5) / n) ** 8)[:, None]
        shape, data, _, _ = construct_h2(pts, exponential_kernel(0.2), 8, 6,
                                         0.9, device="cpu")
    return shape, data


@pytest.mark.parametrize("merged", [False, True], ids=["per-offset",
                                                       "merged"])
@pytest.mark.parametrize("p", [2, 4])
def test_exchange_table_matches_payload_layout(port_operator, p, merged):
    shape, data = port_operator
    nv = 4
    dshape, ddata = td.partition_h2(shape, data, p, device="cpu")
    seg, tot = td._hp_payload_layout(dshape, nv)
    assert tot                                    # the levels do exchange
    lc, depth = dshape.lc, dshape.depth
    for rank in range(p):
        d = td.local_shard(dshape, ddata, rank)
        hp = td._hp_pack_table(dshape, d, nv, rank, merged, bf16=False)
        if merged:
            capmax, pos = td._hp_merged_layout(tot, p)
            assert hp.shape == (p, capmax) and hp.pos == pos
            base = {dl: ((rank - r) % p) * capmax + lo
                    for dl, (r, lo) in pos.items()}
        else:
            assert hp.pos is None and hp.shape == (sum(tot.values()),)
            end = 0                  # the payloads lie end to end
            for lo, n in sorted(hp.dest.values()):
                assert lo == end
                end += n
            assert end == hp.shape[0]
            base = {dl: lo for dl, (lo, _) in hp.dest.items()}
        assert hp.dest == {dl: (base[dl], n) for dl, n in tot.items()}
        # one segment per (key, offset), in the layout's order
        want = []
        levels = [l for l in range(lc + 1, depth + 1)
                  if dshape.ranks[l] and dshape.br_offsets[l - lc]]
        assert hp.levels == tuple(levels)
        for slot, l in enumerate(levels):
            for j, dl in enumerate(dshape.br_offsets[l - lc]):
                want.append((slot, d.hp_br[l - lc].send[j],
                             base[dl] + seg[(l, dl)][0],
                             dshape.ranks[l] * nv, seg[(l, dl)][1]))
        for j, dl in enumerate(dshape.dense_offsets):
            want.append((len(levels), d.hp_dense.send[j],
                         base[dl] + seg[(depth + 1, dl)][0],
                         dshape.leaf_size * nv, seg[(depth + 1, dl)][1]))
        assert len(hp.pack.segments) == len(want)
        for s, (slot, idx, off, row, size) in zip(hp.pack.segments, want):
            assert (s.src, s.off, s.row) == (slot, off, row)
            assert s.idx is idx and s.idx.shape[0] * row == size



def test_exchange_table_cache_follows_the_rank_data(port_operator):
    """A matvec's tables: one per (rank data, nv), built once, and dropped
    with the rank data (a table holds views of the data's plans)."""
    import gc
    shape, data = port_operator
    dshape, ddata = td.partition_h2(shape, data, 2, device="cpu")
    d = td.local_shard(dshape, ddata, 1)
    tables = {}
    first = td._hp_pack_table_for(tables, dshape, d, 4, 1, False, False)
    assert td._hp_pack_table_for(tables, dshape, d, 4, 1, False, False) \
        is first
    assert td._hp_pack_table_for(tables, dshape, d, 1, 1, False, False) \
        is not first
    assert list(tables) == [id(d)] and sorted(tables[id(d)]) == [1, 4]
    del d
    gc.collect()
    assert tables == {}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("p", [2, 4])
def test_exchange_pack_equals_per_offset_route(port_operator, p, bf16):
    """Packing through the table writes each (level, offset) slice exactly
    as the former route did: ``index_select`` of the level's rows into the
    payload slice (cast to bf16 after the pack in the bf16 mode)."""
    shape, data = port_operator
    nv = 4
    dshape, ddata = td.partition_h2(shape, data, p, device="cpu")
    seg, _ = td._hp_payload_layout(dshape, nv)
    rng = np.random.default_rng(p)
    lc, depth = dshape.lc, dshape.depth
    dtype = torch.bfloat16 if bf16 else torch.float32
    for rank in range(p):
        d = td.local_shard(dshape, ddata, rank)
        hp = td._hp_pack_table(dshape, d, nv, rank, False, bf16)
        xs = {l: torch.as_tensor(rng.standard_normal(
            (dshape.nodes_local(l), dshape.ranks[l], nv)).astype(np.float32))
            for l in hp.levels}
        xs[depth + 1] = torch.as_tensor(rng.standard_normal(
            (dshape.leaves_per_dev, dshape.leaf_size, nv)).astype(np.float32))
        buf = torch.empty(hp.shape, dtype=dtype)
        ops.halo_pack_segments(hp.pack, [xs[l] for l in hp.levels] +
                               [xs[depth + 1]], buf, "torch")
        keys = [(l, dshape.br_offsets[l - lc], d.hp_br[l - lc])
                for l in hp.levels]
        keys.append((depth + 1, dshape.dense_offsets, d.hp_dense))
        for key, offsets, plan in keys:
            for dl, idx in zip(offsets, plan.send):
                lo, sz = seg[(key, dl)]
                start = hp.dest[dl][0] + lo
                want = xs[key].index_select(0, idx).to(dtype).reshape(-1)
                assert torch.equal(buf[start:start + sz], want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("gap", [4, 3], ids=["aligned", "unaligned"])
def test_cuda_segmented_pack_matches_plain(cuda, bf16, gap):
    rng = np.random.default_rng(gap)
    srcs, plan, size = _sources_and_plan(rng, gap=gap, bf16=bf16)
    ts = [torch.as_tensor(s).to(cuda) for s in srcs]
    cplan = khp.PackPlan([s._replace(idx=s.idx.to(cuda))
                          for s in plan.segments], bf16=bf16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    want = torch.full((size,), -7.0, dtype=dtype, device=cuda)
    ops.halo_pack_segments(cplan, ts, want, "torch")
    got = torch.full((size,), -7.0, dtype=dtype, device=cuda)
    before = khp.LAUNCHES
    ops.halo_pack_segments(cplan, ts, got, "cuda")
    torch.cuda.synchronize()
    assert khp.LAUNCHES == before + 1
    assert torch.equal(got, want)            # gaps untouched on both sides


@pytest.mark.cuda
def test_cuda_segmented_pack_splits_large_tables(cuda):
    n_seg = 2 * khp.MAX_SEGMENTS + 7
    x = torch.randn(50, 36, 16, device=cuda)
    segs = [khp.Segment(0, torch.randint(0, 50, (5,), dtype=torch.int32,
                                         device=cuda), j * 5 * 576, 576)
            for j in range(n_seg)]
    plan = khp.PackPlan(segs)
    got = torch.empty(plan.numel, device=cuda)
    before = khp.LAUNCHES
    ops.halo_pack_segments(plan, [x], got, "cuda")
    assert khp.LAUNCHES == before + 3 == before + plan.launches
    want = ops.halo_pack_segments(plan, [x], torch.empty_like(got), "torch")
    assert torch.equal(got, want)
