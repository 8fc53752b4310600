"""PyTorch port: the distributed HGEMV on a 2D block x nv rank mesh
against the JAX reference's ``make_dist_matvec(..., nv_axis="nv")``
(``tests/dist_worker.py``: ``jax.make_mesh((4, 2), ("blk", "nv"))``).

Eight spawned gloo CPU ranks form a 4 x 2 mesh (rank ``blk * 2 + nv``):
``comm.mesh_comm`` gives each its block-row ``Comm``, ``dist.mesh_slice``
its ``[n_local, nv / 2]`` slice, and the unchanged per-rank
``make_dist_matvec`` runs over the block-row group.  The parent joins the
slices (``mesh_join``) and holds them to the reference's single-device
``h2_matvec``: 1e-5 relative (fp32 sums in another order).  Each rank's
``Comm.recv_bytes`` equals ``matvec_comm_bytes`` at ``nv / 2`` for the
halo-plan mode (its exchanges are point-to-point permutes inside the
group, so this also holds ``Comm``'s group-to-world rank translation),
the merged all-to-all's bytes with ``hide_flops > 0``, and the allgather
model within the reference's 10%.

The operators are ``tests/test_torch_dist.py``'s (uniform 2D N = 1024,
leaf 16, Chebyshev 4; graded 1D, which reaches a halo radius >= 2).  JAX
is imported inside the fixture only; the ranks import this module.  One
300 s deadline covers all eight ranks, as a hung gloo group would
otherwise hang the test.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.core import dist as td
from repro_torch.core import structure as ts

torch.set_num_threads(2)

P_BLK, P_NV = 4, 2
NV = 4
RANK_TIMEOUT_S = 300
# (mode, schedule, hide_flops)
CONFIGS = (("halo-plan", "auto", 0), ("halo-plan", "auto", 1),
           ("allgather", "auto", 0), ("ppermute", "auto", 0))
GEOMETRIES = ("uniform2d", "graded1d")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _mesh_rank(rank: int, world: int, init: str, out: str, work: dict
               ) -> None:
    import torch.distributed as dist
    from repro_torch.core.comm import mesh_comm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    comm, nv = mesh_comm(P_BLK, P_NV)
    res = {"blk": comm.rank, "nv": nv, "p": comm.p}
    for geom, w in work.items():
        shape = ts.H2Shape(**w["shape"])
        data = ts.data_from_numpy(w["data"], device="cpu")
        dshape, ddata = td.partition_h2(shape, data, P_BLK, device="cpu")
        d = td.local_shard(dshape, ddata, comm.rank)
        x = td.mesh_slice(torch.as_tensor(w["x"]), dshape, rank, P_NV)
        for mode, sched, hide in CONFIGS:
            for backend in ("cuda", "torch"):
                comm.reset_counts()
                y = td.make_dist_matvec(dshape, comm, mode, backend, sched,
                                        hide)(d, x)
                res[(geom, mode, hide, backend)] = y.numpy()
                res[("bytes", geom, mode, hide, backend)] = comm.recv_bytes
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _run_mesh(work: dict, tmp) -> dict:
    world = P_BLK * P_NV
    ctx = torch.multiprocessing.get_context("spawn")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, world, init, str(tmp), work))
             for r in range(world)]
    for pr in procs:
        pr.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for pr in procs:
            pr.join(max(1.0, deadline - time.monotonic()))
    finally:
        hung = [pr for pr in procs if pr.is_alive()]
        for pr in hung:
            pr.terminate()
            pr.join()
    assert not hung, f"{len(hung)} mesh rank(s) did not finish in " \
        f"{RANK_TIMEOUT_S} s"
    codes = [pr.exitcode for pr in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    return {k: [r[k] for r in ranks] for k in ranks[0]}


@pytest.fixture(scope="module")
def reference():
    import jax.numpy as jnp
    from repro.core.clustering import regular_grid_points
    from repro.core.construction import construct_h2
    from repro.core.kernels_fn import exponential_kernel
    from repro.core.matvec import h2_matvec
    from test_torch_structure import jax_data_to_numpy

    n1 = 1024
    built = {
        "uniform2d": construct_h2(regular_grid_points(32, 2),
                                  exponential_kernel(0.1), leaf_size=16,
                                  cheb_p=4, eta=0.9),
        "graded1d": construct_h2((((np.arange(n1) + 0.5) / n1) ** 8)[:, None],
                                 exponential_kernel(0.2), leaf_size=8,
                                 cheb_p=6, eta=0.9)}
    rng = np.random.default_rng(0)
    out = {}
    for geom, (shape, data, _, _) in built.items():
        x = rng.standard_normal((shape.n, NV)).astype(np.float32)
        out[geom] = dict(shape=shape, arrays=jax_data_to_numpy(data), x=x,
                         y=np.asarray(h2_matvec(shape, data,
                                                jnp.asarray(x))))
    return out


@pytest.fixture(scope="module")
def mesh(reference, tmp_path_factory):
    work = {geom: dict(shape=dataclasses.asdict(r["shape"]), data=r["arrays"],
                       x=r["x"])
            for geom, r in reference.items()}
    return _run_mesh(work, tmp_path_factory.mktemp("mesh"))


def _dshape(reference, geom):
    r = reference[geom]
    return td.partition_h2(ts.H2Shape(**dataclasses.asdict(r["shape"])),
                           ts.data_from_numpy(r["arrays"], device="cpu"),
                           P_BLK, device="cpu")[0]


def test_mesh_layout(mesh):
    """Rank ``blk * p_nv + nv``; each block-row group has ``p_blk`` ranks."""
    assert mesh["blk"] == [r // P_NV for r in range(P_BLK * P_NV)]
    assert mesh["nv"] == [r % P_NV for r in range(P_BLK * P_NV)]
    assert mesh["p"] == [P_BLK] * (P_BLK * P_NV)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c[0]}-{c[2]}")
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_mesh_matvec_matches_reference(mesh, reference, geom, cfg, backend):
    mode, _, hide = cfg
    y = td.mesh_join([torch.as_tensor(a) for a in
                      mesh[(geom, mode, hide, backend)]], P_NV).numpy()
    want = reference[geom]["y"]
    assert y.shape == want.shape and np.isfinite(y).all()
    assert _rel(y, want) <= 1e-5, _rel(y, want)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_mesh_bytes_against_model(mesh, reference, geom):
    dshape = _dshape(reference, geom)
    w = NV // P_NV

    def counted(mode, hide=0):
        return mesh[("bytes", geom, mode, hide, "cuda")]

    assert counted("halo-plan") == \
        [td.matvec_comm_bytes(dshape, w, "halo-plan")] * (P_BLK * P_NV)
    root = (P_BLK - 1) * dshape.ranks[dshape.lc] * w * 4
    assert counted("halo-plan", 1) == \
        [root + td.merged_exchange_bytes(dshape, w)] * (P_BLK * P_NV)
    ag = td.matvec_comm_bytes(dshape, w, "allgather")
    assert all(abs(b - ag) <= 0.1 * ag for b in counted("allgather"))


def test_mesh_slice_round_trip():
    dshape = td.DistH2Shape(n=64, leaf_size=4, depth=4, ranks=(1,) * 5,
                            p=4, lc=2, br_counts=(), br_radius=(),
                            top_counts=(), dense_count=0, dense_radius=0,
                            row_maxb=())
    x = torch.arange(64 * 6, dtype=torch.float32).reshape(64, 6)
    parts = [td.mesh_slice(x, dshape, r, 3) for r in range(12)]
    assert parts[5].shape == (16, 2)
    assert torch.equal(parts[5], x[16:32, 4:6])
    assert torch.equal(td.mesh_join(parts, 3), x)
    with pytest.raises(ValueError):
        td.mesh_slice(x, dshape, 0, 4)
