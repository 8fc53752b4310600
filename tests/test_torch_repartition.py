"""PyTorch port: ``core.repartition`` (``unpartition_h2``,
``repartition_h2``) against the reference's, on the operators of
``tests/dist_worker.py:repartition_checks`` (uniform 2D, N = 1024, leaf
16, Chebyshev 4; graded 1D ``((i+0.5)/n)^8``, leaf 8, Chebyshev 6),
carried to the port bitwise.

- ``unpartition_h2`` of the p = 8 partition reproduces the single-device
  operator's HGEMV bitwise (and its ``H2Shape``);
- ``repartition_h2`` from p = 8 to p' = 4 and 2 equals a fresh port
  ``partition_h2`` at p' bitwise (shape and every array), and equals the
  reference's ``repartition_h2`` of the reference's partition (the same
  numpy inputs);
- the p' comm model keeps the volume ordering (0 < halo-plan < allgather)
  and moves no more halo-plan bytes than p = 8;
- the value buffers of the result are new tensors (the source, which the
  elastic solve may share between processes, is never aliased), and a
  symmetric operator keeps one basis tree;
- in spawned gloo groups of p' = 4 and 2 CPU ranks, each rank re-shards
  the p = 8 partition itself, as the elastic solve's survivors do, and its
  halo-plan HGEMV rows are within 1e-5 of the reference's single-device
  product.

JAX is imported inside the fixture only (the spawned ranks import this
module).
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.core import dist as td
from repro_torch.core import structure as ts
from repro_torch.core.repartition import repartition_h2, unpartition_h2

torch.set_num_threads(2)

GEOMETRIES = ("uniform2d", "graded1d")
P_NEW = (4, 2)
NV = 4
RANK_TIMEOUT_S = 120


def _flat(ddata) -> dict:
    from test_torch_dist import _flat_dist
    return _flat_dist(ddata)


@pytest.fixture(scope="module")
def reference():
    """Per geometry: the reference's operator carried to the port (shape,
    numpy arrays), x, its single-device product, and its p = 8, 4, 2
    partitions and repartitions from p = 8."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import dist as rdist
    from repro.core.clustering import regular_grid_points
    from repro.core.construction import construct_h2
    from repro.core.kernels_fn import exponential_kernel
    from repro.core.matvec import h2_matvec
    from repro.core.repartition import repartition_h2 as ref_repartition
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
        d8 = rdist.partition_h2(shape, data, 8)
        out[geom] = dict(
            shape=dataclasses.asdict(shape),
            arrays={k: np.asarray(v)
                    for k, v in jax_data_to_numpy(data).items()},
            x=x, y=np.asarray(h2_matvec(shape, data, jnp.asarray(x))),
            ref_rep={p: _flat(ref_repartition(*d8, p)[1]) for p in P_NEW},
            ref_rep_shape={p: dataclasses.asdict(ref_repartition(*d8, p)[0])
                           for p in P_NEW})
    return out


def _port(ref, geom):
    r = ref[geom]
    shape = ts.H2Shape(**r["shape"])
    data = ts.data_from_numpy(r["arrays"], device="cpu")
    return shape, data, td.partition_h2(shape, data, 8, device="cpu")


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_unpartition_reproduces_single_device(reference, geom):
    from repro_torch.core.matvec import h2_matvec
    shape, data, d8 = _port(reference, geom)
    x = torch.as_tensor(reference[geom]["x"])
    su, du = unpartition_h2(*d8)
    assert su == shape
    for backend in ("torch", "cuda"):
        assert torch.equal(h2_matvec(su, du, x, backend=backend),
                           h2_matvec(shape, data, x, backend=backend))


@pytest.mark.parametrize("p_new", P_NEW)
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_repartition_equals_fresh_partition(reference, geom, p_new):
    shape, data, d8 = _port(reference, geom)
    dsn, ddn = repartition_h2(*d8, p_new, device="cpu")
    dsf, ddf = td.partition_h2(shape, data, p_new, device="cpu")
    assert dsn == dsf
    got, want = _flat(ddn), _flat(ddf)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k


@pytest.mark.parametrize("p_new", P_NEW)
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_repartition_matches_reference(reference, geom, p_new):
    _, _, d8 = _port(reference, geom)
    dsn, ddn = repartition_h2(*d8, p_new, device="cpu")
    assert dataclasses.asdict(dsn) == reference[geom]["ref_rep_shape"][p_new]
    got, want = _flat(ddn), reference[geom]["ref_rep"][p_new]
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k


@pytest.mark.parametrize("p_new", P_NEW)
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_comm_model_after_shrink(reference, geom, p_new):
    _, _, d8 = _port(reference, geom)
    dsn, _ = repartition_h2(*d8, p_new, device="cpu")
    b8 = td.matvec_comm_bytes(d8[0], NV, "halo-plan")
    hp = td.matvec_comm_bytes(dsn, NV, "halo-plan")
    ag = td.matvec_comm_bytes(dsn, NV, "allgather")
    assert 0 < hp < ag and hp <= b8


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_repartition_makes_new_tensors(reference, geom):
    _, data, d8 = _port(reference, geom)
    _, ddn = repartition_h2(*d8, 4, device="cpu")
    src = {t.untyped_storage().data_ptr()
           for t in _tensors(d8[1]) if t.numel()}
    assert not any(t.untyped_storage().data_ptr() in src
                   for t in _tensors(ddn) if t.numel())
    sym = data.v_leaf is data.u_leaf
    assert (ddn.v_leaf is ddn.u_leaf) == sym
    assert all((f is e) == sym for f, e in zip(ddn.f_br, ddn.e_br))


def _tensors(ddata):
    out = []
    for f in dataclasses.fields(ddata):
        v = getattr(ddata, f.name)
        for x in (v if isinstance(v, list) else [v]):
            if isinstance(x, torch.Tensor):
                out.append(x)
            else:                                     # a halo plan
                out += list(x.send) + [getattr(x, g) for g in
                                       ("comb_idx", "diag_blk", "diag_col",
                                        "bnd_rows", "rowpos", "off_blk",
                                        "off_idx", "blk_idx")]
    return out


# ---------------------------------------------------------------------------
# the re-sharded operator in gloo groups

def _rank_main(rank: int, p: int, init: str, out: str, work: dict) -> None:
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    comm = Comm()
    res = {}
    for geom, w in work.items():
        shape = ts.H2Shape(**w["shape"])
        data = ts.data_from_numpy(w["arrays"], device="cpu")
        d8 = td.partition_h2(shape, data, 8, device="cpu")
        dshape, ddata = repartition_h2(*d8, p, device="cpu")
        nloc = dshape.n_local()
        x = torch.as_tensor(w["x"][rank * nloc:(rank + 1) * nloc])
        comm.reset_counts()
        y = td.make_dist_matvec(dshape, comm, "halo-plan")(
            td.local_shard(dshape, ddata, rank), x)
        res[geom] = (y.numpy(), comm.recv_bytes,
                     td.matvec_comm_bytes(dshape, NV, "halo-plan"))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def groups(reference, tmp_path_factory):
    """``{p: {geom: [per rank (rows, received bytes, model)]}}``."""
    work = {g: {k: r[k] for k in ("shape", "arrays", "x")}
            for g, r in reference.items()}
    ctx = torch.multiprocessing.get_context("spawn")
    procs = {}
    for p in P_NEW:
        tmp = tmp_path_factory.mktemp(f"repart{p}")
        procs[p] = (tmp, [ctx.Process(target=_rank_main, args=(
            r, p, f"file://{tmp / 'rendezvous'}", str(tmp), work))
            for r in range(p)])
    every = [pr for _, group in procs.values() for pr in group]
    for pr in every:
        pr.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for pr in every:
            pr.join(max(1.0, deadline - time.monotonic()))
    finally:
        hung = [pr for pr in every if pr.is_alive()]
        for pr in hung:
            pr.terminate()
            pr.join()
    assert not hung, f"{len(hung)} rank(s) did not finish within " \
        f"{RANK_TIMEOUT_S} s"
    out = {}
    for p, (tmp, group) in procs.items():
        assert [pr.exitcode for pr in group] == [0] * p
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(p)]
        out[p] = {g: [r[g] for r in ranks] for g in GEOMETRIES}
    return out


@pytest.mark.parametrize("p_new", P_NEW)
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_resharded_ranks_match_single_device(reference, groups, geom,
                                             p_new):
    per_rank = groups[p_new][geom]
    y = np.concatenate([r[0] for r in per_rank])
    want = reference[geom]["y"]
    err = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert err < 1e-5, err
    for _, got, model in per_rank:
        assert got == model
