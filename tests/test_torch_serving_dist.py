"""PyTorch port: distributed serving (``OperatorKey.comm`` other than
``"local"``), ported from the reference's ``serving_dist_checks``
(``tests/dist_worker.py``), in spawned gloo groups of p = 2 and 4 CPU
ranks.

Every rank runs one ``SolverService`` with its ``comm`` over the same
request list (a seeded ``PoissonLoad``), in lockstep.  On the uniform 2D
operator of ``test_torch_dist.py`` (N = 1024) at the reference's settings
(6 requests, panel 4, restarts of 25, tol 1e-6, 0.02 virtual seconds a
dispatch): the ``local``, ``halo-plan`` and ``allgather`` keys are three
residents built by three misses; every answer is ``ok`` and, gathered
across the ranks (``gather_answers``), within 1e-4 of the local key's (the
reference's bound); a replay against the halo-plan resident is a pure
cache hit and survives a NaN at dispatch 1 through a retry; the degraded
paths (per-column ``pcg`` and ``degraded="loose"``) serve an open
breaker.  Every rank ends every episode with the same metrics and the
same dispatch log, also on the wall clock (``dispatch_cost=None``), where
each dispatch costs the slowest rank's wall.

Each group uses a ``file://`` rendezvous in ``tmp_path`` and one thread
per rank, and is joined with a deadline, so a rank that decides
differently (and hangs the others) fails the test.
"""
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.core.clustering import regular_grid_points
from repro_torch.core.construction import construct_h2
from repro_torch.core.kernels_fn import exponential_kernel

torch.set_num_threads(2)

P_GROUPS = (2, 4)
RANK_TIMEOUT_S = 240
N_REQ = 6
LOCAL_TOL = 1e-4                 # the reference's answer bound
DIST_MODES = ("halo-plan", "allgather")


def _operator():
    pts = regular_grid_points(32, 2)                 # N = 1024
    shape, data, _, _ = construct_h2(pts, exponential_kernel(0.1),
                                     leaf_size=16, cheb_p=4, eta=0.9,
                                     device="cpu")
    return pts, shape, data


def _episode(rep, comm, dist: bool = True) -> dict:
    from repro_torch.serving import gather_answers
    gathered = gather_answers(rep, comm) if dist else \
        {r: c.x for r, c in rep.completions.items()}
    metrics = dict(rep.metrics)
    # the builds' host seconds are the one wall-clock statistic
    metrics["cache"] = {k: v for k, v in metrics["cache"].items()
                        if k != "build_seconds"}
    return dict(
        metrics=metrics,
        log=rep.dispatch_log(),
        status={r: c.status for r, c in rep.completions.items()},
        via={r: c.via for r, c in rep.completions.items()},
        x={r: v.numpy() for r, v in gathered.items()},
        x_local={r: c.x.numpy() for r, c in rep.completions.items()})


def _rank_main(rank: int, p: int, init: str, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    from repro_torch.core.dist import local_shard, partition_h2
    from repro_torch.runtime.fault import CircuitBreaker
    from repro_torch.serving import (OperatorCache, OperatorKey,
                                     PoissonLoad, ServiceFaultPlan,
                                     SolverService, geometry_digest)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    comm = Comm()
    pts, shape, data = _operator()
    dshape, ddata = partition_h2(shape, data, p, device="cpu")
    geom = geometry_digest(pts)
    cache = OperatorCache()

    def load():
        return PoissonLoad(n=shape.n, rate=200.0, n_requests=N_REQ,
                           tol=1e-6, seed=11).requests()

    def svc(fault_plan=None, **kw):
        opts = dict(panel_width=4, restart_every=25, max_segments=20,
                    tol=1e-6, dispatch_cost=0.02, seed=0,
                    fault_plan=fault_plan, device="cpu", backend="torch",
                    comm=comm)
        opts.update(kw)
        return SolverService(cache, **opts)

    def key(mode, tol=None):
        return OperatorKey(geometry=geom, kernel=("exponential", 0.1),
                           tol=tol, comm=mode)

    def build_local():
        return shape, data, {}

    def build_dist():
        return shape, local_shard(dshape, ddata, rank), {"dshape": dshape}

    res = {}
    for mode in ("local",) + DIST_MODES:
        rep = svc().serve(load(), key(mode),
                          build_local if mode == "local" else build_dist)
        res[mode] = _episode(rep, comm, mode != "local")
    res["cache"] = (len(cache), cache.stats())

    def must_not_build():
        raise AssertionError("halo-plan operator rebuilt on a hit")

    rep = svc(ServiceFaultPlan(nan_at={1})).serve(load(), key("halo-plan"),
                                                  must_not_build)
    res["nan"] = _episode(rep, comm)
    rep = svc(dispatch_cost=None).serve(load(), key("halo-plan"),
                                        must_not_build)
    res["wall"] = _episode(rep, comm)
    # the loose entry: the same shard under a looser tolerance
    cache.get_or_build(key("halo-plan", 1e-4), build_dist)
    for mode, plan in (("pcg", {0: "dl", 1: "dl"}), ("loose", {0: "dl"})):
        rep = svc(ServiceFaultPlan(device_loss_at=plan), degraded=mode,
                  degraded_tol=1e-3, max_segments=40,
                  breaker=CircuitBreaker(failure_threshold=len(plan),
                                         cooldown=1.0)).serve(
            load(), key("halo-plan"), must_not_build)
        res[f"degraded_{mode}"] = _episode(rep, comm)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Per p, every rank's results ``{p: [rank results]}``; all groups
    spawned at once, one deadline."""
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = {}
    for p in P_GROUPS:
        (tmp / f"p{p}").mkdir()
        init = f"file://{tmp / f'p{p}' / 'rendezvous'}"
        procs[p] = [ctx.Process(target=_rank_main,
                                args=(r, p, init, str(tmp / f"p{p}")))
                    for r in range(p)]
    every = [pr for group in procs.values() for pr in group]
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
        f"{RANK_TIMEOUT_S} s (a rank decided differently?)"
    out = {}
    for p, group in procs.items():
        codes = [pr.exitcode for pr in group]
        assert codes == [0] * p, f"p={p}: rank exit codes {codes}"
        out[p] = [torch.load(tmp / f"p{p}" / f"rank{r}.pt",
                             weights_only=False) for r in range(p)]
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


EPISODES = ("local",) + DIST_MODES + ("nan", "wall", "degraded_pcg",
                                      "degraded_loose")


@pytest.mark.parametrize("p", P_GROUPS)
def test_three_residents_three_misses(groups, p):
    for length, stats in (r["cache"] for r in groups[p]):
        assert length == 3 and stats["misses"] == 3, stats


@pytest.mark.parametrize("mode", DIST_MODES)
@pytest.mark.parametrize("p", P_GROUPS)
def test_answers_match_local(groups, p, mode):
    """Every request ok, and the answer gathered across the ranks within
    1e-4 of the local key's (same system, another exchange plan)."""
    r0 = groups[p][0]
    ep = r0[mode]
    assert ep["metrics"]["completed"] == N_REQ
    assert set(ep["status"].values()) == {"ok"}
    assert sorted(ep["x"]) == sorted(r0["local"]["x_local"])
    for rid, x_loc in r0["local"]["x_local"].items():
        assert ep["x"][rid].shape == x_loc.shape
        assert _rel(ep["x"][rid], x_loc) < LOCAL_TOL, (mode, rid)


@pytest.mark.parametrize("p", P_GROUPS)
def test_hit_does_not_rebuild_and_nan_is_retried(groups, p):
    """A replay against the halo-plan resident is a pure hit (the build
    would raise) and survives the NaN at dispatch 1 through a retry."""
    r0 = groups[p][0]
    m = r0["nan"]["metrics"]
    assert m["cache"]["hits"] >= 1
    assert m["completed"] == N_REQ and m["dispatch_failures"] >= 1
    assert m["retries"] >= 1
    assert set(r0["nan"]["status"].values()) == {"ok"}
    for rid, x in r0["nan"]["x"].items():
        assert np.isfinite(x).all()
        assert _rel(x, r0["local"]["x_local"][rid]) < LOCAL_TOL, rid


@pytest.mark.parametrize("mode", ["pcg", "loose"])
@pytest.mark.parametrize("p", P_GROUPS)
def test_degraded_paths(groups, p, mode):
    """An open breaker on a distributed key serves every request through
    the fallback: per-column ``pcg`` over the ranks, or the looser
    resident of the same comm mode."""
    ep = groups[p][0][f"degraded_{mode}"]
    assert ep["metrics"]["breaker_trips"] >= 1
    assert ep["metrics"]["degraded_dispatches"] >= 1
    assert set(ep["status"].values()) == {"ok"}
    assert set(ep["via"].values()) == {"degraded"}
    for rid, x in ep["x"].items():
        assert _rel(x, groups[p][0]["local"]["x_local"][rid]) < LOCAL_TOL


@pytest.mark.parametrize("episode", EPISODES)
@pytest.mark.parametrize("p", P_GROUPS)
def test_ranks_agree(groups, p, episode):
    """Every rank ends the episode with the same metrics and the same
    dispatch log (the wall-clock episode included: each dispatch costs
    the slowest rank's wall), and holds its own rows of each answer."""
    ranks = groups[p]
    r0 = ranks[0][episode]
    for r, res in enumerate(ranks[1:], start=1):
        ep = res[episode]
        assert ep["metrics"] == r0["metrics"], (r, episode)
        assert ep["log"] == r0["log"], (r, episode)
        assert ep["status"] == r0["status"]
    if episode != "local":
        for rid, x in r0["x"].items():
            rows = np.concatenate([res[episode]["x_local"][rid]
                                   for res in ranks])
            assert np.array_equal(rows, x)
    assert len(r0["log"]) >= 1
