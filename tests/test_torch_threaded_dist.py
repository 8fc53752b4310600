"""PyTorch port: ``ThreadedSolverService`` on distributed keys, served
live from rank 0 in spawned gloo groups of p = 2 and 4 CPU ranks.

Every rank opens one threaded service on the same key over a process group
of its own (``new_group``, made on every rank before the worker starts:
the worker is the only issuer on it, and the main threads meet on the
world group).  Rank 0 is the front end: 4 submitter threads send 12
right-hand sides into a queue of 2 and a panel of 2, backing off on
``QueueFull``, plus one request whose deadline has passed.  On the uniform
2D operator of ``test_torch_serving_dist.py`` (N = 1024) for the
``halo-plan`` and ``allgather`` keys: every rid completes exactly once;
the answers are within 1e-4 of the reference's ``ThreadedSolverService``
serving the same keys through its ``shard_map`` matvec on p XLA host
devices (run in a subprocess, so its ``XLA_FLAGS`` stay there), and
within 1e-4 of a local threaded service's; every rank ends with the same
metrics; each rank receives only its own rows of each admitted right-hand
side; ``submit`` and ``result`` off rank 0 raise, naming rank 0;
``close()`` on rank 0 right after a burst of submissions drains them and
ends every rank's worker; a service idle for longer than its group's
timeout stays alive on its heartbeats; a ``Comm`` that stages nothing
through the host (as under NCCL) serves the same answers.

Each group uses a ``file://`` rendezvous in ``tmp_path`` and is joined
with a deadline, so a rank that decides differently (and hangs the
others) fails the test.  The ranks import no JAX.
"""
import datetime
import os
import subprocess
import sys
import threading
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
N_REQ = 12
SUBMITTERS = 4
LOCAL_TOL = 1e-4                 # the reference's answer bound
DIST_MODES = ("halo-plan", "allgather")
JOIN_S = 120
IDLE_TIMEOUT_S = 4               # the idle episode's group timeout
IDLE_S = 6                       # rank 0 idles this long, past it
HEARTBEAT_S = 0.25
UNSTAGED_REQ = 4
REF_TIMEOUT_S = 200

# The reference's threaded service on the same keys: one process, p XLA
# host devices, the shard_map matvec; answers saved as "<mode>/<i>".
_REF_SCRIPT = r"""
import os, sys, time
p, out, n_req = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={p} "
                           + os.environ.get("XLA_FLAGS", ""))
import numpy as np
import jax
from jax.sharding import NamedSharding
from repro.core.clustering import regular_grid_points
from repro.core.construction import construct_h2
from repro.core.kernels_fn import exponential_kernel
from repro.core.dist import dist_specs, make_dist_matvec, partition_h2
from repro.serving import (OperatorCache, OperatorKey, QueueFull,
                           SolverService, ThreadedSolverService,
                           geometry_digest)

pts = regular_grid_points(32, 2)
shape, data, _, _ = construct_h2(pts, exponential_kernel(0.1), leaf_size=16,
                                 cheb_p=4, eta=0.9)
dshape, ddata = partition_h2(shape, data, p)
mesh = jax.make_mesh((p,), ("blk",))
placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                      ddata, dist_specs(dshape, "blk"))
rng = np.random.default_rng(5)
rhs = [rng.standard_normal(shape.n).astype(np.float32) for _ in range(n_req)]
res = {}
for mode in sys.argv[4:]:
    mv = make_dist_matvec(dshape, mesh, "blk", comm=mode)
    svc = SolverService(OperatorCache(), panel_width=2, restart_every=25,
                        max_segments=20, queue_capacity=2, tol=1e-6,
                        make_apply=lambda shp, mv=mv: (
                            lambda d, x: x + mv(d, x)))
    key = OperatorKey(geometry=geometry_digest(pts),
                      kernel=("exponential", 0.1), tol=None, comm=mode)
    tsvc = ThreadedSolverService(svc, key, lambda: (
        shape, placed, {"dshape": dshape}))
    rids = []
    for b in rhs:
        while True:
            try:
                rids.append(tsvc.submit(b))
                break
            except QueueFull:
                time.sleep(0.002)
    for i, rid in enumerate(rids):
        c = tsvc.result(rid, timeout=120)
        assert c.status == "ok", (mode, i, c.status)
        res[f"{mode}/{i}"] = np.asarray(c.x)
    tsvc.close(120)
np.savez(out, **res)
"""


def _operator():
    pts = regular_grid_points(32, 2)                 # N = 1024
    shape, data, _, _ = construct_h2(pts, exponential_kernel(0.1),
                                     leaf_size=16, cheb_p=4, eta=0.9,
                                     device="cpu")
    return pts, shape, data


def _rhs(n: int):
    rng = np.random.default_rng(5)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(N_REQ)]


def _offer(tsvc, b, **kw):
    """``submit``, backing off on ``QueueFull``: (rid, QueueFull count)."""
    from repro_torch.serving import QueueFull
    fulls = 0
    while True:
        try:
            return tsvc.submit(b, **kw), fulls
        except QueueFull:
            fulls += 1
            time.sleep(0.002)


def _submit_all(tsvc, rhs):
    """4 threads submit ``rhs`` (backing off on ``QueueFull``); returns
    (rid -> index into rhs, QueueFull count)."""
    rid_of, fulls, lock = {}, [0], threading.Lock()
    start = threading.Barrier(SUBMITTERS)

    def worker(w):
        start.wait()
        for i in range(w, len(rhs), SUBMITTERS):
            rid, full = _offer(tsvc, rhs[i])
            with lock:
                rid_of[rid] = i
                fulls[0] += full
    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(SUBMITTERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    return rid_of, fulls[0]


def _unstaged_comm(group):
    """A ``Comm`` that moves every tensor as it is, as under NCCL."""
    from repro_torch.core.comm import Comm
    comm = Comm(group)
    comm.backend, comm.host_staged = "nccl", False
    return comm


def _rank_main(rank: int, p: int, init: str, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    from repro_torch.core.dist import local_shard, partition_h2
    from repro_torch.serving import (OperatorCache, OperatorKey,
                                     SolverService, ThreadedSolverService,
                                     geometry_digest)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    serve_group = dist.new_group(list(range(p)))     # the workers' group
    idle_group = dist.new_group(list(range(p)), timeout=datetime.timedelta(
        seconds=IDLE_TIMEOUT_S))
    comm = Comm(serve_group)
    pts, shape, data = _operator()
    dshape, ddata = partition_h2(shape, data, p, device="cpu")
    geom = geometry_digest(pts)
    svc = SolverService(OperatorCache(), panel_width=2, restart_every=25,
                        max_segments=20, queue_capacity=2, tol=1e-6,
                        device="cpu", backend="torch", comm=comm)
    rhs = _rhs(shape.n)

    def key(mode):
        return OperatorKey(geometry=geom, kernel=("exponential", 0.1),
                           tol=None, comm=mode)

    def build_dist():
        return shape, local_shard(dshape, ddata, rank), {"dshape": dshape}

    res = {}
    for mode in DIST_MODES:
        comm.reset_counts()
        tsvc = ThreadedSolverService(svc, key(mode), build_dist)
        ep = {}
        if rank == 0:
            rid_of, fulls = _submit_all(tsvc, rhs)
            late, _ = _offer(tsvc, rhs[0], deadline=time.monotonic() - 1.0)
            done = {rid: tsvc.result(rid, timeout=JOIN_S)
                    for rid in sorted(rid_of)}
            ep["late"] = tsvc.result(late, timeout=JOIN_S).status
            ep["x"] = {rid_of[rid]: c.x.numpy() for rid, c in done.items()}
            ep["status"] = {rid_of[rid]: c.status for rid, c in done.items()}
            ep["fulls"] = fulls
            ep["rids"] = sorted(rid_of) + [late]
        else:
            for what, call in (("submit", lambda: tsvc.submit(rhs[0])),
                               ("result", lambda: tsvc.result(0))):
                try:
                    call()
                    ep[f"{what}_raised"] = ""
                except RuntimeError as e:
                    ep[f"{what}_raised"] = str(e)
        tsvc.close(JOIN_S)
        ep["closed"] = not tsvc._thread.is_alive()
        ep["metrics"] = dict(tsvc.metrics)
        ep["boundaries"] = tsvc.boundaries
        ep["bcast_bytes"] = comm.recv_by_kind.get("broadcast", 0)
        ep["scatter_bytes"] = comm.recv_by_kind.get("scatter", 0)
        res[mode] = ep

    # close() right after a burst: drained, and every rank's worker ends
    tsvc = ThreadedSolverService(svc, key("halo-plan"), build_dist)
    ep = {}
    if rank == 0:
        rids = [_offer(tsvc, rhs[i])[0] for i in range(2)]
        tsvc.close(JOIN_S)
        ep["statuses"] = [tsvc.result(r, timeout=1.0).status for r in rids]
        try:
            tsvc.submit(rhs[0])
            ep["after_close"] = ""
        except RuntimeError as e:
            ep["after_close"] = str(e)
    else:
        tsvc.close(JOIN_S)
    ep["closed"] = not tsvc._thread.is_alive()
    ep["metrics"] = dict(tsvc.metrics)
    res["close"] = ep

    # idle past the group's timeout: rank 0's heartbeats keep every rank
    dist.barrier()
    isvc = SolverService(svc.cache, panel_width=2, restart_every=25,
                         max_segments=20, queue_capacity=2, tol=1e-6,
                         device="cpu", backend="torch", comm=Comm(idle_group))
    tsvc = ThreadedSolverService(isvc, key("halo-plan"), build_dist,
                                 heartbeat=HEARTBEAT_S)
    ep = {}
    if rank == 0:
        time.sleep(IDLE_S)
        rid, _ = _offer(tsvc, rhs[3])
        try:
            c = tsvc.result(rid, timeout=IDLE_S + 4 * IDLE_TIMEOUT_S)
            ep["status"], ep["x"] = c.status, c.x.numpy()
        except TimeoutError:
            ep["status"] = "not answered"
    tsvc.close(IDLE_S + 4 * IDLE_TIMEOUT_S)
    ep["closed"] = not tsvc._thread.is_alive()
    ep["metrics"] = dict(tsvc.metrics)
    ep["boundaries"] = tsvc.boundaries
    res["idle"] = ep

    # a Comm that stages nothing through the host
    dist.barrier()
    usvc = SolverService(svc.cache, panel_width=2, restart_every=25,
                         max_segments=20, queue_capacity=2, tol=1e-6,
                         device="cpu", backend="torch",
                         comm=_unstaged_comm(serve_group))
    tsvc = ThreadedSolverService(usvc, key("allgather"), build_dist)
    ep = {}
    if rank == 0:
        rids = [_offer(tsvc, rhs[i])[0] for i in range(UNSTAGED_REQ)]
        ep["x"] = {i: tsvc.result(r, timeout=JOIN_S).x.numpy()
                   for i, r in enumerate(rids)}
    tsvc.close(JOIN_S)
    ep["closed"] = not tsvc._thread.is_alive()
    ep["metrics"] = dict(tsvc.metrics)
    res["unstaged"] = ep

    if rank == 0:                        # the local answers, no collective
        lsvc = ThreadedSolverService(svc, key("local"),
                                     lambda: (shape, data, {}))
        got = {}
        for i in range(N_REQ):
            rid, _ = _offer(lsvc, rhs[i])
            got[i] = lsvc.result(rid, timeout=JOIN_S).x.numpy()
        lsvc.close(JOIN_S)
        res["local"] = got
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Per p, every rank's results ``{p: [rank results]}``; all groups
    spawned at once, one deadline."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [q for q in [env.get("PYTHONPATH")] if q])
    env["JAX_PLATFORMS"] = "cpu"
    refs = {p: subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(p), str(tmp / f"ref{p}.npz"),
         str(N_REQ), *DIST_MODES], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for p in P_GROUPS}
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
        if hung:
            for ref in refs.values():
                ref.kill()
    assert not hung, f"{len(hung)} rank(s) did not finish within " \
        f"{RANK_TIMEOUT_S} s (a rank decided differently?)"
    for p, ref in refs.items():
        log, _ = ref.communicate(timeout=REF_TIMEOUT_S)
        assert ref.returncode == 0, f"reference p={p}:\n{log[-4000:]}"
    out = {}
    for p, group in procs.items():
        codes = [pr.exitcode for pr in group]
        assert codes == [0] * p, f"p={p}: rank exit codes {codes}"
        out[p] = [torch.load(tmp / f"p{p}" / f"rank{r}.pt",
                             weights_only=False) for r in range(p)]
        with np.load(tmp / f"ref{p}.npz") as z:
            out[p][0]["ref"] = {k: z[k] for k in z.files}
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", DIST_MODES)
@pytest.mark.parametrize("p", P_GROUPS)
def test_answers_match_local(groups, p, mode):
    """Every request ok, answered whole (all N rows), within 1e-4 of the
    local threaded service's answer to the same right-hand side."""
    r0 = groups[p][0]
    ep = r0[mode]
    assert sorted(ep["x"]) == list(range(N_REQ))
    assert set(ep["status"].values()) == {"ok"}
    for i, x in ep["x"].items():
        assert x.shape == r0["local"][i].shape
        assert _rel(x, r0["local"][i]) < LOCAL_TOL, (mode, i)


@pytest.mark.parametrize("mode", DIST_MODES)
@pytest.mark.parametrize("p", P_GROUPS)
def test_answers_match_reference(groups, p, mode):
    """Within 1e-4 of the reference's threaded service serving the same
    key through its shard_map matvec on p devices."""
    r0 = groups[p][0]
    for i, x in r0[mode]["x"].items():
        ref = r0["ref"][f"{mode}/{i}"]
        assert x.shape == ref.shape
        assert _rel(x, ref) < LOCAL_TOL, (mode, i, _rel(x, ref))


@pytest.mark.parametrize("mode", DIST_MODES)
@pytest.mark.parametrize("p", P_GROUPS)
def test_exactly_once_under_queue_full(groups, p, mode):
    """A queue of 2 overflows; every rid still completes exactly once and
    the expired request is answered as a timeout."""
    ep = groups[p][0][mode]
    m = ep["metrics"]
    assert ep["fulls"] > 0
    assert len(set(ep["rids"])) == N_REQ + 1
    assert m["submitted"] == m["completed"] == N_REQ + 1
    assert m["timeouts"] == 1 and ep["late"] == "timeout"
    assert m["duplicates"] == 0


@pytest.mark.parametrize("episode",
                         DIST_MODES + ("close", "idle", "unstaged"))
@pytest.mark.parametrize("p", P_GROUPS)
def test_ranks_agree_and_close(groups, p, episode):
    """Every rank ends the episode with rank 0's metrics, and every
    rank's worker has ended after ``close()``."""
    ranks = groups[p]
    for r, res in enumerate(ranks):
        assert res[episode]["closed"], (r, episode)
        assert res[episode]["metrics"] == ranks[0][episode]["metrics"], \
            (r, episode)


@pytest.mark.parametrize("p", P_GROUPS)
def test_front_end_is_rank_zero(groups, p):
    """``submit``/``result`` off rank 0 raise, naming rank 0; the
    decisions reach every other rank by broadcast, and each rank receives
    its own rows of each admitted right-hand side, no more."""
    n = 1024
    for res in groups[p][1:]:
        ep = res["halo-plan"]
        assert "rank 0" in ep["submit_raised"]
        assert "rank 0" in ep["result_raised"]
        assert ep["boundaries"] >= 1 and ep["bcast_bytes"] > 0
        for mode in DIST_MODES:
            assert res[mode]["scatter_bytes"] == N_REQ * (n // p) * 4
    assert groups[p][0]["halo-plan"]["bcast_bytes"] == 0
    assert groups[p][0]["halo-plan"]["scatter_bytes"] == 0


@pytest.mark.parametrize("p", P_GROUPS)
def test_close_mid_stream_drains(groups, p):
    """``close()`` right after two submissions answers both, ends every
    rank, and refuses later submissions."""
    ep = groups[p][0]["close"]
    assert ep["statuses"] == ["ok", "ok"]
    assert "close" in ep["after_close"]
    assert ep["metrics"]["completed"] == 2


@pytest.mark.parametrize("p", P_GROUPS)
def test_idle_heartbeats_keep_ranks_alive(groups, p):
    """Rank 0 idles for longer than the group's timeout, then submits:
    its heartbeats kept the other ranks' workers in the exchange, so the
    request is answered (within 1e-4 of the local answer) and every rank
    counted the heartbeats."""
    ep = groups[p][0]["idle"]
    assert ep["status"] == "ok"
    assert _rel(ep["x"], groups[p][0]["local"][3]) < LOCAL_TOL
    for res in groups[p]:
        assert res["idle"]["boundaries"] >= IDLE_S / HEARTBEAT_S / 2


@pytest.mark.parametrize("p", P_GROUPS)
def test_unstaged_comm_serves_the_same_answers(groups, p):
    """With a ``Comm`` that moves tensors as they are (NCCL's transport),
    the answers are the local service's within 1e-4."""
    r0 = groups[p][0]
    assert sorted(r0["unstaged"]["x"]) == list(range(UNSTAGED_REQ))
    for i, x in r0["unstaged"]["x"].items():
        assert _rel(x, r0["local"][i]) < LOCAL_TOL, i


def test_solver_thread_failure_surfaces():
    """A segment that raises ends the solver thread; ``result`` of a
    pending request, a later ``submit`` and ``close`` raise it instead of
    waiting out their timeouts."""
    from repro_torch.serving import (OperatorCache, OperatorKey,
                                     SolverService, ThreadedSolverService,
                                     geometry_digest)
    pts, shape, data = _operator()

    def make_apply(shp):
        def apply(d, x):
            raise FloatingPointError("injected")
        return apply
    svc = SolverService(OperatorCache(), panel_width=2, restart_every=25,
                        max_segments=20, tol=1e-6, device="cpu",
                        backend="torch", make_apply=make_apply)
    key = OperatorKey(geometry=geometry_digest(pts),
                      kernel=("exponential", 0.1), tol=None, comm="local")
    tsvc = ThreadedSolverService(svc, key, lambda: (shape, data, {}))
    rid = tsvc.submit(_rhs(shape.n)[0])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="solver thread") as err:
        tsvc.result(rid, timeout=JOIN_S)
    assert time.monotonic() - t0 < JOIN_S / 2
    assert isinstance(err.value.__cause__, FloatingPointError)
    with pytest.raises(RuntimeError, match="solver thread"):
        tsvc.submit(_rhs(shape.n)[1])
    with pytest.raises(RuntimeError, match="solver thread"):
        tsvc.close(JOIN_S)
    assert not tsvc._thread.is_alive()
