"""PyTorch port: the elastic distributed §6.4 solve
(``apps.fractional.solve_distributed_elastic``) in one spawned gloo group
of p = 4 CPU ranks, under the reference's chaos schedule
(``tests/dist_worker.py:chaos_main``, p = 8 there) scaled to 4 ranks:
n = 16, h2_tol 1e-7, tol 1e-10.

Each case holds its outcome:

- clean (``ckpt_every=1``, so the committed history is per iteration):
  the iterations of the port's monolithic distributed solve at p = 4
  (``make_dist_solve``) exactly, ``u`` bitwise equal to it, iterations to
  reach 1e-6 within 1 of the reference's single-device ``solve(16)``;
- device loss ``{2: 2}``: one event 4 -> 2 that loses 0 iterations,
  ``p_final == 2``, ranks 2 and 3 report the segment they were lost at,
  ``u`` within 1e-5 of the clean run's;
- nested loss ``{2: 2, 4: 1}``: every world rank makes both groups in
  schedule order, ``p_final == 1``, 0 iterations lost;
- NaN at segment 1 (``ckpt_every=4``): the tripwire rolls back exactly 4
  iterations;
- straggler at segment 4 (``ckpt_every=2``): flagged, 0 iterations lost,
  no restart;
- bf16 escalation (``halo-plan-bf16``, NaN at 1): ``comm_final ==
  "halo-plan"``, ``GUARD_COUNTERS["elastic/fp32-comm"] == 1``, status 0;
- torn checkpoint: rank 0 tears the manifest of the step ``LATEST`` names
  just before a NaN, so the restore falls back to the step before it (8
  iterations lost at ``ckpt_every=4``).

Every survivor reports the same iterations, relres and history (the
control decisions come from replicated values).  JAX is imported inside
a fixture only: the spawned ranks import this module.  The group uses a
``file://`` rendezvous in ``tmp_path`` and every rank is joined within
``RANK_TIMEOUT_S``, so a hung rank fails the tests.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.chaos

torch.set_num_threads(2)

N = 16
P = 4
SOLVE = dict(h2_tol=1e-7, tol=1e-10, maxiter=200)
RANK_TIMEOUT_S = 300
STRAGGLER = dict(threshold=3.0, warmup=3)


def _cases():
    from repro_torch.runtime.chaos import ChaosPlan
    return {
        "clean": dict(ckpt_every=1),
        "device_loss": dict(ckpt_every=4,
                            chaos=ChaosPlan(device_loss_at={2: 2})),
        "nested_loss": dict(ckpt_every=4,
                            chaos=ChaosPlan(device_loss_at={2: 2, 4: 1})),
        "nan": dict(ckpt_every=4, chaos=ChaosPlan(nan_at={1})),
        "straggler": dict(ckpt_every=2,
                          chaos=ChaosPlan(straggle_at={4: 1000.0})),
        "bf16": dict(ckpt_every=4, mode="halo-plan-bf16",
                     chaos=ChaosPlan(nan_at={1})),
        "torn": dict(ckpt_every=4, chaos=ChaosPlan(nan_at={3})),
    }


TORN_STEP = 3          # the step rank 0 tears in the "torn" case


def _tear_saves(step_to_tear: int):
    """Make rank 0's saves tear the manifest of ``step_to_tear`` right
    after writing it (``LATEST`` already names it)."""
    from repro_torch.checkpoint import manager

    save = manager.CheckpointManager.save

    def torn_save(self, step, tree, **kw):
        out = save(self, step, tree, **kw)
        self.wait()
        if step == step_to_tear:
            man = os.path.join(out, "manifest.json")
            with open(man) as f:
                doc = f.read()
            with open(man, "w") as f:
                f.write(doc[: len(doc) // 2])
        return out
    return save, torn_save


def _record(res) -> dict:
    if res["lost_at"] is not None:
        return dict(res)
    rep = res["report"]
    return dict(
        lost_at=None, iters=res["iters"], relres=res["relres"],
        converged=res["converged"], status=res["status"],
        history=list(res["history"]), u=res["u"].numpy().ravel(),
        p_final=res["p_final"], comm_final=res["comm_final"],
        restarts=res["restarts"], summary=rep.summary(),
        events=[(e.kind, e.segment, e.p_from, e.p_to, e.iters_lost)
                for e in rep.events],
        flags=list(rep.straggler_flags), saves=len(rep.ckpt_save_s),
        segment_p=[s["p"] for s in res["segments"]])


def _rank_main(rank: int, init: str, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.apps import fractional as pf
    from repro_torch.checkpoint import manager
    from repro_torch.core.comm import Comm
    from repro_torch.guard import GUARD_COUNTERS
    from repro_torch.runtime.fault import StragglerMonitor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=P)
    comm = Comm()
    res = {}

    parts = pf.make_dist_solve(
        pf.FractionalProblem(N, h2_tol=SOLVE["h2_tol"],
                             device="cpu").build(),
        comm, tol=SOLVE["tol"], maxiter=SOLVE["maxiter"], device="cpu")
    b = torch.ones(N * N // P) * (2.0 / N) ** 2
    mono = parts["fn"](b)
    res["monolithic"] = dict(iters=int(mono.iters),
                             u=mono.x.numpy().ravel())

    for name, kw in _cases().items():
        kw = dict(kw)
        if name == "straggler":
            kw["monitor"] = StragglerMonitor(**STRAGGLER)
        if name == "bf16":
            GUARD_COUNTERS.clear()
        save = None
        if name == "torn" and rank == 0:
            save, torn = _tear_saves(TORN_STEP)
            manager.CheckpointManager.save = torn
        ckpt = os.path.join(out, f"ckpt_{name}")
        try:
            r = pf.solve_distributed_elastic(
                N, comm, h2_tol=SOLVE["h2_tol"], tol=SOLVE["tol"],
                maxiter=SOLVE["maxiter"], ckpt_dir=ckpt, device="cpu",
                **kw)
        finally:
            if save is not None:
                manager.CheckpointManager.save = save
        res[name] = _record(r)
        if name == "bf16":
            res[name]["fp32_comm"] = GUARD_COUNTERS["elastic/fp32-comm"]
        comm.barrier()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every rank's results, ``{case: [per rank]}``."""
    tmp = tmp_path_factory.mktemp("elastic")
    ctx = torch.multiprocessing.get_context("spawn")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [ctx.Process(target=_rank_main, args=(r, init, str(tmp)))
             for r in range(P)]
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
    assert not hung, f"{len(hung)} rank(s) did not finish within " \
        f"{RANK_TIMEOUT_S} s"
    assert [pr.exitcode for pr in procs] == [0] * P
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(P)]
    return {k: [r[k] for r in ranks] for k in ranks[0]}


@pytest.fixture(scope="module")
def reference():
    pytest.importorskip("jax")
    from repro.apps.fractional import solve
    return solve(N, **SOLVE)


def _survivors(group, case):
    recs = group[case]
    alive = [r for r in recs if r["lost_at"] is None]
    r0 = alive[0]
    for r in alive:
        assert (r["iters"], r["relres"], r["history"], r["status"]) == \
            (r0["iters"], r0["relres"], r0["history"], r0["status"])
    return r0, np.concatenate([r["u"] for r in alive]), recs


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) /
                 np.linalg.norm(np.asarray(b, np.float64)))


def _to_reach(hist, level: float) -> int:
    """Iterations until the relres first reaches ``level``; ``hist[i]``
    is the relres after iteration ``i`` (reference, from 0) or after
    ``i + 1`` (the clean run's per-iteration segments)."""
    return next(i for i, v in enumerate(hist) if v <= level)


def test_clean_matches_monolithic(group):
    r0, u, _ = _survivors(group, "clean")
    mono = group["monolithic"]
    assert r0["converged"] and r0["restarts"] == 0 and r0["status"] == 0
    assert r0["iters"] == mono[0]["iters"]
    assert np.array_equal(u, np.concatenate([m["u"] for m in mono]))
    assert r0["saves"] == r0["iters"] and r0["p_final"] == P
    # a slow segment on a loaded host may be flagged (wall time), and
    # costs nothing
    assert set(r0["summary"]["faults"]) <= {"straggler"}


def test_clean_rate_matches_reference(group, reference):
    r0, _, _ = _survivors(group, "clean")
    ref = _to_reach(np.asarray(reference["history"]), 1e-6)
    got = _to_reach(r0["history"], 1e-6) + 1
    assert abs(got - ref) <= 1, (got, ref)


def test_device_loss_shrinks_without_losing_iterations(group):
    r0, u, recs = _survivors(group, "device_loss")
    clean = _survivors(group, "clean")[1]
    assert r0["converged"] and r0["restarts"] == 1 and r0["p_final"] == 2
    assert r0["events"] == [("device-loss", 2, 4, 2, 0)]
    assert [r["lost_at"] for r in recs] == [None, None, 2, 2]
    assert r0["segment_p"][:2] == [4, 4] and set(r0["segment_p"][2:]) == {2}
    assert _rel(u, clean) < 1e-5


def test_nested_loss_group_order(group):
    r0, u, recs = _survivors(group, "nested_loss")
    clean = _survivors(group, "clean")[1]
    assert r0["converged"] and r0["restarts"] == 2 and r0["p_final"] == 1
    assert [e[:4] for e in r0["events"]] == [("device-loss", 2, 4, 2),
                                             ("device-loss", 4, 2, 1)]
    assert sum(e[4] for e in r0["events"]) == 0
    assert [r["lost_at"] for r in recs] == [None, 4, 2, 2]
    assert _rel(u, clean) < 1e-5


def test_nan_rolls_back_one_interval(group):
    r0, u, _ = _survivors(group, "nan")
    clean = _survivors(group, "clean")[1]
    assert r0["converged"] and r0["restarts"] == 1 and r0["p_final"] == P
    assert r0["summary"]["faults"]["corruption"]["iters_lost"] == 4
    assert np.isfinite(u).all() and _rel(u, clean) < 1e-5
    assert r0["iters"] == group["monolithic"][0]["iters"]


def test_straggler_flagged_no_iterations_lost(group):
    r0, _, _ = _survivors(group, "straggler")
    assert r0["converged"] and r0["restarts"] == 0
    assert 4 in r0["flags"]
    assert r0["summary"]["faults"]["straggler"]["iters_lost"] == 0
    assert r0["iters"] == group["monolithic"][0]["iters"]


def test_bf16_escalates_to_fp32(group):
    r0, u, recs = _survivors(group, "bf16")
    clean = _survivors(group, "clean")[1]
    assert r0["converged"] and r0["restarts"] == 1 and r0["status"] == 0
    assert r0["comm_final"] == "halo-plan"
    assert all(r["fp32_comm"] == 1 for r in recs)
    assert _rel(u, clean) < 1e-5


def test_torn_checkpoint_falls_back(group):
    r0, u, _ = _survivors(group, "torn")
    clean = _survivors(group, "clean")[1]
    assert r0["converged"] and r0["restarts"] == 1
    assert r0["summary"]["faults"]["corruption"]["iters_lost"] == 8
    assert _rel(u, clean) < 1e-5


def test_summary_is_json(group):
    for case in _cases():
        r0, _, _ = _survivors(group, case)
        json.dumps(r0["summary"])
