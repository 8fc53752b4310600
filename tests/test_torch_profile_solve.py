"""PyTorch port: ``obs.profile_solve`` and ``perf.comm_cost`` on the
distributed §6.4 solve, in spawned gloo groups of p = 2 and 4 CPU ranks
(the port's own n = 16 problem; ``tests/test_torch_obs.py`` holds
``phase_comm_model`` to the reference's).

Per rank, for halo-plan and allgather, fused and two-step: the replay
stages chained on ``stage_env``'s state give one iteration of the solve
bit for bit (``pcg_segment`` of one step on ``make_dist_solve_local``'s
operator); each phase's stages received exactly ``phase_comm_model``'s
bytes and the whole chain exactly ``dist_solve_comm_bytes``, as ``Comm``
counts them (the reference holds its HLO bytes to the model within 10 %).
The distributed HGEMV received exactly ``matvec_comm_bytes`` in the
halo-plan, ppermute and allgather modes (the reference: within 10 % and
1-2.5x).  Rank 0 of the distributed solve dispatches the same operations
with tracing on and off and gives the same bits.  ``profile_stages``
gives every phase's seconds, the same on every rank; ``profile_rank``'s
document has the reference's keys, its records carry the measured bytes
beside the model, and the CLI (``run_profile``, ``write_outputs``) writes
the report and a Chrome trace with one lane per comm mode.

Each group uses a ``file://`` rendezvous in ``tmp_path`` and one thread
per rank, and is joined with a deadline, so a hung rank fails its test.
"""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.apps import fractional as pf
from repro_torch.core import dist as td
from repro_torch.obs import profile_solve as ps

torch.set_num_threads(2)

N = 16
P_GROUPS = (2, 4)
RANK_TIMEOUT_S = 240
CONFIGS = [("halo-plan", True), ("halo-plan", False), ("allgather", False),
           ("allgather", True)]
MV_MODES = ("halo-plan", "ppermute", "allgather")
NVS = (1, 3)


class _Ops(TorchDispatchMode):
    """Every dispatched operation but the profiler's marks, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace != "profiler":
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _rank_main(rank: int, p: int, init: str, out: str, shard, h: float
               ) -> None:
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    from repro_torch.obs import trace
    from repro_torch.obs.timers import run_stages
    from repro_torch.perf.comm_cost import collective_bytes
    from repro_torch.solvers import krylov as pk
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    comm = Comm()
    dshape, mg, args = shard
    b = torch.ones((N * N // p,), dtype=torch.float32) * h * h
    res = {}
    for mode, fused in CONFIGS:
        parts = pf.make_dist_solve_local(dshape, mg, args, comm, N, h,
                                         mode=mode, fused=fused)
        stages, _ = ps.build_solve_stages(parts, comm, loop_m=1)
        env = ps.stage_env(parts, comm, b)
        st = pk.pcg_init(parts["apply_a"], b, parts["precond"], comm=comm)
        one = pk.pcg_segment(parts["apply_a"], b, st, parts["precond"],
                             tol=0.0, steps=1, maxiter=10, comm=comm)
        chained = run_stages(stages, dict(env))
        res[("bitwise", mode, fused)] = [
            torch.equal(chained[k], getattr(one, f)) for k, f in
            (("x2", "x"), ("r2", "r"), ("p2", "p"), ("rz2", "rz"),
             ("res", "res"))]
        res[("phases", mode, fused)] = {s.name: s.phase for s in stages}
        res[("stage_bytes", mode, fused)] = {
            s.name: sum(collective_bytes(
                s.fn, *(chained[k] for k in s.inputs), comm=comm).values())
            for s in stages}
        res[("iter_bytes", mode, fused)] = sum(collective_bytes(
            lambda: run_stages(stages, dict(env)), comm=comm).values())
        res[("tcaps", mode, fused)] = parts["tcaps"]
    rng = np.random.default_rng(5)
    nloc = dshape.n_local()
    for nv in NVS:
        x = rng.standard_normal((dshape.n, nv)).astype(np.float32)
        xl = torch.as_tensor(x[rank * nloc:(rank + 1) * nloc])
        for mode in MV_MODES:
            res[("mv", mode, nv)] = collective_bytes(
                td.dist_h2_matvec_local, dshape, args[0], xl, comm, mode,
                comm=comm)
    parts = pf.make_dist_solve_local(dshape, mg, args, comm, N, h,
                                     maxiter=10)
    for flag in (True, False):
        trace.set_enabled(flag)
        rec = _Ops()
        with rec:
            sol = parts["fn"](b)
        res[("neutral", flag)] = (rec.ops, sol.x, sol.res_history)
    trace.set_enabled(True)
    _, _, secs, cum = ps.profile_stages(parts, comm, b, reps=2, loop_m=1)
    res["stages"] = (secs, cum)
    res["doc"] = ps.profile_rank(comm, dshape, mg, args, N, h, maxiter=10,
                                 reps=2, loop_m=1)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def problem():
    prob = pf.FractionalProblem(N, device="cpu", backend="torch").build()
    return prob, {p: pf.build_dist_problem(prob, p, device="cpu")
                  for p in P_GROUPS}


@pytest.fixture(scope="module")
def groups(problem, tmp_path_factory):
    """Per p, every rank's results ``{p: [rank results]}``; all groups
    spawned at once, one deadline."""
    prob, built = problem
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = {}
    for p in P_GROUPS:
        (tmp / f"p{p}").mkdir()
        init = f"file://{tmp / f'p{p}' / 'rendezvous'}"
        dshape, mg, stacked = built[p]
        procs[p] = [ctx.Process(target=_rank_main, args=(
            r, p, init, str(tmp / f"p{p}"),
            (dshape, mg, pf.local_args(dshape, mg, stacked, r)), prob["h"]))
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
        f"{RANK_TIMEOUT_S} s"
    out = {}
    for p, group in procs.items():
        codes = [pr.exitcode for pr in group]
        assert codes == [0] * p, f"p={p}: rank exit codes {codes}"
        out[p] = [torch.load(tmp / f"p{p}" / f"rank{r}.pt",
                             weights_only=False) for r in range(p)]
    return out


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("p", P_GROUPS)
def test_stages_chain_to_one_iteration(groups, p, cfg):
    for r, res in enumerate(groups[p]):
        assert all(res[("bitwise",) + cfg]), (r, res[("bitwise",) + cfg])


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("p", P_GROUPS)
def test_stage_bytes_equal_phase_model(problem, groups, p, cfg):
    """Each phase's stages received exactly the model's bytes on every
    rank, and the chained iteration exactly ``dist_solve_comm_bytes``."""
    dshape, mg, _ = problem[1][p]
    mode, fused = cfg
    for r, res in enumerate(groups[p]):
        tcaps = res[("tcaps",) + cfg]
        model = ps.phase_comm_model(dshape, mg, mode, tcaps=tcaps,
                                    fused=fused)
        got = {ph: 0 for ph in ps.PHASE_ORDER}
        for name, ph in res[("phases",) + cfg].items():
            got[ph] += res[("stage_bytes",) + cfg][name]
        assert got == model, (r, cfg)
        assert res[("iter_bytes",) + cfg] == pf.dist_solve_comm_bytes(
            dshape, mg, mode, tcaps=tcaps, fused=fused) == \
            sum(model.values())


@pytest.mark.parametrize("nv", NVS)
@pytest.mark.parametrize("mode", MV_MODES)
@pytest.mark.parametrize("p", P_GROUPS)
def test_matvec_bytes_equal_model(problem, groups, p, mode, nv):
    dshape = problem[1][p][0]
    want = td.matvec_comm_bytes(dshape, nv, mode)
    for r, res in enumerate(groups[p]):
        by_kind = res[("mv", mode, nv)]
        assert sum(by_kind.values()) == want, (r, by_kind, want)
    root = (p - 1) * dshape.ranks[dshape.lc] * nv * 4
    assert groups[p][0][("mv", mode, nv)]["all-gather"] >= root


@pytest.mark.parametrize("p", P_GROUPS)
def test_dist_solve_neutral(groups, p):
    """Every rank of the distributed solve dispatches the same operations
    with tracing on and off, collectives included, and gets the same
    bits."""
    for r, res in enumerate(groups[p]):
        (ops_on, x_on, h_on), (ops_off, x_off, h_off) = \
            res[("neutral", True)], res[("neutral", False)]
        assert ops_on == ops_off, r
        assert any(op.startswith("c10d.") for op in ops_on)
        assert torch.equal(x_on, x_off)
        assert torch.equal(h_on.nan_to_num(-1.0), h_off.nan_to_num(-1.0))


@pytest.mark.parametrize("p", P_GROUPS)
def test_profile_stages(groups, p):
    """``profile_stages``: seconds per iteration for every phase (the
    slowest rank's rounds, so the same on every rank) and the cumulative
    loop medians of the ten stages."""
    secs, cum = groups[p][0]["stages"]
    assert list(secs) == list(ps.PHASE_ORDER)
    assert all(v >= 0 for v in secs.values())
    assert len(cum) == 10 and all(v > 0 for v in cum.values())
    assert all(res["stages"] == (secs, cum) for res in groups[p])


SUMMARY_KEYS = {"iters", "whole_solve_us", "whole_us_per_iter",
                "stage_sum_us_per_iter", "clamped_sum_us_per_iter", "loop_m",
                "full_loop_us", "loop_baseline_us", "attributed_us",
                "coverage", "fused", "model_comm_bytes_per_iter"}


@pytest.mark.parametrize("p", P_GROUPS)
def test_report_document(groups, p):
    """The reference's document: per mode a summary with coverage, one
    record per phase with measured and modeled bytes (equal), times from
    the slowest rank (the same on every rank), and the gap table."""
    docs = [res["doc"] for res in groups[p]]
    doc = docs[0]
    assert doc["phase_order"] == list(ps.PHASE_ORDER) and doc["p"] == p
    assert set(doc["summary"]) == {"halo-plan", "allgather"}
    for mode, summ in doc["summary"].items():
        assert SUMMARY_KEYS <= set(summ)
        assert summ["measured_comm_bytes_per_iter"] == \
            summ["model_comm_bytes_per_iter"]
        assert summ["coverage"] > 0 and summ["iters"] <= 10
    assert len(doc["phases"]) == 2 * len(ps.PHASE_ORDER)
    for rec in doc["phases"]:
        assert rec.get("measured_comm_bytes", 0) == rec["model_comm_bytes"]
        assert rec["us"] >= 0 and rec["model_bytes"] > 0
    flops = {r["phase"]: r.get("model_flops", 0) for r in doc["phases"]
             if r["comm"] == "halo-plan"}
    assert flops["hgemv/coupling-gemm"] > 0 and flops["precond/vcycle"] > 0
    assert [g["phase"] for g in doc["gap"]] and \
        sorted(g["phase"] for g in doc["gap"]) == sorted(ps.PHASE_ORDER)
    for other in docs[1:]:
        assert [r["us"] for r in other["phases"]] == \
            [r["us"] for r in doc["phases"]]


def test_cli_writes_report_and_trace(tmp_path):
    js, tr = tmp_path / "out" / "doc.json", tmp_path / "out" / "trace.json"
    argv = ["--device", "cpu", "--p", "2", "--n", "16", "--maxiter", "10",
            "--reps", "2", "--loop-m", "1", "--json", str(js),
            "--trace", str(tr)]
    ps.main(argv)
    doc = json.loads(js.read_text())
    assert set(doc["summary"]) == {"halo-plan", "allgather"}
    ev = json.loads(tr.read_text())["traceEvents"]
    lanes = {e["args"]["name"] for e in ev if e.get("name") == "thread_name"}
    assert lanes == {"halo-plan", "allgather"}
    xs = [e for e in ev if e.get("ph") == "X"]
    assert {e["name"] for e in xs} == set(ps.PHASE_ORDER)
    assert len({e["tid"] for e in xs}) == 2
