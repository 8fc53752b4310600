"""Per-phase profile of the distributed fractional solve (the reference's
``repro/obs/profile_solve.py``).

``python -m repro_torch.obs.profile_solve`` solves the §6.4 problem over
``--p`` gloo ranks (spawned processes; each gets its views of one
partition through a queue, CUDA IPC on the card) for the ``halo-plan`` and
``allgather`` comm modes and attributes the measured time of one PCG
iteration to the named phases

    solve/transpose-in  -> hgemv/upsweep -> hgemv/exchange
    -> hgemv/coupling-gemm -> hgemv/downsweep -> solve/transpose-out
    -> solve/stencil    -> precond/vcycle -> krylov/scalars

by **segmented replay** (``obs.timers``): the iteration is cut at those
phase boundaries into stage functions over one rank's local tensors that
call the SAME per-rank bodies as the solve (``core.dist``, ``core.halo``,
``solvers.mg``, the Krylov dots).  The scalar block is cut in two around
the V-cycle (both halves attributed to ``krylov/scalars``), so the chained
stages are one iteration of ``make_dist_solve_local``'s PCG bit for bit;
the reference's nine-stage chain preconditions the old residual instead.
Stages are timed by **truncated-loop differencing**: ``loops[k]`` runs
``loop_m`` iterations of stages 1..k with fixed inputs, and stage k's
per-iteration time is the per-round difference ``(T(loop_k) -
T(loop_{k-1})) / loop_m`` (median over interleaved rounds, clamped at 0).
Differencing cancels the fixed per-call cost; the sum telescopes to the
full iteration.  Eager PyTorch drops no dead work, so the reference's
1e-30 fold of every output back into the carry (which kept XLA from
eliding or hoisting stages) is not needed.

Across ranks every timed program starts after a ``comm.barrier()``, each
rank times it on its own device-synchronized clock, and a round counts as
its slowest rank's time; the per-rank times are gathered once, after the
rounds.  Every per-phase row joins the measured time with the modeled
flops and bytes (``perf.op_cost`` on the plain-backend stages, summed over
the ranks), the analytic comm model (``phase_comm_model``, the per-phase
split of ``dist_solve_comm_bytes``) and the bytes ``Comm`` counted
(``perf.comm_cost``, rank 0's).

Output: a JSON document (per-phase records, a per-mode summary with the
coverage of a capped whole solve, and the halo-plan-vs-allgather gap
table) and a Chrome trace, one lane per comm mode.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.trace import phase

MARKER = "PROFILE_SOLVE_JSON:"

#: the phases of one iteration, in the reference's replay order
PHASE_ORDER = (
    "solve/transpose-in", "hgemv/upsweep", "hgemv/exchange",
    "hgemv/coupling-gemm", "hgemv/downsweep", "solve/transpose-out",
    "solve/stencil", "precond/vcycle", "krylov/scalars",
)

#: the pipeline's external inputs -- argument order of the loop programs
EXT_INPUTS = ("d", "aux", "mga", "xvec", "r", "pvec", "rz")

RANK_TIMEOUT_S = 1200


def phase_comm_model(dshape, mg, mode: str, bytes_per_el: int = 4,
                     tcaps=None, fused=None) -> Dict[str, int]:
    """Per-phase decomposition of ``dist_solve_comm_bytes`` -- modeled
    per-rank bytes received by ONE PCG iteration, keyed by phase.  The
    terms sum exactly to ``dist_solve_comm_bytes(dshape, mg, mode,
    tcaps=tcaps, fused=fused)`` for the matching schedule: pass
    ``tcaps``/``fused`` from ``make_dist_solve_local``'s parts for the
    fused iteration (all-to-all transpositions carrying the stencil halo,
    merged H^2 exchange, deep-halo V-cycle)."""
    from repro_torch.apps.fractional import _fused_default
    from repro_torch.core.dist import (matvec_comm_bytes,
                                       merged_exchange_bytes)
    from repro_torch.solvers.mg import mg_halo_bytes

    p = dshape.p
    if p <= 1:
        return {ph: 0 for ph in PHASE_ORDER}
    root = (p - 1) * dshape.ranks[dshape.lc] * bytes_per_el
    if _fused_default(fused, mode) and tcaps is not None:
        cap_in, cap_out = tcaps
        exch = merged_exchange_bytes(dshape, 1, mode, bytes_per_el) \
            if mode.startswith("halo-plan") \
            else matvec_comm_bytes(dshape, 1, mode, bytes_per_el) - root
        return {
            "solve/transpose-in": (p - 1) * (cap_in + mg.levels[0])
            * bytes_per_el,                    # + stencil-halo lanes
            "hgemv/upsweep": root,             # branch-root all_gather
            "hgemv/exchange": exch,
            "hgemv/coupling-gemm": 0,
            "hgemv/downsweep": 0,
            "solve/transpose-out": (p - 1) * cap_out * bytes_per_el,
            "solve/stencil": 0,                # rode the transpose-in a2a
            "precond/vcycle": mg_halo_bytes(
                mg, bytes_per_el, fused=True,
                bf16=mode.endswith("-bf16")),
            "krylov/scalars": 3 * (p - 1) * bytes_per_el,
        }
    mv = matvec_comm_bytes(dshape, 1, mode, bytes_per_el)
    tr = (p - 1) * (dshape.n // p) * bytes_per_el
    return {
        "solve/transpose-in": tr,
        "hgemv/upsweep": root,                 # branch-root all_gather
        "hgemv/exchange": mv - root,
        "hgemv/coupling-gemm": 0,
        "hgemv/downsweep": 0,
        "solve/transpose-out": tr,
        "solve/stencil": 2 * mg.levels[0] * bytes_per_el,
        "precond/vcycle": mg_halo_bytes(mg, bytes_per_el),
        "krylov/scalars": 3 * (p - 1) * bytes_per_el,
    }


def build_solve_stages(parts: Dict, comm, loop_m: int = 12,
                       backend: Optional[str] = None):
    """Cut one PCG iteration of the distributed solve into replay stages.

    ``parts`` is ``make_dist_solve_local``'s return value (its comm mode
    must be a ``halo-plan`` one or ``allgather``: the ``ppermute`` modes
    interleave their exchange with the products).  Each stage is a plain
    function over this rank's local tensors calling the same bodies as
    ``_dist_apply_a`` and ``_pcg_step``, in the same order, so the chained
    stages give the iteration bit for bit; ``backend`` (default: the
    parts') selects the ``halo_pack`` route (``"torch"`` for cost walks).
    Returns ``(stages, loops)``: ``timers.Stage`` objects (feed them
    ``stage_env``'s environment; two of them, ``krylov/update`` and
    ``krylov/direction``, are attributed to ``krylov/scalars``) and the
    truncated-loop programs ``loops[k]`` = ``loop_m`` iterations of stages
    1..k on fixed inputs (args = ``EXT_INPUTS``; ``loops[0]`` is the
    empty baseline).
    """
    from repro_torch.core.dist import (_coupling_phase,
                                       _coupling_phase_overlap,
                                       _dense_phase, _hp_pack_exchange,
                                       _local_downsweep, _local_upsweep)
    from repro_torch.core.halo import transpose_a2a
    from repro_torch.obs.timers import Stage
    from repro_torch.solvers.krylov import _dot, _norm
    from repro_torch.solvers.mg import _apply_op as _mg_apply_op
    from repro_torch.solvers.mg import mg_precond_local

    dshape, mg = parts["dshape"], parts["mg"]
    n, h, mode = parts["n"], parts["h"], parts["mode"]
    schedule = parts["schedule"]
    backend = backend or parts["backend"]
    if not (mode.startswith("halo-plan") or mode == "allgather"):
        raise ValueError(f"profiled comm modes are halo-plan* and "
                         f"allgather, not {mode!r}")
    p, me = dshape.p, comm.rank
    nl, m = dshape.leaves_per_dev, dshape.leaf_size
    lc, depth = dshape.lc, dshape.depth
    fused = bool(parts["fused"]) and p > 1
    hide = parts["hide"] if fused else 0
    bf16 = mode.endswith("-bf16")
    rows = n // p
    tables: dict = {}

    def leaves(xt):
        return xt.reshape(nl, m, 1).contiguous()

    if fused:
        tin, tout = parts["packs"]

        def s_transpose_in(aux, x):
            x2d = x.reshape(rows, n)
            with phase("solve/transpose-in"):
                extra = x.new_zeros((p, n))
                if me + 1 < p:
                    extra[me + 1] = x2d[-1]
                if me >= 1:
                    extra[me - 1] = x2d[0]
                xt, ex = transpose_a2a(x, aux["tin_send"], aux["tin_take"],
                                       comm, extra=extra, backend=backend,
                                       pack=tin)
            return xt[:, None], ex
        tin_outputs = ("xt", "ex")
    else:
        def s_transpose_in(aux, x):
            with phase("solve/transpose-in"):
                xf = comm.all_gather(x) if p > 1 else x
                return xf.index_select(0, aux["perm"])[:, None]
        tin_outputs = ("xt",)

    def s_upsweep(d, xt):
        return _local_upsweep(dshape, d, leaves(xt), comm)

    if mode.startswith("halo-plan"):
        def s_exchange(d, xt, sweep):
            with phase("hgemv/exchange"):
                return _hp_pack_exchange(dshape, d, sweep[0], leaves(xt),
                                         comm, mode, backend,
                                         merged=hide > 0, tables=tables)()

        def s_coupling(d, xt, sweep, payload):
            return _coupling_phase_overlap(
                dshape, d, sweep[0], sweep[1], leaves(xt), comm, mode,
                backend, schedule, hide, tables, chunks=payload)
    else:
        def s_exchange(d, xt, sweep):
            xhat = sweep[0]
            with phase("hgemv/exchange"):
                gl = {l: comm.all_gather(xhat[l])
                      for l in range(lc, depth + 1) if dshape.ranks[l]}
                return gl, comm.all_gather(leaves(xt))

        def s_coupling(d, xt, sweep, payload):
            yhat, ytop = _coupling_phase(dshape, d, sweep[0], sweep[1],
                                         comm, mode, gathered=payload[0])
            yde = _dense_phase(dshape, d, leaves(xt), comm, mode,
                               gathered=payload[1])
            return yhat, ytop, yde

    def s_downsweep(d, coupled):
        yhat, ytop, yde = coupled
        y_lr = _local_downsweep(dshape, d, yhat, ytop, comm)
        return (y_lr + yde).reshape(dshape.n_local(), 1)[:, 0]

    if fused:
        def s_transpose_out(aux, kut):
            with phase("solve/transpose-out"):
                ku, _ = transpose_a2a(kut, aux["tout_send"],
                                      aux["tout_take"], comm,
                                      backend=backend, pack=tout)
            return ku

        def s_stencil(mga, x, ku, ex):
            with phase("solve/stencil"):
                zero = x.new_zeros((1, n))
                top = ex[me - 1:me] if me >= 1 else zero
                bot = ex[me + 1:me + 2] if me <= p - 2 else zero
                local = _mg_apply_op(mg, mga, 0, x.reshape(rows, n), comm,
                                     halo=(top, bot)).reshape(x.shape)
                return (h * h) * (ku + local)
        sten_inputs = ("mga", "pvec", "ku", "ex")
    else:
        def s_transpose_out(aux, kut):
            with phase("solve/transpose-out"):
                kf = comm.all_gather(kut) if p > 1 else kut
                return kf.index_select(0, aux["unperm"])

        def s_stencil(mga, x, ku):
            with phase("solve/stencil"):
                local = _mg_apply_op(mg, mga, 0, x.reshape(rows, n),
                                     comm).reshape(x.shape)
                return (h * h) * (ku + local)
        sten_inputs = ("mga", "pvec", "ku")

    def s_update(x, r, pv, ap, rz):
        # _pcg_step's scalar block up to the preconditioner
        with phase("krylov/scalars"):
            pap = _dot(pv, ap, None, comm)
            alpha = rz / torch.where(pap != 0, pap, 1.0)
            x2 = x + alpha * pv
            r2 = r - alpha * ap
            return x2, r2, _norm(r2, None, comm)

    def s_precond(mga, r):
        if parts["precond"] is None:
            return r
        with phase("krylov/precond"):
            return mg_precond_local(mg, mga, r, comm, fused=parts["fused"],
                                    bf16=bf16)

    def s_direction(r, z, pv, rz):
        # ... and after it
        with phase("krylov/scalars"):
            rz2 = _dot(r, z, None, comm)
            beta = rz2 / torch.where(rz != 0, rz, 1.0)
            return rz2, z + beta * pv

    stages = [
        Stage("solve/transpose-in", s_transpose_in, ("aux", "pvec"),
              tin_outputs),
        Stage("hgemv/upsweep", s_upsweep, ("d", "xt"), ("sweep",)),
        Stage("hgemv/exchange", s_exchange, ("d", "xt", "sweep"),
              ("payload",)),
        Stage("hgemv/coupling-gemm", s_coupling,
              ("d", "xt", "sweep", "payload"), ("coupled",)),
        Stage("hgemv/downsweep", s_downsweep, ("d", "coupled"), ("kut",)),
        Stage("solve/transpose-out", s_transpose_out, ("aux", "kut"),
              ("ku",)),
        Stage("solve/stencil", s_stencil, sten_inputs, ("ap",)),
        Stage("krylov/update", s_update, ("xvec", "r", "pvec", "ap", "rz"),
              ("x2", "r2", "res"), phase="krylov/scalars"),
        Stage("precond/vcycle", s_precond, ("mga", "r2"), ("z",)),
        Stage("krylov/direction", s_direction, ("r2", "z", "pvec", "rz"),
              ("rz2", "p2"), phase="krylov/scalars"),
    ]

    def make_loop(k: int) -> Callable:
        def prog(*ext):
            out = None
            for _ in range(loop_m):
                env = dict(zip(EXT_INPUTS, ext))
                for s in stages[:k]:
                    out = s.fn(*(env[nm] for nm in s.inputs))
                    if len(s.outputs) == 1:
                        env[s.outputs[0]] = out
                    else:
                        env.update(zip(s.outputs, out))
            return out
        return prog

    return stages, [make_loop(k) for k in range(len(stages) + 1)]


def stage_env(parts: Dict, comm, b: torch.Tensor) -> Dict:
    """Initial replay environment: this rank's operator views and the
    solver state after ``pcg_init`` on ``b`` (its grid-order strip), so
    the stages see the operands of a real first iteration."""
    from repro_torch.solvers.krylov import pcg_init

    d, aux, mga = parts["args"]
    st = pcg_init(parts["apply_a"], b, parts["precond"], comm=comm)
    return {"d": d, "aux": aux, "mga": mga, "xvec": st.x, "r": st.r,
            "pvec": st.p, "rz": st.rz}


def _slowest(acc: Dict[str, List[float]], comm) -> Dict[str, List[float]]:
    """Each round's slowest rank: one gather of every rank's times."""
    names = list(acc)
    t = torch.tensor([acc[k] for k in names], dtype=torch.float64)
    if comm.p > 1:
        t = comm.all_gather(t[None]).amax(dim=0)
    return {k: t[i].tolist() for i, k in enumerate(names)}


def _stage_secs(stages, acc: Dict[str, List[float]], loop_m: int,
                key: Callable[[int], str]) -> Dict[str, float]:
    """Per-stage seconds per iteration from the loop times (``key(k)`` is
    loop k's entry of ``acc``), clamped at 0."""
    out = {}
    for k, s in enumerate(stages, start=1):
        diffs = [a - b for a, b in zip(acc[key(k)], acc[key(k - 1)])]
        out[s.name] = max(float(np.median(diffs)), 0.0) / loop_m
    return out


def _by_phase(stages, per_stage: Dict[str, float]) -> Dict[str, float]:
    out = {ph: 0.0 for ph in PHASE_ORDER}
    for s in stages:
        out[s.phase] += per_stage[s.name]
    return out


def profile_stages(parts: Dict, comm, b: torch.Tensor, reps: int = 8,
                   loop_m: int = 12):
    """Build, warm and time the replay pipeline of one rank by
    truncated-loop differencing (every rank of ``comm`` calls it).

    Returns ``(stages, env, phase_secs, cum_secs)``: the stage functions,
    the populated replay environment, {phase: seconds per iteration} and
    the cumulative loop medians (seconds, slowest rank) keyed by stage.
    """
    from repro_torch.obs.timers import interleaved_times, run_stages

    stages, loops = build_solve_stages(parts, comm, loop_m=loop_m)
    env = run_stages(stages, stage_env(parts, comm, b))
    ext = tuple(env[k] for k in EXT_INPUTS)
    fns = {f"p{k}": (lambda lp=lp: lp(*ext)) for k, lp in enumerate(loops)}
    acc = _slowest(interleaved_times(fns, reps=reps, warmup=1,
                                     before=comm.barrier), comm)
    per_stage = _stage_secs(stages, acc, loop_m, lambda k: f"p{k}")
    cum = {s.name: float(np.median(acc[f"p{k}"]))
           for k, s in enumerate(stages, start=1)}
    return stages, env, _by_phase(stages, per_stage), cum


def profile_rank(comm, dshape, mg, args, n: int, h: float,
                 modes: Sequence[str] = ("halo-plan", "allgather"),
                 tol: float = 1e-8, maxiter: int = 200, reps: int = 8,
                 loop_m: int = 12, backend: str = "cuda") -> Dict:
    """One rank's part of the profile (every rank of ``comm`` calls it
    with its ``local_args`` views): per comm mode, the capped whole solve
    (``maxiter`` iterations at most) and the truncated loops, timed in ONE
    interleaved set so that the coverage ratios and the gap table see the
    same machine state; then per phase the records.  Returns the report
    document (times: slowest rank; bytes: this rank's)."""
    from repro_torch.apps.fractional import (dist_solve_comm_bytes,
                                             make_dist_solve_local)
    from repro_torch.obs import metrics
    from repro_torch.obs.timers import interleaved_times, run_stages
    from repro_torch.perf.comm_cost import collective_bytes
    from repro_torch.solvers.krylov import SEGMENT_STEPS

    dev = args[0].u_leaf.device
    p = comm.p
    b = torch.ones((n * n // p,), dtype=torch.float32, device=dev) * h * h
    built: Dict[str, tuple] = {}
    fns: Dict[str, Callable] = {}
    for mode in modes:
        parts = make_dist_solve_local(dshape, mg, args, comm, n, h,
                                      mode=mode, tol=tol, maxiter=maxiter,
                                      backend=backend)
        res = parts["fn"](b)
        stages, loops = build_solve_stages(parts, comm, loop_m=loop_m)
        env = run_stages(stages, stage_env(parts, comm, b))
        ext = tuple(env[k] for k in EXT_INPUTS)
        built[mode] = (parts, res, stages, env)
        fns[f"{mode}|solve"] = (lambda parts=parts: parts["fn"](b))
        for k, lp in enumerate(loops):
            fns[f"{mode}|p{k}"] = (lambda lp=lp, ext=ext: lp(*ext))
    acc = _slowest(interleaved_times(fns, reps=reps, warmup=1,
                                     before=comm.barrier), comm)

    doc: Dict = {"bench": "solver_phases", "n": n, "N": n * n, "p": p,
                 "tol": tol, "maxiter": maxiter, "device": str(dev),
                 "phase_order": list(PHASE_ORDER), "summary": {},
                 "phases": []}
    phase_us_by_mode: Dict[str, Dict[str, float]] = {}
    for mode in modes:
        parts, res, stages, env = built[mode]
        per_stage = _stage_secs(stages, acc, loop_m,
                                lambda k, m_=mode: f"{m_}|p{k}")
        phase_us = {k: v * 1e6 for k, v in _by_phase(stages,
                                                      per_stage).items()}
        cum_us = {s.name: float(np.median(acc[f"{mode}|p{k}"])) * 1e6
                  for k, s in enumerate(stages, start=1)}
        phase_us_by_mode[mode] = phase_us
        tcaps = parts["tcaps"] if p > 1 else None
        model = phase_comm_model(dshape, mg, mode, tcaps=tcaps,
                                 fused=parts["fused"])
        # cost walks and byte counts on the plain-backend stages, each
        # phase's stages run on the replay environment's fixed inputs
        plain, _ = build_solve_stages(parts, comm, loop_m=1,
                                      backend="torch")
        for ph in PHASE_ORDER:
            mine = [s for s in plain if s.phase == ph]

            def run_phase(mine=mine):
                return [s.fn(*(env[k] for k in s.inputs)) for s in mine]
            rec = metrics.phase_record(
                ph, us=round(phase_us[ph], 1), fn=run_phase,
                model_comm_bytes=model[ph], p=p, comm=comm,
                us_loop_cum=round(cum_us[mine[-1].name], 1))
            rec.extra["comm"] = mode
            doc["phases"].append(rec.to_dict())

        env0 = stage_env(parts, comm, b)
        iter_bytes = sum(collective_bytes(
            lambda: run_stages(plain, env0), comm=comm).values())
        whole_us = float(np.median(acc[f"{mode}|solve"])) * 1e6
        kmax = len(stages)
        # the telescoped per-iteration sum: sum_k (T_k - T_{k-1}) is
        # T_kmax - T_0 identically, so its per-round median carries none
        # of the upward bias that clamping adds to the table's rows
        per_iter = float(np.median(
            [(a - b_) / loop_m for a, b_ in
             zip(acc[f"{mode}|p{kmax}"], acc[f"{mode}|p0"])])) * 1e6
        iters = int(res.iters)
        # the solver runs whole segments: masked steps past the end cost
        # a full iteration each
        steps_run = min(math.ceil(iters / SEGMENT_STEPS),
                        math.ceil(maxiter / SEGMENT_STEPS)) * SEGMENT_STEPS
        # + the prologue (initial precond and the first dots)
        attributed = per_iter * steps_run + phase_us["precond/vcycle"] \
            + phase_us["krylov/scalars"]
        doc["summary"][mode] = {
            "iters": iters,
            "iterations_run": steps_run,
            "converged": bool(res.converged),
            "whole_solve_us": round(whole_us, 1),
            "whole_us_per_iter": round(whole_us / max(steps_run, 1), 1),
            "stage_sum_us_per_iter": round(per_iter, 1),
            "clamped_sum_us_per_iter": round(sum(phase_us.values()), 1),
            "loop_m": loop_m,
            "full_loop_us": round(cum_us[stages[-1].name], 1),
            "loop_baseline_us": round(
                float(np.median(acc[f"{mode}|p0"])) * 1e6, 1),
            "attributed_us": round(attributed, 1),
            "coverage": round(attributed / whole_us, 3),
            "fused": bool(parts["fused"]),
            "model_comm_bytes_per_iter": dist_solve_comm_bytes(
                dshape, mg, mode, tcaps=tcaps, fused=parts["fused"]),
            "measured_comm_bytes_per_iter": iter_bytes,
        }

    if "halo-plan" in phase_us_by_mode and "allgather" in phase_us_by_mode:
        hp, ag = (phase_us_by_mode["halo-plan"],
                  phase_us_by_mode["allgather"])
        gap = [{"phase": ph, "halo_plan_us": round(hp[ph], 1),
                "allgather_us": round(ag[ph], 1),
                "delta_us": round(hp[ph] - ag[ph], 1)}
               for ph in PHASE_ORDER]
        gap.sort(key=lambda g: -g["delta_us"])
        doc["gap"] = gap
        doc["gap_phases"] = [g["phase"] for g in gap if g["delta_us"] > 0]
    return doc


# ---------------------------------------------------------------------------
# the CLI: spawned gloo ranks
# ---------------------------------------------------------------------------

def _worker(rank: int, p: int, init: str, out_dir: str, inbox,
            device: str, cfg: Dict) -> None:
    """One spawned rank: joins the gloo group, takes its views of the
    partition from ``inbox`` and runs ``profile_rank``; rank 0 writes the
    document to ``out_dir``."""
    import gc

    import torch.distributed as dist

    from repro_torch.core.comm import Comm

    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    dshape, mg, args = inbox.get()
    doc = profile_rank(Comm(), dshape, mg, args, **cfg)
    if rank == 0:
        with open(os.path.join(out_dir, "doc.json"), "w") as f:
            json.dump(doc, f)
    del args
    gc.collect()                    # the shared views' last references
    if device == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()


def run_profile(argv: Optional[Sequence[str]] = None) -> Dict:
    """Build the problem on ``--device``, partition it for ``--p`` ranks,
    spawn them (each gets its views through a queue) and return rank 0's
    report document.  A rank that fails or is still running at the
    deadline (then terminated) raises."""
    from repro_torch.apps.fractional import (FractionalProblem,
                                             build_dist_problem,
                                             local_args)

    args = _parse(argv)
    n = args.n or (16 if args.quick else 32)
    backend = "cuda" if args.device == "cuda" else "torch"
    prob = FractionalProblem(n, device=args.device, backend=backend).build()
    dshape, mg, stacked = build_dist_problem(prob, args.p,
                                             device=args.device)
    cfg = dict(n=n, h=prob["h"], modes=tuple(args.comms.split(",")),
               tol=args.tol, maxiter=args.maxiter,
               reps=args.reps or (4 if args.quick else 8),
               loop_m=args.loop_m, backend=backend)
    del prob
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        inboxes = [ctx.SimpleQueue() for _ in range(args.p)]
        procs = [ctx.Process(target=_worker, args=(
            r, args.p, init, tmp, inboxes[r], args.device, cfg))
            for r in range(args.p)]
        t0 = time.monotonic()
        for pr in procs:
            pr.start()
        for r, box in enumerate(inboxes):
            box.put((dshape, mg, local_args(dshape, mg, stacked, r)))
        try:
            for pr in procs:
                pr.join(max(1.0, RANK_TIMEOUT_S - (time.monotonic() - t0)))
        finally:
            hung = [pr for pr in procs if pr.is_alive()]
            for pr in hung:
                pr.terminate()
                pr.join()
        codes = [pr.exitcode for pr in procs]
        if hung or codes != [0] * args.p:
            raise RuntimeError(f"profile_solve ranks failed: exit codes "
                               f"{codes}, {len(hung)} hung")
        with open(os.path.join(tmp, "doc.json")) as f:
            return json.load(f)


def write_outputs(doc: Dict, json_path: str, trace_path: str) -> None:
    from repro_torch.obs.export import write_chrome_trace

    for path in (json_path, trace_path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(doc, f, indent=1)
    lanes = []
    for mode, summ in doc["summary"].items():
        phase_us = {r["phase"]: r["us"] for r in doc["phases"]
                    if r.get("comm") == mode}
        lanes.append({"lane": mode, "phase_us": phase_us,
                      "iters": summ["iters"]})
    write_chrome_trace(trace_path, lanes)


def _parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="per-phase profile of the distributed fractional "
                    "solve (segmented replay over gloo ranks)")
    ap.add_argument("--worker", action="store_true",
                    help="print the document as one marked line instead "
                         "of writing the files")
    ap.add_argument("--quick", action="store_true",
                    help="smoke tier (n=16, fewer rounds)")
    ap.add_argument("--n", type=int, default=0,
                    help="grid side (default 32; 16 with --quick)")
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--maxiter", type=int, default=200,
                    help="iteration cap of the timed whole solve")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--comms", default="halo-plan,allgather")
    ap.add_argument("--reps", type=int, default=0,
                    help="interleaved rounds (default 8; 4 with --quick)")
    ap.add_argument("--loop-m", type=int, default=12,
                    help="iterations of each truncated loop")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", default="build/profile_solve.json")
    ap.add_argument("--trace", default="build/profile_solve_trace.json")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parse(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_solve: no CUDA device; pass --device cpu")
    doc = run_profile(argv)
    if args.worker:
        print(MARKER + json.dumps(doc))
        return
    write_outputs(doc, args.json, args.trace)
    for mode, summ in doc["summary"].items():
        print(f"# {mode}: {summ['iters']} iters ({summ['iterations_run']} "
              f"run), {summ['whole_us_per_iter']} us/iter whole, "
              f"{summ['stage_sum_us_per_iter']} us/iter replayed, "
              f"coverage {summ['coverage']}, bytes/iter "
              f"{summ['measured_comm_bytes_per_iter']} (model "
              f"{summ['model_comm_bytes_per_iter']})")
    for g in doc.get("gap", [])[:3]:
        print(f"# gap {g['phase']}: {g['delta_us']:+.1f} us/iter "
              f"(halo-plan {g['halo_plan_us']} vs allgather "
              f"{g['allgather_us']})")
    print(f"# wrote {args.json} + {args.trace}")


if __name__ == "__main__":
    main(sys.argv[1:])
