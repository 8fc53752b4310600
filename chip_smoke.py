#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # N = 2^20, as the project's H100 check
    python3 chip_smoke.py --log2n 14      # a quicker, smaller run

In order: the card's name and power limit; the build of the five CUDA
kernels from ``src/repro_torch/csrc``; each kernel against its plain PyTorch
version at the main path's shapes and at edge cases, with its time, the
plain version's time, a library call's time and the roofline bound (QR
and SVD on every route their planners pick, also against float64, and the
rank-deficient QR question over 12 seeds)
(``batched_gemm`` at every HGEMV shape beside ``torch.bmm``, with the path
its planner chose and its host time per call; ``halo_pack`` as rank 0's
whole exchange in one launch, once the partition exists); then the
main path at N = 2^20 (2D exponential kernel, l = 0.1, leaf 64, Chebyshev
p = 6, eta = 0.9): ``construct_h2`` -> ``h2_matvec`` -> ``compress(tol=1e-3)``
-> ``h2_matvec``, held to the plain backend on the card, to exact kernel rows
computed in float64, and the compressed product to the uncompressed one
(compress timed cold, then warm, and split into its phases by CUDA events;
the launches of ``batched_qr`` and ``batched_svd`` counted per route);
each distinct QR and SVD shape of one warm compress timed on its planned
route, on the general kernel and by ``torch.linalg``; each of the 13
``coupling_mv`` launches of the uncompressed and the compressed HGEMV on
its real inputs, on its planned route and on the general kernel, beside
its byte bound and the plain marshaled route (``coupling_mv`` launches
counted per route: none on the general route on the main path);
then the guard path's operator checks (``[guard]``) on both operators:
``validate_h2`` timed, the compressed HGEMV certified against the
uncompressed one (8 probes, 5e-3), and ``drill_corrupt_operator`` in
"scale" and "nan" mode on shallow copies of the compressed operator
(``backend="cuda"``), each caught by ``validate_h2`` and by its
certificate against the healthy HGEMV (the probes' nv = 8 takes
``coupling_mv``'s general route: logged, not required);
then the first part of the observability checks (``[obs]``): the eager
HGEMV's device operations and bits with tracing on and off
(``obs.trace.set_enabled``), the ``cuda`` and ``torch`` HGEMVs timed by
``obs.timers.interleaved_times`` with their ``median_ratio``, and the
device's idle share over one eager HGEMV from a ``torch.profiler`` trace
(written under ``build/``);
then the distributed path: ``partition_h2`` of that operator over 4 ranks
(``validate_dist_h2`` of it),
and 4 spawned processes in a gloo group sharing the card (payloads staged
through pinned host memory) that run the halo-plan distributed HGEMV
(``halo_pack`` packs every exchange), its plain twin, the allgather
baseline, ``make_dist_compress`` to the main path's ranks and the
compressed distributed HGEMV, each rank held to the single-device rows
(each rank gets its shard through a queue and releases it before exit),
and the same 4 ranks as a 2 x 2 block x nv mesh (``mesh_comm``;
``partition_h2`` over 2 block rows, 8 of the 16 columns per rank): the
joined rows within 1e-5 of the single device's, each rank's received
bytes equal to ``matvec_comm_bytes`` at 8 columns, ``halo_pack`` launched;
then the solve path: ``repro_torch.apps.fractional.solve(512)`` (the §6.4
fractional-diffusion PCG solve with the GMG V-cycle, N = 262,144, h2_tol
1e-6, tol 1e-8, its segments replayed from CUDA graphs; its build
compresses K and runs the extended grid's HGEMV), with its build's parts,
iterations, recurrence and true residuals, graph against eager, one graph
segment against the same eager segment (bitwise), the per-iteration split
of an eager segment by CUDA events, every ``batched_gemm`` of an nv = 1
HGEMV beside ``torch.bmm`` and every ``coupling_mv`` beside its bound; the
same solve on the plain backend (iterations within 2, u within 1e-4); and
``solve(16)`` against the dense direct solve (2e-2); then the distributed
solve: that n = 512 problem partitioned over 4 ranks
(``build_dist_problem``; no second build of the extended operator) and
solved by 4 spawned gloo ranks sharing the card, the fused halo-plan PCG
(``make_dist_solve_local``: plan-compressed all-to-all transpositions
packed by ``halo_pack``, the merged H² exchange, the deep-halo sharded
V-cycle, rank-order psums; eager), every rank held to the same
iterations and status, the gathered u to the single-device one (1e-4),
an iteration's received bytes to ``dist_solve_comm_bytes``, with one
iteration split by phase, and the two-step schedule held to the fused
one over 20 iterations; then the rest of ``[obs]``: the idle share over
10 graph-replayed iterations of the n = 512 solve, and
``obs.profile_solve.profile_rank`` of the ``[dsolve]`` problem over the
same 4 ranks (halo-plan fused, allgather two-step: microseconds per phase
by truncated-loop differencing, the coverage of a whole solve capped at
10 iterations, every rank's counted bytes per phase equal to
``phase_comm_model`` and per iteration to ``dist_solve_comm_bytes``);
then the chaos path (``[chaos]``): the elastic
solve (``solve_elastic_local``) over the same 4 ranks, each handed the
whole stacked partition and the grid arrays: the reference's tripwire on
the distributed solve's final state (the float32 plateau, required under
the floor of the drills' tol 1e-4 with a margin), a fault-free run at tol
1e-4 with checkpoints every 10 iterations (exactly the distributed
solve's iterations and recurrence), a faulted run (a loss to 2 ranks at
segment 3, re-sharded by ``repartition_h2``; a NaN at segment 6 caught
by the tripwire; a straggler at segment 8): restarts 2, 0 iterations
lost to the loss and 10 to the NaN, u within 1e-3, each p = 2 segment's
bytes equal to the model, ``halo_pack`` launched; then, cut to n = 64
at tol 2e-5, the elastic run against the monolithic one (bitwise) and
the bf16 escalation drill; then the sketch path (``[sketch]``): K of the
§6.4 problem at n = 512 by ``construct_h2(method="sketch")``, split by
phase, against 512 exact float64 rows, its bases' orthogonality,
``solve(128, construction="sketch")`` with graphs, and the black box
``construct_from_matvec`` of A = B B at N = 16,384; then each QR/SVD
shape of the construction on its recorded input against its plain
version and beside ``torch.linalg``, the same sketches' bases on the
plain backend, the card's Gaussians against the CPU's bitwise, and the
distance to the ``[solve]`` phase's cheb-built K; then the rest of the
guard path: ``construct_h2_certified`` of that K at n = 512 certified at
1e-3 against ``kernel_reference_apply`` on the card, the rank-starved
drill at n = 128 (more than one round, then certified at 1e-2), and
``solve_with_guards(512)`` twice: with the ``[solve]`` phase's arguments
(accepted on its primary rung, status 0, iterations within 2 of
``[solve]``'s) and with the reference's defaults (every rung printed);
then the serve path (``[serve]``): the solver service
(``repro_torch.serving``) on ``(I + A) x = b`` at N = 2^20, its operator
(the main path's construction compressed at 1e-5) built by a cache miss,
a calibration panel for the iterations per request and the time per
dispatch (beside restarts every 25 iterations, no restart, and the first
dispatch with the Krylov guards on, which trips their stagnation check),
a benchmark on the wall clock at twice the panel's service rate (p50,
p99, throughput, occupancy, a cache hit), the fault drill twice on 16 requests
(reproducible), both degraded paths (per-column ``pcg`` and
``degraded="loose"``), the threaded front-end (4 submitters x 8
requests), every ``ok`` answer recomputed with the plain HGEMV (10 x the
requests' tol 1e-4), and the span trace; and last distributed serving
(``[dserve]``): that operator partitioned over 4 gloo ranks, each running
a ``SolverService(comm=...)`` in lockstep on the halo-plan key (8
requests, panel 8, tol 1e-4, on the wall clock: each dispatch costs the
slowest rank's wall), then, cut to N = 2^14, the local key in this
process, the halo-plan and allgather keys and a NaN drill on the cached
halo-plan resident; every answer recomputed with the plain HGEMV (10 x
tol), the cut ones also against the local service's, every rank's
metrics and dispatch log equal to rank 0's; then the threaded front-end
on distributed keys (``[tserve]``): that cut operator over 4 gloo ranks,
one ``ThreadedSolverService`` per rank in lockstep, rank 0's 4 submitter
threads sending 24 requests (halo-plan key) and 17 (allgather key) into
a queue of 8 (more than a panel of 8 and the queue hold, so the queue
refuses some while the first panel solves), every rid completed once, answers recomputed (10 x tol),
each rank receiving only its own rows of the admitted right-hand sides,
metrics equal on every rank, ``close()`` returned on every rank; the H^2
dry run (``[dryrun]``): one rank's HGEMV (three comm modes, nv 1 and
64), compress and PCG iteration at p = 16 and the HGEMV at p = 32, 2^19
rows a rank, walked on meta tensors with collective bytes equal to the
models, no launch and no allocation on the card; and the LM path
(``[lm]``): ``BatchedServer`` serving qwen3-0.6b at full width and depth
in bfloat16 (8 prompts of 128 tokens, 32 new tokens; prefill, decode,
tokens/s, peak memory), prefill + 1 decode against a prefill of the
extended sequence (float32, 1e-3), the int8 cache's attention on the
served layer-0 cache (3e-2), and the H^2 token mixer at S = 4096, D =
1,024 on the kernels against the plain backend (1e-5), its compress on
the kernels against the plain compress, 64 rows against the dense mix
in float64 and its time beside the dense ``torch.matmul`` mix; and the
other LM families (``[lmfam]``): qwen3-moe-30b-a3b, rwkv6-7b, zamba2-7b,
llama-3.2-vision-11b and whisper-tiny at full width in bfloat16, depth
cut (``LMFAM_DEPTH``), each served by ``BatchedServer`` (8 prompts of 128
tokens, 32 new tokens a request, in vocab; prefill, decode, tokens/s,
peak memory, a decode step's idle share), prefill + k decode steps
against a prefill of s + k tokens in float32 with seeded nonzero stub
inputs (1e-3), and the MoE's dropped choices; no kernel runs there; and
training (``[train]``): ``launch.train.train`` on qwen3-0.6b at full
width and depth in bfloat16 (float32 AdamW moments, PowerSGD rank 4), 4
steps of 4 x 4,096 tokens (ms a step, tokens/s, peak memory, every
step's loss and gradient norm, the step's parts by CUDA events and its
idle share), after its card checks: the attention backward against
naive autograd at qwen3's head shapes (2e-4), every config's reduced
float32 gradients on the card against the CPU's (1e-4), a restart drill
(1 restart, the uninterrupted loss history) and the full parameter tree
through ``CheckpointManager`` (bitwise); no kernel runs there either;
then the LM dry run (``[lmdry]``): the parameter specs and per-device
bytes of all 10 configs at both production layouts, dry cells walked on
``meta`` tensors (per-device flops, matmul flops, bytes, argument bytes;
no launch, no allocation on the card), the abstract parameters and
decode caches equal to real ones made on the card, the ``meta`` walk of
a train step equal to the card's own walk operator by operator, and the
walked flops of ``[train]``'s step and ``[lm]``'s prefill and decode
step beside the rates their measured times imply; and last the LMs under
the sharding rules over 4 spawned gloo ranks on the card as a 2 x 2
``("data", "model")`` mesh (``[lmmesh]``, correctness only): qwen3-0.6b
at full width (4 of 28 layers, float32) serving 4 x 256 prompts and 8
greedy decode steps with its KV heads over ``model`` and context
parallel, training 2 FSDP steps of 4 x 512 tokens with PowerSGD both
ways, and qwen3-moe-30b-a3b (2 of 48 layers, 64 experts a model rank)
serving, each held to the one-device port run on each data shard's rows
(logits 1e-4 of max |logit|, greedy tokens, losses 1e-5, parameters
1e-5, the MoE's drops per data shard), with every rank's bytes by
collective kind; no kernel runs there.
Launch counts are reset just before each path and read just after (graph
replays launch kernels without their wrappers: logged apart).
Any failure raises; the last line is the device JSON only on success.
It needs a CUDA card: without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
TOL = {"batched_gemm": 1e-5, "coupling_mv": 1e-5, "batched_qr": 1e-4,
       "batched_svd": 1e-4, "halo_pack": 0.0}
REPLACES = {
    "batched_gemm": "src/repro/kernels/batched_gemm.py:62",
    "coupling_mv": "src/repro/kernels/coupling_mv.py:82",
    "batched_qr": "src/repro/kernels/batched_qr.py:140",
    "batched_svd": "src/repro/kernels/batched_svd.py:180",
    "halo_pack": "src/repro/kernels/halo_pack.py:49",
}
KERNELS = tuple(REPLACES)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    """A check of the run: raises (and so fails the script) when not met."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Timer:
    """Per-launch device time by CUDA events, L2 flushed before each launch
    (a 256 MB write evicts the 50 MB L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.float32,
                                     device="cuda")

    def once(self, fn) -> tuple:
        """(ms, result) of one cold call of ``fn`` (L2 flushed)."""
        torch = self.torch
        torch.cuda.synchronize()
        self.flush_buf.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out

    def ms(self, fn, reps: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def rel_err(got, want) -> tuple:
    d = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item() or 1.0
    return d, d / scale


# ---------------------------------------------------------------------------
# kernel phase: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def random_plan(torch, rows: int, maxb: int, nodes: int, gen, lo: int = 1):
    """Slot plan of the HGEMV's layout: rows x maxb slots, cnt[r] in
    [lo, maxb] blocks in the leading slots of row r (row 1 empty), sentinel
    nb in the padding slots."""
    cnt = torch.randint(lo, maxb + 1, (rows,), generator=gen, dtype=torch.int32)
    cnt[0] = maxb
    cnt[1] = 0                                          # an empty row
    nb = int(cnt.sum())
    slot = torch.arange(maxb, dtype=torch.int32)[None, :]
    used = slot < cnt[:, None]
    blk = torch.full((rows, maxb), nb, dtype=torch.int32)
    blk[used] = torch.arange(nb, dtype=torch.int32)
    col = torch.zeros((rows, maxb), dtype=torch.int32)
    col[used] = torch.randint(0, nodes, (nb,), generator=gen, dtype=torch.int32)
    return blk.reshape(-1), col.reshape(-1), cnt, nb


def svd_flops(nb: int, n: int, k: int, want_vt: bool = True) -> float:
    """Operations of a thin SVD from the shapes alone, the fewer of
    Golub-Reinsch and R-SVD (Golub & Van Loan, Matrix Computations, 4th
    ed., fig. 8.6.1), m = max(n, k), s = min(n, k): with U and V
    min(14 m s^2 + 8 s^3, 6 m s^2 + 20 s^3); sigma and U only, n >= k
    (the thin U1) min(14 m s^2 - 2 s^3, 6 m s^2 + 11 s^3); n < k (U is the
    small side, V of A^T) min(4 m s^2 + 8 s^3, 2 m s^2 + 11 s^3)."""
    m, s = max(n, k), min(n, k)
    if want_vt:
        one = min(14 * m * s * s + 8 * s ** 3, 6 * m * s * s + 20 * s ** 3)
    elif n >= k:
        one = min(14 * m * s * s - 2 * s ** 3, 6 * m * s * s + 11 * s ** 3)
    else:
        one = min(4 * m * s * s + 8 * s ** 3, 2 * m * s * s + 11 * s ** 3)
    return nb * float(one)


def qr_flops(nb: int, n: int, k: int, want_q: bool) -> float:
    kn = min(n, k)
    one = 2.0 * n * k * kn - 2.0 * kn ** 3 / 3.0
    return nb * one * (2 if want_q else 1)


def bsr_library_ms(torch, timer, s, xl, blk, col, cnt, nb, maxb):
    """``torch.sparse.mm`` of a BSR matrix holding the same blocks against
    ``x`` viewed as ``[nodes*k2, nv]``: the one PyTorch call computing
    ``coupling_mv``'s function.  Built outside the timed region and held to
    the plain version; None (with the reason printed) where this torch
    cannot multiply float32 BSR by dense on the card."""
    from repro_torch.kernels import ref
    rows, k1, k2 = cnt.shape[0], s.shape[1], s.shape[2]
    used = blk < nb                      # slots in row order = block order
    crow = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)]).to(torch.int64)
    bsr = torch.sparse_bsr_tensor(crow, col[used].to(torch.int64), s,
                                  size=(rows * k1, xl.shape[0] * k2))
    xf = xl.reshape(-1, xl.shape[-1])
    try:
        got = torch.sparse.mm(bsr, xf)
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernel] coupling_mv library (BSR @ dense, float32): "
            f"not available in torch {torch.__version__}: {e}")
        return None
    want = ref.coupling_mv(s, xl, blk, col, cnt, maxb=maxb).reshape(got.shape)
    d, r = rel_err(got, want)
    log(f"[kernel] coupling_mv library BSR @ dense vs plain: max_abs_err="
        f"{d:.3e} rel={r:.3e} (tol 1e-5)")
    require(r <= 1e-5, f"BSR library product disagrees with plain: {r:.3e}")
    return timer.ms(lambda: torch.sparse.mm(bsr, xf))


def halo_pack_cases(torch, rnd) -> float:
    """``halo_pack`` against ``index_select`` at its edge cases: bitwise
    equal (a copy).  Returns the largest absolute error (0)."""
    from repro_torch.kernels import halo_pack as khp
    from repro_torch.kernels import ref
    worst = 0.0
    for n, k, nv, cap, what in [(300, 36, 16, 130, "level rows [36,16]"),
                                (64, 64, 16, 40, "dense rows [64,16]"),
                                (50, 36, 1, 33, "nv=1"),
                                (50, 7, 3, 17, "k*nv*4 % 16 != 0"),
                                (10, 36, 16, 0, "cap=0")]:
        x = rnd(n, k, nv)
        idx = torch.randint(0, n, (cap,), dtype=torch.int32)
        idx[cap // 2:] = 0                    # padding repeats row 0
        idx[:min(cap, 4)] = 3                 # repeated rows
        idx = idx.cuda()
        before = khp.LAUNCHES
        got = khp.halo_pack(x, idx)
        torch.cuda.synchronize()
        require(khp.LAUNCHES == before + (cap > 0),
                f"halo_pack launch count for cap={cap}")
        want = ref.halo_pack(x, idx)
        require(got.shape == want.shape and torch.equal(got, want),
                f"halo_pack {what} differs from index_select")
        # into a slice of a larger flat buffer, at an offset of 3 floats
        # (12 bytes: the unaligned path); nothing outside it may change
        flat = torch.full((cap * k * nv + 8,), float("nan"), device="cuda")
        out = flat[3:3 + cap * k * nv].view(cap, k, nv)
        khp.halo_pack(x, idx, out=out)
        require(torch.equal(out, want), f"halo_pack out= {what}")
        outside = torch.cat([flat[:3], flat[3 + cap * k * nv:]])
        require(bool(torch.isnan(outside).all()),
                f"halo_pack out= {what} wrote outside its slice")
        worst = max(worst, (got - want).abs().max().item() if cap else 0.0)
        log(f"[kernel] halo_pack {what} n={n} cap={cap}: equal to "
            f"index_select, out= slice untouched outside")
    return worst


def gemm_shapes(torch, v, x, rnd) -> list:
    """(name, a, b) of the HGEMV's batched_gemm shapes at N = 2^20: the
    leaf ``V^T x`` (A a transposed view of the leaf bases), the leaf ``U``,
    the level-14 transfers (``F^T`` a view, ``E``), and the compressed
    leaf ``V^T x`` (rank 3)."""
    nl, m, k = v.shape
    f = rnd(nl, k, k)
    return [("leaf V^T x", v.transpose(-1, -2), x),
            ("leaf U", v, rnd(nl, k, x.shape[-1])),
            ("transfer F^T l=14", f.transpose(-1, -2), rnd(nl, k, 16)),
            ("transfer E l=14", f, rnd(nl, k, 16)),
            ("compressed leaf V^T x", rnd(nl, m, 3).transpose(-1, -2), x)]


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call, microseconds: ``calls`` calls back to back
    without a synchronize (the card runs behind), after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def gemm_timings(torch, timer, shapes, rnd) -> dict:
    """``batched_gemm`` at each HGEMV shape beside its bound and
    ``torch.bmm``, with the path ``plan_launch`` chose, and the wrapper's
    host time per call beside ``torch.bmm``'s at a level-1 transfer
    ([2,36,36]x[2,36,16], where the card's part is negligible).  Returns
    the JSON row's numbers (the leaf ``V^T x``) and the table."""
    from repro_torch.kernels import batched_gemm as kbg
    from repro_torch.kernels import ref
    table = []
    for name, a, b in shapes:
        got, want = kbg.batched_gemm(a, b), ref.batched_gemm(a, b)
        _, rel = rel_err(got, want)
        require(rel <= TOL["batched_gemm"],
                f"batched_gemm {name}: rel err {rel:.3e}")
        nb, m, k = a.shape
        n = b.shape[2]
        bnd, by = bound_ms(4.0 * nb * (m * k + k * n + m * n),
                           2.0 * nb * m * k * n)
        row = dict(name=name, shape=f"[{nb},{m},{k}]x[{nb},{k},{n}]",
                   plan=kbg.plan_launch(a, b), rel_err=rel,
                   ms=timer.ms(lambda: kbg.batched_gemm(a, b)),
                   library_ms=timer.ms(lambda: torch.bmm(a, b)),
                   plain_ms=timer.ms(lambda: ref.batched_gemm(a, b)),
                   bound_ms=bnd, bound_by=by)
        table.append(row)
        log(f"[kernel] batched_gemm {name} {row['shape']} plan "
            f"{row['plan']}: ms={row['ms']:.4f} "
            f"torch.bmm={row['library_ms']:.4f} "
            f"plain={row['plain_ms']:.4f} bound={bnd:.4f} ({by}); "
            f"{row['ms'] / row['library_ms']:.2f}x bmm, "
            f"{bnd / row['ms']:.0%} of the bound; rel err {rel:.2e}")
    a1, b1 = rnd(2, 36, 36).transpose(-1, -2), rnd(2, 36, 16)
    host = dict(kernel_us=host_us(torch, lambda: kbg.batched_gemm(a1, b1)),
                bmm_us=host_us(torch, lambda: torch.bmm(a1, b1)))
    log(f"[kernel] batched_gemm host time per call at [2,36,36]x[2,36,16] "
        f"({kbg.plan_launch(a1, b1)}): wrapper {host['kernel_us']:.2f} us, "
        f"torch.bmm {host['bmm_us']:.2f} us")
    lead = table[0]
    return dict(ms=lead["ms"], plain_ms=lead["plain_ms"],
                library_ms=lead["library_ms"], bound_ms=lead["bound_ms"],
                bound_by=lead["bound_by"], shapes=table, host=host)


def kernel_phase(torch, timer, results: dict) -> None:
    from repro_torch.kernels import batched_gemm as kbg
    from repro_torch.kernels import batched_qr as kbq
    from repro_torch.kernels import batched_svd as kbs
    from repro_torch.kernels import coupling_mv as kcm
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    def check(name, got, want, tol, what):
        d, r = rel_err(got, want)
        log(f"[kernel] {name} {what}: max_abs_err={d:.3e} rel={r:.3e} "
            f"(tol {tol:g})")
        require(r <= tol, f"{name} {what}: rel err {r:.3e} > {tol}")
        return d

    # ---- batched_gemm: the HGEMV's shapes (fast path), edge cases ----
    nl, m, k, nv = 16384, 64, 36, 16
    v = rnd(nl, m, k)
    x = rnd(nl, m, nv)
    a = v.transpose(-1, -2)
    err = check("batched_gemm", kbg.batched_gemm(a, x), ref.batched_gemm(a, x),
                TOL["batched_gemm"], "leaf V^T x [16384,36,64]x[16384,64,16]")
    for shp in [((8192, 36, 36), (8192, 36, 16)), ((16384, 64, 36),
                                                   (16384, 36, 16)),
                ((7, 5, 3), (7, 3, 1)), ((3, 1, 9), (3, 9, 2)),
                ((5, 70, 33), (5, 33, 19)), ((64, 13, 11), (64, 11, 16)),
                ((300, 36, 36), (300, 36, 4))]:
        a2, b2 = rnd(*shp[0]), rnd(*shp[1])
        check("batched_gemm", kbg.batched_gemm(a2, b2),
              ref.batched_gemm(a2, b2), TOL["batched_gemm"],
              f"{shp} ({kbg.plan_launch(a2, b2)})")
    ft = rnd(4096, 36, 36).transpose(-1, -2)
    xh = rnd(4096, 36, 16)
    check("batched_gemm", kbg.batched_gemm(ft, xh), ref.batched_gemm(ft, xh),
          TOL["batched_gemm"], "F^T view [4096,36,36]")
    flat = rnd(4096 * 36 * 36 + 1)[1:]             # 4 bytes off alignment
    fu = flat.view(4096, 36, 36).transpose(-1, -2)
    check("batched_gemm", kbg.batched_gemm(fu, xh), ref.batched_gemm(fu, xh),
          TOL["batched_gemm"],
          f"unaligned F^T view ({kbg.plan_launch(fu, xh)})")
    for shp in [((0, 4, 4), (0, 4, 2)), ((3, 0, 4), (3, 4, 2)),
                ((3, 4, 0), (3, 0, 2))]:
        z = kbg.batched_gemm(rnd(*shp[0]), rnd(*shp[1]))
        require(z.shape == (shp[0][0], shp[0][1], shp[1][2]) and
                not z.any(), "zero-size gemm must give zeros")
    shapes = gemm_shapes(torch, v, x, rnd)
    del flat, fu
    results["batched_gemm"] = dict(max_abs_err=err, **gemm_timings(
        torch, timer, shapes, rnd))

    # ---- coupling_mv: dense leaves [81408,64,64], rows 16384, maxb 5 ----
    rows, maxb = 16384, 5
    blk, col, cnt, nb = random_plan(torch, rows, maxb, rows, gen, lo=maxb)
    # distinct, ascending columns in each row, as a leaf's dense blocks
    # have (and as the BSR library call below needs); drawn from a
    # generator of their own, so every other input stays as it was
    cgen = torch.Generator().manual_seed(7)
    col = (torch.sort(torch.randint(0, rows - maxb, (rows, maxb),
                                    generator=cgen, dtype=torch.int32),
                      dim=1)
           .values + torch.arange(maxb, dtype=torch.int32)).reshape(-1)
    col = torch.where(blk < nb, col, torch.zeros_like(col))
    blk, col, cnt = blk.cuda(), col.cuda(), cnt.cuda()
    s = rnd(nb, m, m)
    xl = rnd(rows, m, nv)
    err = check("coupling_mv", kcm.coupling_mv(s, xl, blk, col, cnt, maxb=maxb),
                ref.coupling_mv(s, xl, blk, col, cnt, maxb=maxb),
                TOL["coupling_mv"], f"dense leaves [{nb},64,64] nv=16 "
                f"({kcm.cmv_plan(rows, m, m, nv, maxb).route})")
    check("coupling_mv", kcm.coupling_mv(s, xl, blk, col, cnt, maxb=maxb,
                                         route="general"),
          ref.coupling_mv(s, xl, blk, col, cnt, maxb=maxb),
          TOL["coupling_mv"], f"dense leaves [{nb},64,64] nv=16 (general)")
    # the uncompressed levels, nv = 1, odd shapes (k = 130 and nv = 20 take
    # the general route), and the compressed operator's shapes
    for (r2, mb2, k2, nv2) in [(16384, 17, 36, 16), (16384, 17, 36, 1),
                               (4096, 9, 7, 16), (64, 3, 1, 5),
                               (33, 4, 130, 20), (16384, 17, 3, 16),
                               (4096, 13, 5, 16), (64, 13, 15, 16)]:
        b2, c2, n2, nb2 = random_plan(torch, r2, mb2, r2, gen)
        b2, c2, n2 = b2.cuda(), c2.cuda(), n2.cuda()
        s2, x2 = rnd(nb2, k2, k2), rnd(r2, k2, nv2)
        route = kcm.cmv_plan(r2, k2, k2, nv2, mb2).route
        before = kcm.ROUTE_LAUNCHES[route]
        got = kcm.coupling_mv(s2, x2, b2, c2, n2, maxb=mb2)
        require(kcm.ROUTE_LAUNCHES[route] == before + 1,
                f"coupling_mv rows={r2} k={k2} nv={nv2} did not launch "
                f"route {route}")
        check("coupling_mv", got,
              ref.coupling_mv(s2, x2, b2, c2, n2, maxb=mb2),
              TOL["coupling_mv"],
              f"rows={r2} maxb={mb2} k={k2} nv={nv2} ({route})")
    z = kcm.coupling_mv(rnd(0, 4, 4), rnd(8, 4, 2),
                        torch.zeros(0, dtype=torch.int32, device="cuda"),
                        torch.zeros(0, dtype=torch.int32, device="cuda"),
                        torch.zeros(8, dtype=torch.int32, device="cuda"),
                        maxb=0)
    require(z.shape == (8, 4, 2) and not z.any(), "maxb=0 must give zeros")
    nbytes = 4 * (s.numel() + xl.numel() + rows * m * nv) + \
        4 * (2 * rows * maxb + rows)
    bnd, by = bound_ms(nbytes, 2.0 * nb * m * m * nv)
    results["coupling_mv"] = dict(
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        ms=timer.ms(lambda: kcm.coupling_mv(s, xl, blk, col, cnt, maxb=maxb)),
        general_ms=timer.ms(lambda: kcm.coupling_mv(
            s, xl, blk, col, cnt, maxb=maxb, route="general")),
        plain_ms=timer.ms(
            lambda: ref.coupling_mv(s, xl, blk, col, cnt, maxb=maxb), reps=3),
        library_ms=bsr_library_ms(torch, timer, s, xl, blk, col, cnt, nb,
                                  maxb))

    # ---- batched_qr, every route (``qr_plan``): leaf [16384,64,36] and
    # stacks [8192,72,36] on the warp route, the weights stack
    # [16384,648,36] (R only) on the tall route, [.,648,36] with Q and
    # [64,1152,64] on the general route; wide, rank-deficient, zero
    # column, ragged tall stacks; each against the plain version and a
    # float64 QR ----
    def qr_case(aa, what, q_cols=None, route=None):
        # a rank-deficient panel's Q columns past its rank complete the
        # basis arbitrarily; they are compared through R and Q^T Q only.
        # The route is the one the shape takes in a large batch (small
        # batches would take the general route by the batch-size rule)
        route = route or kbq.qr_plan(*aa.shape[1:])
        q, r = kbq.batched_qr(aa, route=route)
        qp, rp = ref.batched_qr(aa)
        q64, r64 = ref.batched_qr(aa.double())
        what = f"{what} ({route})"
        e1 = check("batched_qr", q[..., :q_cols], qp[..., :q_cols],
                   TOL["batched_qr"], what + " Q")
        check("batched_qr", q[..., :q_cols], q64[..., :q_cols],
              TOL["batched_qr"], what + " Q vs float64")
        eye = torch.eye(q.shape[-1], device="cuda")
        check("batched_qr", q.transpose(-1, -2) @ q, eye.expand_as(
            q.transpose(-1, -2) @ q), TOL["batched_qr"], what + " Q^T Q")
        e2 = check("batched_qr", r, rp, TOL["batched_qr"], what + " R")
        check("batched_qr", r, r64, TOL["batched_qr"], what + " R vs float64")
        return max(e1, e2)

    def qr_r_case(aa, what, route=None):
        route = route or kbq.qr_plan(*aa.shape[1:], False)
        rr = kbq.batched_qr_r(aa, route=route)
        what = f"{what} R only ({route})"
        e = check("batched_qr", rr, ref.batched_qr(aa)[1], TOL["batched_qr"],
                  what)
        check("batched_qr", rr, ref.batched_qr(aa.double())[1],
              TOL["batched_qr"], what + " vs float64")
        return e

    leaf = rnd(16384, 64, 36)
    err = qr_case(leaf, "leaf [16384,64,36]")
    qr_case(leaf[:2048], "leaf [2048 of 16384,64,36]", route="general")
    qr_case(rnd(8192, 72, 36), "stacked transfers [8192,72,36]")
    # the polish factors U = A / sigma, orthonormal up to the Jacobi error
    # (a random square panel would measure its own conditioning instead)
    polish = torch.linalg.qr(rnd(4096, 36, 36))[0] + 1e-3 * rnd(4096, 36, 36)
    qr_case(polish, "SVD polish [4096,36,36]")
    qr_case(rnd(64, 8, 36), "wide [64,8,36]")
    base = rnd(32, 40, 3)
    qr_case(base @ rnd(32, 3, 9), "rank-deficient [32,40,9]", q_cols=3)
    zc = rnd(32, 40, 9)
    zc[:, :, 4] = 0.0
    qr_case(zc, "zero column [32,40,9]")
    mid = rnd(256, 648, 36)
    q0, r0 = kbq.batched_qr(mid)
    q1, r1 = kbq.batched_qr(mid, force_global=True)
    require(torch.equal(q0, q1) and torch.equal(r0, r1),
            "shared and global QR paths differ")
    log("[kernel] batched_qr shared vs global path on [256,648,36]: equal")
    qr_case(rnd(64, 1152, 64), "global path [64,1152,64]")
    wstack = rnd(16384, 648, 36)
    # R only and the full QR no longer share arithmetic (the weights take
    # the streamed tall route): each is held to the plain version and to
    # float64 on its own
    qr_r_case(wstack[:1024], "weights stack [1024 of 16384,648,36]")
    qr_r_case(wstack[:1024], "weights stack [1024 of 16384,648,36]",
              route="general")
    for rows in (650, 504, 396, 324, 288, 144):
        qr_r_case(rnd(512, rows, 36), f"ragged tall stack [512,{rows},36]")
    nbytes = 4 * (leaf.numel() + 16384 * 64 * 36 + 16384 * 36 * 36)
    bnd, by = bound_ms(nbytes, qr_flops(16384, 64, 36, True))
    results["batched_qr"] = dict(
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        ms=timer.ms(lambda: kbq.batched_qr(leaf)),
        general_ms=timer.ms(lambda: kbq.batched_qr(leaf, route="general")),
        # ~1.4 s per call: one timed call each after one warmup
        plain_ms=timer.ms(lambda: ref.batched_qr(leaf), reps=1, warmup=1),
        library_ms=timer.ms(lambda: torch.linalg.qr(leaf), reps=1,
                            warmup=1))
    wbytes = 4 * (wstack.numel() + 16384 * 36 * 36)
    wb, wby = bound_ms(wbytes, qr_flops(16384, 648, 36, False))
    log(f"[kernel] batched_qr_r weights stack [16384,648,36]: tall "
        f"ms={timer.ms(lambda: kbq.batched_qr_r(wstack), reps=5):.4f} "
        f"general ms="
        f"{timer.ms(lambda: kbq.batched_qr_r(wstack, route='general'), reps=3):.4f}"
        f" bound_ms={wb:.4f} ({wby})")
    del wstack
    qr_rank_deficient_question(torch, kbq, ref)

    # ---- batched_svd, every route (``svd_plan``): leaf R^T
    # [16384,36,36] as the strided view compress passes (warp), wide
    # inner panels [8192,6,36] .. [32,30,36] (warp_t), [8192,72,36]
    # (warp), the general route forced at square shapes ----
    def svd_case(aa, what, route=None):
        u, sv, vt = kbs.batched_svd(aa, route=route)
        up, sp, vtp = ref.batched_svd(aa)
        s64 = torch.linalg.svd(aa.double(), full_matrices=False)[1]
        smax = s64.abs().max(dim=-1).values[:, None]
        es = ((sv.double() - s64).abs() / smax).max().item()
        ep = ((sp.double() - s64).abs() / smax).max().item()
        ekp = ((sv - sp).abs() / sp.abs().max(dim=-1).values[:, None]
               ).max().item()
        rec = torch.einsum("bnk,bk,bkj->bnj", u, sv, vt)
        er = ((rec - aa).flatten(1).norm(dim=1) /
              aa.flatten(1).norm(dim=1).clamp_min(1e-30)).max().item()
        gram = u.transpose(-1, -2) @ u
        eo = (gram - torch.eye(gram.shape[-1], device="cuda")).abs().max().item()
        u1, s1, vt1 = kbs.batched_svd(aa, route=route, want_vt=False)
        same = vt1 is None and torch.equal(u1, u) and torch.equal(s1, sv)
        what = f"{what} ({route or kbs.svd_plan(*aa.shape[1:])})"
        log(f"[kernel] batched_svd {what}: sigma vs fp64 kernel={es:.3e} "
            f"plain={ep:.3e} kernel-vs-plain={ekp:.3e} recon={er:.3e} "
            f"UtU-I={eo:.3e} (tol 1e-4); U-and-sigma-only call "
            f"{'bitwise equal' if same else 'DIFFERS'}")
        require(ekp <= 1e-4 and er <= 1e-4 and eo <= 1e-4,
                f"batched_svd {what} out of tolerance")
        require(same, f"batched_svd {what}: the U-and-sigma-only call differs")
        return (sv - sp).abs().max().item()

    rl = rnd(16384, 36, 36).transpose(-1, -2)      # R^T, as compress reads
    err = svd_case(rl, "leaf R^T [16384,36,36]")
    svd_case(rl[:2048], "leaf R^T [2048 of 16384,36,36]", route="general")
    svd_case(rnd(8192, 6, 36), "wide inner [8192,6,36]")
    svd_case(rnd(32, 30, 36), "wide inner [32,30,36]")
    svd_case(rnd(8192, 72, 36), "inner [8192,72,36]")
    svd_case(rnd(64, 18, 7), "odd k [64,18,7]")
    svd_case(rnd(64, 4, 9), "wide [64,4,9]")
    g = torch.linalg.qr(rnd(32, 24, 12))[0]
    h = torch.linalg.qr(rnd(32, 12, 12))[0]
    graded = (g * torch.logspace(0, -7, 12, device="cuda")) @ \
        h.transpose(-1, -2)
    svd_case(graded, "graded spectrum 1e-7 [32,24,12]")
    svd_case(graded, "graded spectrum 1e-7 [32,24,12]", route="general")
    svd_case(graded.transpose(-1, -2).contiguous(),
             "graded spectrum 1e-7, wide [32,12,24]")
    svd_case(rnd(64, 80, 72), "72 columns [64,80,72]")
    nbytes = 4 * (rl.numel() * 2 + 16384 * 36)
    bnd, by = bound_ms(nbytes, svd_flops(16384, 36, 36, want_vt=False))
    results["batched_svd"] = dict(
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        # the main path's call: U and sigma only (+ the QR polish)
        ms=timer.ms(lambda: kbs.batched_svd(rl, want_vt=False), reps=5),
        with_vt_ms=timer.ms(lambda: kbs.batched_svd(rl), reps=5),
        general_ms=timer.ms(
            lambda: kbs.batched_svd(rl, want_vt=False, route="general"),
            reps=3),
        # cuSOLVER takes ~15 s per call here: one timed call, warmed by
        # svd_case's own call of the plain version, which is
        # torch.linalg.svd itself, so the call gives both numbers
        plain_ms=timer.ms(lambda: ref.batched_svd(rl), reps=1, warmup=0))
    results["batched_svd"]["library_ms"] = results["batched_svd"]["plain_ms"]
    # ---- halo_pack: edge cases here; timed at the distributed phase's
    # largest launch, once the partition exists (dist_phase) ----
    results["halo_pack"] = dict(max_abs_err=halo_pack_cases(torch, rnd))
    for name, r in results.items():
        if "ms" in r:
            extra = "".join(f" {key}={r[key]:.4f}" for key in
                            ("general_ms", "with_vt_ms") if key in r)
            log(f"[kernel] {name}: ms={r['ms']:.4f}{extra} "
                f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")


def qr_rank_deficient_question(torch, kbq, ref, seeds: int = 12) -> None:
    """Which side loses digits on a rank-3 panel [32,40,9]: the first three
    columns of Q from the kernel (its warp route, the one short panels take
    on the main path) and from cuSOLVER (``torch.linalg.qr``,
    sign-fixed), each against a float64 QR of the same input, over
    ``seeds`` draws.  Those columns are as well determined as the first
    three columns of A are conditioned, so each error is also read in
    units of u * kappa_2(A[:, :3]) (u = 2^-24), the forward error a
    backward-stable QR may have; the kernel is held to n = 40 such units
    per matrix."""
    u = 2.0 ** -24
    worst = {"kernel": 0.0, "cusolver": 0.0, "kernel-vs-cusolver": 0.0,
             "kernel/(u kappa)": 0.0, "cusolver/(u kappa)": 0.0}
    for seed in range(seeds):
        gen = torch.Generator().manual_seed(1000 + seed)
        a = (torch.randn(32, 40, 3, generator=gen) @
             torch.randn(32, 3, 9, generator=gen)).cuda()
        kappa = torch.linalg.cond(a[..., :3].double())
        q64 = ref.batched_qr(a.double())[0][..., :3]
        qk = kbq.batched_qr(a, route="warp")[0][..., :3]
        qc = ref.batched_qr(a)[0][..., :3]
        ek = (qk.double() - q64).abs().flatten(1).max(dim=1).values
        ec = (qc.double() - q64).abs().flatten(1).max(dim=1).values
        errs = {"kernel": ek.max().item(), "cusolver": ec.max().item(),
                "kernel-vs-cusolver": (qk - qc).abs().max().item(),
                "kernel/(u kappa)": (ek / (u * kappa)).max().item(),
                "cusolver/(u kappa)": (ec / (u * kappa)).max().item()}
        for key, v in errs.items():
            worst[key] = max(worst[key], v)
        log(f"[kernel] batched_qr rank-deficient [32,40,9] seed {seed}: "
            f"Q[:, :3] vs float64 kernel={errs['kernel']:.3e} "
            f"cusolver={errs['cusolver']:.3e}, kernel vs cusolver "
            f"{errs['kernel-vs-cusolver']:.3e}; max kappa(A[:, :3]) "
            f"{kappa.max().item():.3e}; in units of u*kappa kernel "
            f"{errs['kernel/(u kappa)']:.2f} cusolver "
            f"{errs['cusolver/(u kappa)']:.2f}")
    log(f"[kernel] batched_qr rank-deficient [32,40,9] over {seeds} seeds, "
        f"worst Q[:, :3] vs float64: kernel {worst['kernel']:.3e}, "
        f"cusolver {worst['cusolver']:.3e}; kernel vs cusolver "
        f"{worst['kernel-vs-cusolver']:.3e}; in units of u*kappa: kernel "
        f"{worst['kernel/(u kappa)']:.2f}, cusolver "
        f"{worst['cusolver/(u kappa)']:.2f} (tol 40 units against float64)")
    require(worst["kernel/(u kappa)"] <= 40.0,
            f"rank-deficient QR kernel vs float64 "
            f"{worst['kernel/(u kappa)']:.2f} units of u*kappa")


def record_qr_svd(torch, fn, keep_inputs: bool = False) -> tuple:
    """Run ``fn()`` with every QR and SVD launch counted by (entry, shape,
    contiguous) -- entries ``qr``, ``qr_r``, ``svd`` (with V^T),
    ``svd_u`` (U and sigma) and ``svals`` (sigma only, U unpolished) --
    and, with ``keep_inputs``, a copy of each key's first input.  Returns
    ``(counts, inputs, fn's result)``: the wrappers are wrapped for the
    one call."""
    from collections import Counter
    from repro_torch.kernels import batched_qr as kbq
    from repro_torch.kernels import batched_svd as kbs

    seen: Counter = Counter()
    inputs: dict = {}
    launch_qr, svd = kbq._launch, kbs.batched_svd

    def note(key, a):
        seen[key] += 1
        if keep_inputs and key not in inputs:
            inputs[key] = a.clone()

    def rec_qr(a, want_q, route, force_global=False):
        note(("qr" if want_q else "qr_r", tuple(a.shape),
              a.is_contiguous()), a)
        return launch_qr(a, want_q, route, force_global)

    def rec_svd(a, **kw):
        entry = "svd" if kw.get("want_vt", True) else \
            "svd_u" if kw.get("polish", True) else "svals"
        note((entry, tuple(a.shape), a.is_contiguous()), a)
        return svd(a, **kw)

    kbq._launch, kbs.batched_svd = rec_qr, rec_svd
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        kbq._launch, kbs.batched_svd = launch_qr, svd
    return dict(seen), inputs, out


def compress_launch_shapes(torch, shape, data) -> dict:
    """Every QR and SVD launch of one warm ``compress(tol=1e-3)``, counted
    by (entry, shape, contiguous)."""
    from repro_torch.core.compression import compress

    return record_qr_svd(torch, lambda: compress(shape, data, tol=1e-3,
                                                 backend="cuda"))[0]


def compress_shape_timings(torch, timer, shape, data, known: dict) -> list:
    """Each distinct QR / SVD shape one warm compress launches: its
    launches, the planned route's ms, the general (first) kernel's ms, the
    bound, the plain version's ms and ``torch.linalg``'s ms (one call each;
    cuSOLVER is slow here), on ``[kernel]`` lines.  An SVD's time includes
    its QR polish where its route polishes.  The plain SVD is
    ``torch.linalg.svd`` itself, so one call gives both of its numbers.
    ``known``: ``(entry, shape) -> (plain ms, library ms)`` of the shapes
    the kernel phase timed already (the leaf QR and SVD), not timed
    again."""
    from repro_torch.kernels import batched_qr as kbq
    from repro_torch.kernels import batched_svd as kbs
    from repro_torch.kernels import ref

    seen = compress_launch_shapes(torch, shape, data)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, tot_new, tot_gen = [], 0.0, 0.0
    for (entry, shp, contig), count in sorted(
            seen.items(), key=lambda kv: (kv[0][0], -kv[0][1][0])):
        nb, n, k = shp
        kn = min(n, k)
        a = torch.randn(nb, n, k, device="cuda", generator=gen)
        if not contig:                    # the leaf's R^T view
            a = a.transpose(-1, -2).contiguous().transpose(-1, -2)
        if entry in ("qr", "qr_r"):
            want_q = entry == "qr"
            route = kbq.qr_plan(n, k, want_q, nb=nb)
            run = (lambda r: kbq.batched_qr(a, route=r)) if want_q else \
                (lambda r: kbq.batched_qr_r(a, route=r))
            lib = (lambda: torch.linalg.qr(a)) if want_q else \
                (lambda: torch.linalg.qr(a, mode="r"))
            plain = lambda: ref.batched_qr(a)
            nbytes = 4 * nb * (n * k + (n * kn if want_q else 0) + kn * k)
            flops = qr_flops(nb, n, k, want_q)
        else:
            want_vt = entry == "svd"
            route = kbs.svd_plan(n, k, want_vt)
            run = lambda r: kbs.batched_svd(a, route=r, want_vt=want_vt)
            lib = lambda: torch.linalg.svd(a, full_matrices=False)
            plain = None
            nbytes = 4 * nb * (n * k + n * kn + kn + (kn * k if want_vt
                                                      else 0))
            flops = svd_flops(nb, n, k, want_vt)
        bnd, by = bound_ms(nbytes, flops)
        ms = timer.ms(lambda: run(route), reps=5)
        gms = timer.ms(lambda: run("general"), reps=3) if route != "general" \
            else ms
        if (entry, shp) in known:
            pms, lms = known[(entry, shp)]
        else:
            lms = timer.ms(lib, reps=1, warmup=0)
            pms = timer.ms(plain, reps=1, warmup=0) if plain else lms
        tot_new += count * ms
        tot_gen += count * gms
        row = dict(entry=entry, shape=list(shp), launches=count, route=route,
                   ms=ms, general_ms=gms, bound_ms=bnd, bound_by=by,
                   plain_ms=pms, library_ms=lms)
        rows.append(row)
        log(f"[kernel] compress shape {entry} {list(shp)}: launches "
            f"{count} per compress, route {route} ms={ms:.4f} general "
            f"ms={gms:.4f} bound_ms={bnd:.4f} ({by}) plain ms={pms:.1f} "
            f"torch.linalg ms={lms:.1f}")
        del a
    log(f"[kernel] compress QR+SVD kernel time per compress, sum of "
        f"launches x ms: planned routes {tot_new:.2f} ms, general kernels "
        f"{tot_gen:.2f} ms")
    return rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def kernel_rows(torch, points, kernel, perm, rows, x, chunk: int = 64):
    """Exact ``(K x)[rows]`` in float64, chunked over rows (never N^2);
    ``rows`` index tree order, ``x`` is ``[N, nv]`` in tree order."""
    p = torch.as_tensor(points[perm], dtype=torch.float64, device=x.device)
    xd = x.double()
    return torch.cat([kernel(p[rows[a:a + chunk]][:, None, :], p[None, :, :])
                      @ xd for a in range(0, rows.shape[0], chunk)])


def hgemv_phase_ms(torch, shape, data, x, backend: str) -> dict:
    """Per-phase time of one HGEMV: CUDA events recorded between the four
    phases (a phase's time includes any gap while the host enqueues it)."""
    from repro_torch.core import matvec as mv
    xl = x.reshape(shape.n_leaves, shape.leaf_size, x.shape[-1])
    names = ("upsweep", "coupling", "downsweep", "dense")
    out = {k: [] for k in names}
    for i in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        xhat = mv.upsweep(shape, data, xl, backend)
        ev[1].record()
        yhat = mv.coupling_multiply(shape, data, xhat, backend)
        ev[2].record()
        mv.downsweep(shape, data, yhat, backend)
        ev[3].record()
        mv.dense_multiply(shape, data, xl, backend)
        ev[4].record()
        torch.cuda.synchronize()
        if i >= 2:
            for j, k in enumerate(names):
                out[k].append(ev[j].elapsed_time(ev[j + 1]))
    return {k: statistics.median(v) for k, v in out.items()}


def coupling_level_timings(torch, timer, shape, data, x, what: str) -> dict:
    """Each ``coupling_mv`` launch of one HGEMV on the main path's operator
    (``what``: uncompressed or compressed), on its real inputs: the 12
    coupling levels (S of the level against the upsweep's ``xhat``) and the
    dense leaves.  For each, on a ``[kernel] coupling level`` line: rows,
    k, maxb, blocks, the planned route's ms and the general route's ms
    (CUDA events, L2 flushed), the byte bound (S, x and y once, the plan),
    the plain route's ms (``marshaled_multiply``: gather + ``torch.bmm``),
    the wrapper's host time per call (no synchronize) and the error
    against ``ref.coupling_mv`` (held to 1e-5).  Returns
    the rows and their sums."""
    from repro_torch.core import matvec as mv
    from repro_torch.kernels import coupling_mv as kcm
    from repro_torch.kernels import ref
    nv = x.shape[-1]
    xl = x.reshape(shape.n_leaves, shape.leaf_size, nv).contiguous()
    xhat = mv.upsweep(shape, data, xl, "cuda")
    launches = []
    for l in range(shape.depth + 1):
        if shape.coupling_counts[l] and shape.ranks[l]:
            launches.append((f"l={l}", data.s[l], xhat[l], data.plan.sblk[l],
                             data.plan.scol[l], data.plan.scnt[l],
                             data.s_mar[l]))
    launches.append(("dense", data.dense, xl, data.plan.dblk, data.plan.dcol,
                     data.plan.dcnt, data.dense_mar))
    rows_out = []
    for name, s, xx, blk, col, cnt, mar in launches:
        rows = cnt.shape[0]
        maxb = blk.shape[0] // rows
        nb, k1, k2 = s.shape
        plan = kcm.cmv_plan(rows, k1, k2, nv, maxb)
        got = kcm.coupling_mv(s, xx, blk, col, cnt, maxb=maxb)
        want = ref.coupling_mv(s, xx, blk, col, cnt, maxb=maxb)
        plain = mv.marshaled_multiply(mar, xx, col, "torch")
        _, rel = rel_err(got, want)
        _, rel_plain = rel_err(plain, want)
        require(rel <= TOL["coupling_mv"],
                f"coupling level {what} {name}: rel err {rel:.3e}")
        require(rel_plain <= TOL["coupling_mv"],
                f"coupling level {what} {name}: marshaled plain route "
                f"{rel_plain:.3e}")
        used = int((blk < nb).sum())
        nbytes = 4 * (used * k1 * k2 + xx.numel() + rows * k1 * nv) + \
            4 * (2 * rows * maxb + rows)
        bnd, by = bound_ms(nbytes, 2.0 * used * k1 * k2 * nv)
        row = dict(
            operator=what, launch=name, rows=rows, k=k1, maxb=maxb,
            blocks=used, route=plan.route, kb=plan.kb, rel_err=rel,
            ms=timer.ms(lambda: kcm.coupling_mv(s, xx, blk, col, cnt,
                                                maxb=maxb)),
            general_ms=timer.ms(lambda: kcm.coupling_mv(
                s, xx, blk, col, cnt, maxb=maxb, route="general")),
            bound_ms=bnd, bound_by=by,
            plain_ms=timer.ms(lambda: mv.marshaled_multiply(mar, xx, col,
                                                            "torch")),
            host_us=host_us(torch, lambda: kcm.coupling_mv(
                s, xx, blk, col, cnt, maxb=maxb), calls=50))
        rows_out.append(row)
        log(f"[kernel] coupling level {what} {name}: rows={rows} k={k1} "
            f"maxb={maxb} blocks={used} route {plan.route}/{plan.kb}: "
            f"ms={row['ms']:.4f} general ms={row['general_ms']:.4f} "
            f"bound_ms={bnd:.4f} ({by}) plain marshaled ms="
            f"{row['plain_ms']:.4f}; host per call {row['host_us']:.1f} us;"
            f" rel err {rel:.2e} (tol 1e-5)"
            + (" SLOWER THAN PLAIN" if row["ms"] > row["plain_ms"] else ""))
    sums = {k: sum(r[k] for r in rows_out if r["launch"] != "dense")
            for k in ("ms", "general_ms", "bound_ms", "plain_ms")}
    log(f"[kernel] coupling levels {what}, sum over the "
        f"{len(rows_out) - 1} level launches: " +
        ", ".join(f"{k}={v:.4f}" for k, v in sums.items()))
    return dict(levels=rows_out, sums=sums)


def main_path(torch, log2n: int, device: str = "cuda") -> tuple:
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.compression import compress
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    from repro_torch.core.matvec import h2_matvec
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import phase_events

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def route_diff(before):
        return {name: {r: n - before[name][r] for r, n in routes.items()}
                for name, routes in ops.route_launch_counts().items()}

    side = 1 << (log2n // 2)
    pts = regular_grid_points(side, 2)
    kern = exponential_kernel(0.1)
    x = torch.randn(side * side, 16, generator=torch.Generator().manual_seed(1)
                    ).to(device)

    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    shape, data, tree, _ = construct_h2(pts, kern, leaf_size=64, cheb_p=6,
                                        eta=0.9, device=device)
    sync()
    t_construct = time.perf_counter() - t0
    log(f"[main] construct_h2 N={shape.n} depth={shape.depth}: "
        f"{t_construct:.3f} s, operator {data.nbytes() / 1e9:.3f} GB, "
        f"coupling blocks {sum(shape.coupling_counts)}, dense blocks "
        f"{shape.dense_count}, row_maxb {max(shape.row_maxb)}, dense_maxb "
        f"{shape.dense_maxb}")

    before = ops.launch_counts()
    before_routes = ops.route_launch_counts()
    y = h2_matvec(shape, data, x, backend="cuda")
    sync()
    per_hgemv = {k: v - before[k] for k, v in ops.launch_counts().items()}
    per_hgemv_routes = route_diff(before_routes)["coupling_mv"]
    y_plain = h2_matvec(shape, data, x, backend="torch")
    _, r_plain = rel_err(y, y_plain)
    rel_plain = ((y - y_plain).norm() / y_plain.norm()).item()
    log(f"[main] h2_matvec nv=16 cuda vs torch backend: rel norm err "
        f"{rel_plain:.3e}, max rel {r_plain:.3e} (tol 1e-5)")
    require(bool(torch.isfinite(y).all()) and y.shape == (shape.n, 16),
            "HGEMV output not finite or of the wrong shape")
    require(rel_plain <= 1e-5, f"HGEMV kernel vs plain {rel_plain:.3e}")

    rows = torch.randperm(shape.n, generator=torch.Generator().manual_seed(2)
                          )[:512].to(device)
    exact = kernel_rows(torch, pts, kern, tree.perm, rows, x)
    rel_exact = ((y[rows].double() - exact).norm() / exact.norm()).item()
    log(f"[main] h2_matvec vs 512 exact rows (float64): rel err "
        f"{rel_exact:.3e} (tol 1e-4)")
    require(rel_exact <= 1e-4, f"HGEMV vs exact rows {rel_exact:.3e}")

    before = ops.launch_counts()
    before_routes = ops.route_launch_counts()
    sync()
    t0 = time.perf_counter()
    cshape, cdata = compress(shape, data, tol=1e-3, backend="cuda")
    sync()
    t_compress = time.perf_counter() - t0
    per_compress = {k: v - before[k] for k, v in ops.launch_counts().items()}
    routes_compress = route_diff(before_routes)
    ratio = shape.memory_lowrank() / cshape.memory_lowrank()
    log(f"[main] compress(tol=1e-3) cuda: {t_compress:.3f} s, ranks "
        f"{cshape.ranks}, low-rank memory ratio {ratio:.2f}x")

    yc = h2_matvec(cshape, cdata, x, backend="cuda")
    sync()
    launches = ops.launch_counts()           # the main path ends here
    routes = ops.route_launch_counts()

    warm = []                                # the same call, warm
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        again = compress(shape, data, tol=1e-3, backend="cuda")
        sync()
        warm.append(time.perf_counter() - t0)
        require(again[0].ranks == cshape.ranks, "warm compress ranks differ")
        del again
    t_compress_warm = statistics.median(warm)
    log(f"[main] compress(tol=1e-3) cuda: first (cold) call {t_compress:.3f}"
        f" s, median of {len(warm)} warm calls {t_compress_warm:.3f} s "
        f"({', '.join(f'{t:.3f}' for t in warm)})")
    compress_phases = {}

    def log_phases(backend, ph):
        compress_phases[backend] = dict(ph)
        log(f"[main] compress phases, backend={backend} (ms between CUDA "
            f"events at each phase's entry and exit): " +
            ", ".join(f"{k}={v:.2f}" for k, v in ph.items()))

    if device == "cuda":
        sync()
        with phase_events() as ph:
            compress(shape, data, tol=1e-3, backend="cuda")
        log_phases("cuda", ph)
    rel_c = ((yc - y).norm() / y.norm()).item()
    log(f"[main] compressed h2_matvec vs uncompressed: rel err {rel_c:.3e} "
        f"(tol 5e-3)")
    require(bool(torch.isfinite(yc).all()) and rel_c <= 5e-3,
            f"compressed HGEMV vs uncompressed {rel_c:.3e}")

    t0 = time.perf_counter()
    if device == "cuda":
        with phase_events() as ph:
            pshape, pdata = compress(shape, data, tol=1e-3, backend="torch")
        log_phases("torch", ph)
    else:
        pshape, pdata = compress(shape, data, tol=1e-3, backend="torch")
    sync()
    t_compress_plain = time.perf_counter() - t0
    log(f"[main] compress(tol=1e-3) torch backend: {t_compress_plain:.3f} s, "
        f"ranks {pshape.ranks}")
    require(all(abs(a - b) <= 1 for a, b in zip(pshape.ranks, cshape.ranks)),
            "ranks of the kernel and plain compress differ by more than 1")
    yc_plain = h2_matvec(cshape, cdata, x, backend="torch")
    rel_cp = ((yc - yc_plain).norm() / yc_plain.norm()).item()
    log(f"[main] compressed h2_matvec cuda vs torch backend: {rel_cp:.3e}")
    require(rel_cp <= 1e-5, f"compressed HGEMV kernel vs plain {rel_cp:.3e}")
    del pdata

    def hgemv_ms(s, d, backend, reps=20):
        ts = []
        for i in range(reps + 3):
            sync()
            t = time.perf_counter()
            h2_matvec(s, d, x, backend=backend)
            sync()
            if i >= 3:
                ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    times = dict(
        hgemv_ms=hgemv_ms(shape, data, "cuda"),
        hgemv_plain_ms=hgemv_ms(shape, data, "torch"),
        hgemv_compressed_ms=hgemv_ms(cshape, cdata, "cuda"),
        hgemv_compressed_plain_ms=hgemv_ms(cshape, cdata, "torch"))
    log("[main] median warm HGEMV nv=16 (host clock around synchronize): " +
        ", ".join(f"{k}={v:.3f}" for k, v in times.items()))
    hgemv_phases = {}
    if device == "cuda":
        for what, s_, d_ in (("uncompressed", shape, data),
                             ("compressed", cshape, cdata)):
            for backend in ("cuda", "torch"):
                phases = hgemv_phase_ms(torch, s_, d_, x, backend)
                hgemv_phases[f"{what}/{backend}"] = phases
                log(f"[main] HGEMV phases, {what}, backend={backend} (ms "
                    f"between CUDA events, median of 6): " +
                    ", ".join(f"{k}={v:.3f}" for k, v in phases.items()))
    log(f"[main] launches per HGEMV: {per_hgemv}; coupling_mv by route per "
        f"HGEMV: {per_hgemv_routes}; coupling_mv by route on the main path: "
        f"{routes['coupling_mv']}; per compress: {per_compress}; per "
        f"compress by route: {routes_compress}")
    n_coupling_levels = sum(1 for l in range(shape.depth + 1)
                            if shape.coupling_counts[l] and shape.ranks[l])
    expect = {"batched_gemm": 2 * shape.depth + 2,
              "coupling_mv": n_coupling_levels + 1}
    match = all(per_hgemv[k] == v for k, v in expect.items())
    log(f"[main] expected per HGEMV from the code: {expect} -> "
        f"{'matches' if match else 'DIFFERS'}")
    require(match, "launches per HGEMV differ from the code's count")
    state = dict(shape=shape, data=data, x=x, y=y, ranks=cshape.ranks,
                 cshape=cshape, cdata=cdata)
    return dict(launches=launches, routes=routes,
                hgemv_phase_ms=hgemv_phases,
                routes_per_compress=routes_compress,
                compress_phase_ms=compress_phases, construct_s=t_construct,
                compress_s=t_compress, compress_warm_s=t_compress_warm,
                compress_plain_s=t_compress_plain,
                ranks=cshape.ranks, memory_ratio=ratio, rel_exact=rel_exact,
                rel_compressed=rel_c, **times), state



# ---------------------------------------------------------------------------
# distributed phase: p ranks over gloo, all on the one card
# ---------------------------------------------------------------------------

DIST_P = 4
DIST_NV = 16
RANK_TIMEOUT_S = 600


def _rank(rank: int, p: int, init: str, out_dir: str, inbox, device: str,
          work, args: tuple) -> None:
    """One rank of a distributed phase (a spawned process) running
    ``work(rank, shard, on_card, *args)``.  Its shard -- CUDA tensors
    shared by the parent over CUDA IPC -- comes through the queue
    ``inbox``, so that no argument of the process holds a share; every
    reference to it is dropped before the rank exits, which releases the
    shares.  Writes its results to ``out_dir/rank<r>.pt``."""
    import gc
    import torch
    import torch.distributed as dist

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    res = work(rank, inbox.get(), on_card, *args)
    gc.collect()                    # the shard's last references go here
    if on_card:
        torch.cuda.synchronize()
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(torch, work, args: tuple, shards: list, device: str) -> list:
    """Spawn one process per shard in one gloo group (``_rank``), hand each
    its shard through a queue, join them all within ``RANK_TIMEOUT_S`` and
    return their results in rank order.  A rank that fails or is still
    running at the deadline (then terminated) fails the phase."""
    import tempfile
    p = len(shards)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        inboxes = [ctx.SimpleQueue() for _ in range(p)]
        procs = [ctx.Process(target=_rank, args=(
            r, p, init, tmp, inboxes[r], device, work, args))
            for r in range(p)]
        t0 = time.perf_counter()
        for pr in procs:
            pr.start()
        for box, shard in zip(inboxes, shards):
            box.put(shard)
        try:
            for pr in procs:
                pr.join(max(1.0, RANK_TIMEOUT_S -
                            (time.perf_counter() - t0)))
        finally:
            hung = [pr for pr in procs if pr.is_alive()]
            for pr in hung:
                pr.terminate()
                pr.join()
        require(not hung, f"{len(hung)} rank(s) did not finish within "
                f"{RANK_TIMEOUT_S} s")
        codes = [pr.exitcode for pr in procs]
        require(codes == [0] * p, f"rank exit codes {codes}")
        return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                for r in range(p)]


def _dist_rank_work(rank: int, shard, on_card: bool, dshape,
                    target_ranks) -> dict:
    """The distributed phase's calls on one rank; returns its results
    (host tensors and numbers only)."""
    import dataclasses
    import torch
    from repro_torch.core.comm import Comm
    from repro_torch.core.dist import make_dist_compress, make_dist_matvec
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import phase_times

    torch.backends.cuda.matmul.allow_tf32 = False
    d, x = shard
    del shard
    comm = Comm()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    res = {"backend": comm.backend, "host_staged": comm.host_staged}
    mv = make_dist_matvec(dshape, comm, "halo-plan", backend="cuda")

    # the path: counts set to 0 just before, read just after
    ops.reset_launch_counts()
    comm.reset_counts()
    y = mv(d, x)
    sync()
    res["launches_per_hgemv"] = ops.launch_counts()
    res["recv_bytes"] = comm.recv_bytes
    res["staged_bytes"] = comm.staged_bytes
    y_plain = make_dist_matvec(dshape, comm, "halo-plan", backend="torch")(
        d, x)
    res["bitwise_vs_torch"] = bool(torch.equal(y, y_plain))
    comm.reset_counts()
    y_ag = make_dist_matvec(dshape, comm, "allgather")(d, x)
    sync()
    res["recv_bytes_allgather"] = comm.recv_bytes
    res["rel_allgather"] = ((y_ag - y).norm() / y.norm()).item()

    comm.barrier()
    sync()
    t0 = time.perf_counter()
    cd = make_dist_compress(dshape, comm, target_ranks, backend="cuda")(d)
    sync()
    comm.barrier()
    res["compress_s"] = time.perf_counter() - t0
    cshape = dataclasses.replace(dshape, ranks=tuple(target_ranks))
    mv_c = make_dist_matvec(cshape, comm, "halo-plan", backend="cuda")
    y_c = mv_c(cd, x)
    sync()
    res["launches_path"] = ops.launch_counts()
    res["routes_path"] = ops.route_launch_counts()

    def timed(fn, dd, reps=15, warm=3):
        ts = []
        for i in range(reps + warm):
            comm.barrier()
            sync()
            t = time.perf_counter()
            fn(dd, x)
            sync()
            comm.barrier()
            if i >= warm:
                ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    res["hgemv_ms"] = timed(mv, d)
    res["hgemv_plain_ms"] = timed(
        make_dist_matvec(dshape, comm, "halo-plan", backend="torch"), d)
    res["hgemv_allgather_ms"] = timed(
        make_dist_matvec(dshape, comm, "allgather"), d)
    res["hgemv_compressed_ms"] = timed(mv_c, cd)
    n_ph = 5
    comm.barrier()
    t = time.perf_counter()
    with phase_times(sync) as pt:
        for _ in range(n_ph):
            mv(d, x)
    res["phase_timed_call_ms"] = (time.perf_counter() - t) * 1e3 / n_ph
    res["phase_ms"] = {k: v / n_ph for k, v in pt.items()}
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if on_card else 0
    res["y"] = y.cpu()
    res["y_c"] = y_c.cpu()
    comm.barrier()
    return res


def halo_pack_timed(torch, timer, dshape, ddata, results: dict) -> None:
    """Time ``halo_pack`` as the main path runs it: rank 0's whole
    exchange of one distributed HGEMV in one launch, against the plain
    route's ``index_select`` per segment into the same buffer, with the
    bound from all segments' bytes; bitwise equal to the plain route in
    f32 and bf16.  Also at the exchange's largest single segment against
    ``index_select`` (the first version's per-segment launch)."""
    from repro_torch.core.dist import _hp_pack_table, local_shard
    from repro_torch.kernels import halo_pack as khp
    from repro_torch.kernels import ref
    d0 = local_shard(dshape, ddata, 0)
    gen = torch.Generator().manual_seed(5)
    hp32 = _hp_pack_table(dshape, d0, DIST_NV, 0, False, False)
    srcs = [torch.randn(dshape.nodes_local(l), dshape.ranks[l], DIST_NV,
                        generator=gen).cuda() for l in hp32.levels] + \
        [torch.randn(dshape.leaves_per_dev, dshape.leaf_size, DIST_NV,
                     generator=gen).cuda()]
    for bf16 in (False, True):
        hp = _hp_pack_table(dshape, d0, DIST_NV, 0, False, True) if bf16 \
            else hp32
        dtype = torch.bfloat16 if bf16 else torch.float32
        got = torch.full(hp.shape, float("nan"), dtype=dtype, device="cuda")
        want = torch.full(hp.shape, float("nan"), dtype=dtype, device="cuda")
        before = khp.LAUNCHES
        khp.pack_segments(hp.pack, srcs, got)
        require(khp.LAUNCHES == before + hp.pack.launches,
                "halo_pack launches of the whole exchange")
        ref.halo_pack_segments(hp.pack.segments, srcs, want)
        require(torch.equal(got, want) and not got.isnan().any(),
                f"halo_pack whole exchange ({dtype}) differs from the "
                f"plain route")
    hp = hp32
    segs = [s_ for s_ in hp.pack.segments if s_.idx.shape[0]]
    rows = sum(s_.idx.shape[0] for s_ in segs)
    moved = sum(2.0 * s_.idx.shape[0] * s_.row * 4 + 4 * s_.idx.shape[0]
                for s_ in segs)
    bnd, by = bound_ms(moved, 0.0)
    buf = torch.empty(hp.shape, device="cuda")
    r = results["halo_pack"]
    r.update(
        bound_ms=bnd, bound_by=by, library_ms=None,
        ms=timer.ms(lambda: khp.pack_segments(hp.pack, srcs, buf), reps=50),
        plain_ms=timer.ms(lambda: ref.halo_pack_segments(
            hp.pack.segments, srcs, buf), reps=50),
        segments=len(segs), rows=rows, bytes=moved,
        host_us=host_us(torch, lambda: khp.pack_segments(hp.pack, srcs,
                                                         buf)),
        plain_host_us=host_us(torch, lambda: ref.halo_pack_segments(
            hp.pack.segments, srcs, buf)))
    log(f"[kernel] halo_pack whole exchange of rank 0 ({len(segs)} "
        f"segments, {rows} rows, {moved / 1e6:.3f} MB moved, "
        f"{hp.pack.launches} launch): equal to the plain route in f32 and "
        f"bf16; ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"({len(segs)} index_select) bound_ms={bnd:.5f} ({by}); host per "
        f"call {r['host_us']:.1f} us (plain {r['plain_host_us']:.1f} us)")
    big = max(segs, key=lambda s_: s_.idx.shape[0] * s_.row)
    x = srcs[big.src]
    single = khp.halo_pack(x, big.idx)
    require(torch.equal(single, ref.halo_pack(x, big.idx)),
            "halo_pack largest segment differs")
    cap = big.idx.shape[0]
    one = khp.PackPlan([khp.Segment(0, big.idx, 0, big.row)])
    sb, _ = bound_ms(2.0 * cap * big.row * 4 + 4 * cap, 0.0)
    r["single"] = dict(
        cap=cap, row=list(x.shape[1:]), bound_ms=sb,
        ms=timer.ms(lambda: khp.pack_segments(one, [x], single.view(-1)),
                    reps=50),
        library_ms=timer.ms(lambda: torch.index_select(x, 0, big.idx),
                            reps=50))
    log(f"[kernel] halo_pack largest single segment (cap={cap}, rows "
        f"{list(x.shape[1:])}, {cap * big.row * 4} bytes): "
        f"ms={r['single']['ms']:.4f} index_select="
        f"{r['single']['library_ms']:.4f} bound_ms={sb:.5f}")


def expected_packs(dshape) -> int:
    """halo_pack launches of one halo-plan HGEMV, from the shape: one
    launch per ``MAX_SEGMENTS`` segments of the exchange's table, a segment
    per (branch level below the C-level, offset) and per dense offset."""
    from repro_torch.kernels.halo_pack import MAX_SEGMENTS
    caps = [c for l in range(dshape.lc + 1, dshape.depth + 1)
            if dshape.ranks[l] for c in dshape.br_caps[l - dshape.lc]]
    caps += list(dshape.dense_caps)
    return math.ceil(sum(1 for c in caps if c) / MAX_SEGMENTS)


MESH = (2, 2)                  # block rows x nv columns of the 2D mesh


def _mesh_rank_work(rank: int, shard, on_card: bool, dshape) -> dict:
    """One rank of the 2D mesh (rank ``blk * MESH[1] + nv``): its
    block-row ``Comm`` from ``mesh_comm`` and the halo-plan HGEMV on its
    ``[n_local, nv / MESH[1]]`` slice; launches and bytes of one call,
    then its median time."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.comm import mesh_comm
    from repro_torch.core.dist import make_dist_matvec
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    d, x = shard
    del shard
    comm, nv = mesh_comm(*MESH)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mv = make_dist_matvec(dshape, comm, "halo-plan", backend="cuda")
    ops.reset_launch_counts()
    comm.reset_counts()
    y = mv(d, x)
    sync()
    res = {"blk": comm.rank, "nv": nv, "launches": ops.launch_counts(),
           "recv_bytes": comm.recv_bytes, "y": y.cpu()}
    ts = []
    for i in range(13):
        dist.barrier()
        sync()
        t = time.perf_counter()
        mv(d, x)
        sync()
        dist.barrier()
        if i >= 3:
            ts.append((time.perf_counter() - t) * 1e3)
    res["hgemv_ms"] = statistics.median(ts)
    return res


def mesh_phase(torch, state: dict, device: str = "cuda") -> dict:
    """The distributed HGEMV on a ``MESH`` block x nv mesh of ``DIST_P``
    spawned gloo ranks: ``partition_h2`` over ``MESH[0]`` block rows, each
    rank its block row's shard and its nv columns of x; the joined rows
    held to the single-device HGEMV (1e-5), each rank's received bytes to
    ``matvec_comm_bytes`` at ``DIST_NV / MESH[1]`` columns, and
    ``halo_pack`` launched."""
    from repro_torch.core.dist import (local_shard, matvec_comm_bytes,
                                       mesh_join, mesh_slice, partition_h2)
    t_phase = time.perf_counter()
    on_card = device == "cuda"
    shape, data, x, y = state["shape"], state["data"], state["x"], state["y"]
    p_blk, p_nv = MESH
    dshape, ddata = partition_h2(shape, data, p_blk, device=device)
    shards = [(local_shard(dshape, ddata, r // p_nv),
               mesh_slice(x, dshape, r, p_nv).contiguous())
              for r in range(p_blk * p_nv)]
    ranks = run_ranks(torch, _mesh_rank_work, (dshape,), shards, device)
    del shards, ddata
    if on_card:
        torch.cuda.ipc_collect()
    w = DIST_NV // p_nv
    model = matvec_comm_bytes(dshape, w, "halo-plan")
    packs = expected_packs(dshape)
    ym = mesh_join([r["y"] for r in ranks], p_nv).to(y.device)
    rel = ((ym - y).norm() / y.norm()).item()
    got_bytes = [r["recv_bytes"] for r in ranks]
    got_packs = [r["launches"]["halo_pack"] for r in ranks]
    t_mv = statistics.median(r["hgemv_ms"] for r in ranks)
    log(f"[dist] {p_blk} x {p_nv} block x nv mesh ({p_blk * p_nv} ranks, "
        f"rank = blk * {p_nv} + nv; partition_h2 p={p_blk}, {w} of "
        f"{DIST_NV} columns per rank): joined rows vs single-device "
        f"h2_matvec {rel:.3e} (tol 1e-5); received bytes per rank "
        f"{got_bytes} (model {model}); halo_pack launches per rank "
        f"{got_packs} (from dshape {packs}); median HGEMV {t_mv:.3f} ms "
        f"(host clock, barrier + synchronize; median over ranks)")
    require(bool(torch.isfinite(ym).all()) and ym.shape == y.shape,
            "mesh HGEMV output")
    require(rel <= 1e-5, f"mesh HGEMV vs single device {rel:.3e}")
    require(got_bytes == [model] * len(ranks),
            f"mesh received bytes {got_bytes} != model {model}")
    require(all(c == packs and c > 0 for c in got_packs),
            f"mesh halo_pack launches {got_packs} != {packs}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    return dict(rel_single=rel, recv_bytes=got_bytes[0], model_bytes=model,
                hgemv_ms=t_mv, launches=launches,
                phase_s=time.perf_counter() - t_phase)


def dist_phase(torch, timer, state: dict, results: dict,
               device: str = "cuda") -> dict:
    """Partition the main path's operator over ``DIST_P`` ranks on the card
    and run the distributed HGEMV and compress in ``DIST_P`` spawned
    processes over gloo, all sharing the card and the partition (CUDA
    IPC).  Checks every rank's rows against the single-device HGEMV.
    ``device="cpu"`` rehearses the phase without a card (no kernel runs,
    so the launch checks fail there)."""
    from repro_torch.core.dist import local_shard, matvec_comm_bytes, \
        partition_h2
    from repro_torch.guard import validate_dist_h2

    t_phase = time.perf_counter()
    shape, data, x, y = state["shape"], state["data"], state["x"], state["y"]
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dshape, ddata = partition_h2(shape, data, DIST_P, device=device)
    sync()
    t_part = time.perf_counter() - t0
    log(f"[dist] partition_h2 p={DIST_P}: {t_part:.3f} s; caps per level "
        f"{dshape.br_caps}, dense caps {dshape.dense_caps}, radius "
        f"{dshape.br_radius}/{dshape.dense_radius}")
    sync()
    t0 = time.perf_counter()
    rep = validate_dist_h2(dshape, ddata)
    sync()
    t_vdist = time.perf_counter() - t0
    log(f"[guard] validate_dist_h2 of the p={DIST_P} partition: "
        f"{rep.summary()}; {t_vdist:.3f} s")
    require(rep.ok, f"validate_dist_h2: {rep.summary()}")
    if on_card:
        halo_pack_timed(torch, timer, dshape, ddata, results)

    nloc = dshape.n_local()
    t0 = time.perf_counter()
    ranks = run_ranks(
        torch, _dist_rank_work, (dshape, tuple(state["ranks"])),
        [(local_shard(dshape, ddata, r), x[r * nloc:(r + 1) * nloc])
         for r in range(DIST_P)], device)
    t_ranks = time.perf_counter() - t0
    del ddata                        # the ranks are gone: free the shares
    if on_card:
        torch.cuda.ipc_collect()
    parent_peak = torch.cuda.max_memory_allocated() if on_card else 0

    mesh = mesh_phase(torch, state, device)
    r0 = ranks[0]
    log(f"[dist] transport: {r0['backend']}, host staging "
        f"{'on' if r0['host_staged'] else 'off'} (one card: NCCL refuses "
        f"two ranks on one device)")
    want_packs = expected_packs(dshape)
    model = matvec_comm_bytes(dshape, DIST_NV, "halo-plan")
    model_ag = matvec_comm_bytes(dshape, DIST_NV, "allgather")
    worst, worst_c = 0.0, 0.0
    for r, res in enumerate(ranks):
        rows = slice(r * nloc, (r + 1) * nloc)
        yr = res["y"].to(y.device)
        require(bool(torch.isfinite(yr).all()) and
                yr.shape == (nloc, DIST_NV), f"rank {r} output")
        rel = ((yr - y[rows]).norm() / y[rows].norm()).item()
        rel_c = ((res["y_c"].to(y.device) - yr).norm() / yr.norm()).item()
        worst, worst_c = max(worst, rel), max(worst_c, rel_c)
        packs = res["launches_per_hgemv"]["halo_pack"]
        log(f"[dist] rank {r}: vs single-device h2_matvec rows {rel:.3e} "
            f"(tol 1e-5); cuda vs torch backend bitwise "
            f"{res['bitwise_vs_torch']}; allgather vs halo-plan "
            f"{res['rel_allgather']:.3e}; compressed vs uncompressed "
            f"{rel_c:.3e} (tol 5e-3); halo_pack launches per HGEMV {packs} "
            f"(from dshape {want_packs}); received {res['recv_bytes']} "
            f"bytes (model {model}), gloo host staging "
            f"{res['staged_bytes']} bytes; allgather received "
            f"{res['recv_bytes_allgather']} (model {model_ag})")
        require(rel <= 1e-5, f"rank {r} distributed HGEMV {rel:.3e}")
        require(res["bitwise_vs_torch"], f"rank {r} cuda vs torch differ")
        require(rel_c <= 5e-3, f"rank {r} compressed {rel_c:.3e}")
        require(packs == want_packs and packs > 0,
                f"rank {r} halo_pack launches {packs} != {want_packs}")
        require(res["recv_bytes"] == model,
                f"rank {r} received {res['recv_bytes']} != model {model}")
    launches = {k: sum(res["launches_path"][k] for res in ranks) +
                mesh["launches"][k] for k in r0["launches_path"]}
    routes = {name: {r: sum(res["routes_path"][name][r] for res in ranks)
                     for r in rr} for name, rr in r0["routes_path"].items()}
    keys = ("hgemv_ms", "hgemv_plain_ms", "hgemv_allgather_ms",
            "hgemv_compressed_ms", "compress_s")
    times = {k: statistics.median(res[k] for res in ranks) for k in keys}
    log(f"[dist] median warm distributed HGEMV nv={DIST_NV}, p={DIST_P} "
        f"(host clock, barrier + synchronize around each call; median over "
        f"ranks): " + ", ".join(f"{k}={v:.3f}" for k, v in times.items()))
    phases = {k: statistics.median(res["phase_ms"].get(k, 0.0)
                                   for res in ranks)
              for k in sorted(r0["phase_ms"])}
    timed_call = statistics.median(res["phase_timed_call_ms"]
                                   for res in ranks)
    log("[dist] per-phase ms of one halo-plan HGEMV (synchronize at each "
        "phase boundary; nested phases overlap): " +
        ", ".join(f"{k}={v:.3f}" for k, v in phases.items()) +
        f"; the call itself took {timed_call:.3f} ms with phase timing on")
    peak_ranks = max(res["max_memory_allocated"] for res in ranks)
    log(f"[dist] launches over the distributed path (all ranks): {launches};"
        f" by route: {routes}")
    log(f"[memory] distributed phase: parent max_memory_allocated "
        f"{parent_peak} bytes (operator + partition), largest rank "
        f"{peak_ranks} bytes")
    t_phase = time.perf_counter() - t_phase
    log(f"[dist] phase took {t_phase:.1f} s (partition {t_part:.1f} s, "
        f"ranks {t_ranks:.1f} s, {MESH[0]} x {MESH[1]} mesh "
        f"{mesh['phase_s']:.1f} s)")
    return dict(launches=launches, routes=routes, rel_single=worst,
                validate_dist_s=t_vdist,
                mesh={k: v for k, v in mesh.items() if k != "launches"},
                rel_compressed=worst_c,
                packs_per_hgemv=want_packs, recv_bytes=r0["recv_bytes"],
                staged_bytes=r0["staged_bytes"], phase_ms=phases,
                phase_timed_call_ms=timed_call,
                partition_s=t_part, phase_s=t_phase, **times)


# ---------------------------------------------------------------------------
# solve phase: the §6.4 fractional-diffusion PCG solve with the GMG V-cycle
# ---------------------------------------------------------------------------

SOLVE_N = 512                  # N = 262,144: the paper's per-GPU load
# stag_window: at n = 512 the preconditioned residual's 2-norm climbs to
# about 3x its start by iteration 15 and is still above it at iteration 30,
# so the PCG's default 30-iteration window (the reference's) stops the
# solve there as stagnation; the phase logs that stop on the same operator
# and drives the solve with a 60-iteration window
SOLVE_ARGS = dict(beta=0.75, h2_tol=1e-6, tol=1e-8, maxiter=500,
                  stag_window=60)
# the plain backend's whole solve builds its own operator (its compress by
# torch.linalg, 5.1e-7 away from the kernels' on a random vector); float32
# resolves the solution of this system only to ~1e-3 at n = 512 (A applied
# to the solution in float32 is 4.5e-4 off its float64 value: D u and K u
# cancel), so the two solutions agree to that, not to 1e-4.  The same
# operator with the plain HGEMV is held to 1e-4.
TWIN_U_TOL = 5e-3
# the kernels' compress(tol=1e-6) against torch.linalg's (the plain
# build's): each is within about h2_tol of the uncompressed K, so the two
# compressed operators are within twice that of each other on a random
# vector (4x the 5.1e-7 this phase logs on an H100)
OP_GAP_TOL = 2e-6


def true_relres(torch, apply_a, b, u) -> float:
    """``||b - A u|| / ||b||`` with the difference and the norms taken in
    float64 (A as ``apply_a`` applies it)."""
    r = b.double() - apply_a(u.reshape(-1)).double()
    return (r.norm() / b.double().norm()).item()


def operator_f64(torch, prob):
    """The problem's operator ``h^2 (D + K + C)`` with its stored float32
    values evaluated in float64 (plain backend): ``D u`` and ``K u``
    cancel on smooth vectors, which float32 evaluation resolves only to a
    few digits."""
    import dataclasses
    from repro_torch.apps.fractional import apply_c
    from repro_torch.core.matvec import h2_matvec

    def f64(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.double()
        return [f64(t) for t in v] if isinstance(v, list) else v

    data = prob["data"]
    d64 = dataclasses.replace(data, **{
        f.name: f64(getattr(data, f.name))
        for f in dataclasses.fields(data) if f.name != "plan"})
    dev = prob["d_diag"].device
    perm = torch.as_tensor(prob["perm"], device=dev)
    unperm = torch.as_tensor(prob["unperm"], device=dev)
    d, kappa = prob["d_diag"].double(), prob["kappa"].double()
    h, gamma, n = prob["h"], prob["gamma"], prob["n"]

    def apply_a(u):
        u = u.double()
        ku = h2_matvec(prob["shape"], d64, u[perm][:, None],
                       backend="torch")[:, 0][unperm]
        cu = apply_c(u.reshape(n, n), kappa, h).reshape(-1)
        return (h * h) * (d * u + ku + gamma * cu)

    return apply_a


def device_ops(torch, fn, x) -> int:
    """ATen operations one call of ``fn(x)`` dispatches that do device work
    (views, allocations and profiler marks left out), plus the hand-written
    kernels' launches: about the kernels an eager call launches, and a
    captured one replays."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import ops

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.name()
            if not (func.is_view or "empty" in name or "_unsafe_view" in name
                    or name.startswith("profiler::")):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    before = sum(ops.launch_counts().values())
    with Count():
        fn(x)
    return Count.n + sum(ops.launch_counts().values()) - before


def graph_split(torch, apply_a, pre, b, reps: int = 20) -> dict:
    """Device milliseconds of one operator application and one
    preconditioner application, each captured alone into a CUDA graph and
    replayed ``reps`` times between two CUDA events (the pieces of a
    graph-replayed iteration)."""
    out = {}
    for name, fn in (("apply-A", apply_a), ("precond", pre)):
        x = b.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(x)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(x)
        g.replay()
        a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            g.replay()
        z.record()
        z.synchronize()
        out[name] = a.elapsed_time(z) / reps
        del g
    return out


def recorded_gemms(torch, shape, data, x) -> list:
    """(name, a, b) of every ``batched_gemm`` call of one HGEMV, in call
    order, recorded on the real inputs (the upsweep's leaf and transfer
    products, the downsweep's transfers and leaf)."""
    from repro_torch.core.matvec import h2_matvec
    from repro_torch.kernels import ops
    calls, real = [], ops.batched_gemm

    def record(a, b, backend="cuda"):
        calls.append((a, b))
        return real(a, b, backend)

    ops.batched_gemm = record
    try:
        h2_matvec(shape, data, x, backend="cuda")
    finally:
        ops.batched_gemm = real
    q = shape.depth
    names = ([f"leaf V^T x l={q}"] +
             [f"F^T l={l}" for l in range(q, 0, -1)] +
             [f"E l={l}" for l in range(1, q + 1)] + [f"leaf U l={q}"])
    require(len(calls) == len(names),
            f"{len(calls)} batched_gemm calls per HGEMV, expected "
            f"{len(names)}")
    return [(nm, a, b) for nm, (a, b) in zip(names, calls)]


def iteration_split(torch, apply_a, pre, b, steps: int) -> dict:
    """Milliseconds per PCG iteration by phase: CUDA events at each phase's
    entry and exit over one eager segment of ``steps`` iterations, all of
    them active (a phase's time includes the host's enqueue gaps).  The
    HGEMV's own share is the sum of its four phases (inside apply-A)."""
    from repro_torch.obs.trace import phase_events
    from repro_torch.solvers import krylov
    state = krylov.pcg_init(apply_a, b, pre)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with phase_events() as ph:
        out = krylov.pcg_segment(apply_a, b, state, pre, steps=steps,
                                 maxiter=10 * steps, graph=False)
    wall = (time.perf_counter() - t0) * 1e3
    require(int(out.k) == steps, "the timed eager segment stopped early")
    split = {k: v / steps for k, v in sorted(ph.items())}
    split["hgemv (sum of hgemv/*)"] = sum(v for k, v in split.items()
                                          if k.startswith("hgemv/"))
    split["wall per iteration (host clock)"] = wall / steps
    return split


def tally_start() -> tuple:
    """The launch tallies ``launches_that_ran`` counts from."""
    from repro_torch.solvers import graphs
    return (graphs.launch_tally(), dict(graphs.CAPTURED_LAUNCHES),
            dict(graphs.REPLAYED_LAUNCHES))


def launches_that_ran(start: tuple) -> tuple:
    """Launches since ``start`` (``tally_start()``): the wrappers' counts,
    less their calls while a CUDA graph was captured (recorded, not run),
    plus the graph replays' (no wrapper sees those).  Returns (per kernel,
    per kernel and route, the three tallies)."""
    from repro_torch.solvers import graphs
    counted0, captured0, replayed0 = start
    counted = {k: v - counted0.get(k, 0)
               for k, v in graphs.launch_tally().items()}
    captured = {k: graphs.CAPTURED_LAUNCHES[k] - captured0.get(k, 0)
                for k in counted}
    replayed = {k: graphs.REPLAYED_LAUNCHES[k] - replayed0.get(k, 0)
                for k in counted}
    ran = {k: counted[k] - captured[k] + replayed[k] for k in counted}
    routes: dict = {}
    for k, v in ran.items():
        if "/" in k:
            name, route = k.split("/")
            routes.setdefault(name, {})[route] = v
    return ({k: v for k, v in ran.items() if "/" not in k}, routes,
            dict(wrappers=counted, captured=captured, replayed=replayed))


def solve_phase(torch, timer, n: int = SOLVE_N, device: str = "cuda"
                ) -> tuple:
    """``repro_torch.apps.fractional.solve(n)`` on the card with the kernels
    and its iterations replayed from CUDA graphs (launches counted over the
    whole call, the build included), then on the same operator: the true
    residual, eager against graph, one segment replayed against the same
    segment run eagerly (bitwise), the per-iteration split of an eager
    segment, and the HGEMV's nv = 1 ``batched_gemm`` and ``coupling_mv``
    launches beside their bounds; then the same solve with the plain
    backend, its compressed K held against the kernels' (ranks, HGEMV),
    and ``solve(16)`` against the dense direct solve.  Returns the
    phase's results and what the distributed solve reuses (the problem,
    the solution and its iterations).  The solve path's
    launches are those that ran: the replays' included, the calls recorded
    while capturing left out.
    ``device="cpu"`` rehearses the phase without a card (no kernel runs,
    so the launch checks fail there)."""
    from repro_torch.apps import fractional as pf
    from repro_torch.kernels import ops
    from repro_torch.solvers import krylov

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    start = tally_start()
    captures0 = dict(krylov.TRACE_COUNTS)
    sync()
    t0 = time.perf_counter()
    res = pf.solve(n, device=device, backend="cuda", **SOLVE_ARGS)
    sync()
    t_total = time.perf_counter() - t0
    # the solve path ends here
    launches, routes, tally = launches_that_ran(start)
    captures = {k: v - captures0[k] for k, v in krylov.TRACE_COUNTS.items()
                if v != captures0[k]}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    prob, tm = res["prob"], res["timings"]
    shape = prob["shape"]
    log(f"[solve] solve(n={n}, N={n * n}, " +
        ", ".join(f"{k}={v}" for k, v in SOLVE_ARGS.items()) +
        f", backend=cuda): build parts (s) " +
        ", ".join(f"{k}={v:.3f}" for k, v in tm.items() if k != "solve") +
        f"; whole call {t_total:.3f} s; max_memory_allocated {peak} bytes")
    log(f"[solve] K: depth {shape.depth}, leaf {shape.leaf_size}, ranks "
        f"after compress(tol={SOLVE_ARGS['h2_tol']}) {shape.ranks}, "
        f"operator {prob['data'].nbytes()} bytes")
    b = torch.ones((n * n,), dtype=torch.float32, device=device) * \
        (2.0 / n) ** 2
    apply_a = pf.make_operator(prob, backend="cuda")
    runs = [("float32 scalars", res)]
    if res["status"] != 0 or not res["converged"]:
        log(f"[solve] float32 scalars: status {res['status']}, relres "
            f"{res['relres']:.3e} after {res['iters']} iterations: the fp64 "
            f"scalar rung runs")
        res = pf.solve(n, device=device, backend="cuda",
                       scalar_dtype=torch.float64, **SOLVE_ARGS)
        runs.append(("float64 scalars", res))
    a64 = operator_f64(torch, prob)
    for what, r in runs:
        tr = true_relres(torch, apply_a, b, r["u"])
        r["true_relres"] = tr
        r["true_relres_f64"] = true_relres(torch, a64, b, r["u"])
        log(f"[solve] {what}: {r['iters']} iterations, status {r['status']}"
            f" ({'converged' if r['converged'] else 'NOT converged'}), "
            f"recurrence relres {r['relres']:.3e}, true relres {tr:.3e} "
            f"(operator in float32, as the solve applies it), "
            f"{r['true_relres_f64']:.3e} (its values in float64); solve "
            f"{r['timings']['solve']:.3f} s "
            f"({r['timings']['solve'] / max(r['iters'], 1) * 1e3:.3f} ms "
            f"per iteration, capture included), {r['host_syncs']} host "
            f"syncs (one per segment of {krylov.SEGMENT_STEPS})")
    sdt = torch.float64 if len(runs) > 1 else None
    require(res["status"] == 0 and res["converged"] and
            res["relres"] <= SOLVE_ARGS["tol"],
            f"solve(n={n}) status {res['status']}, relres {res['relres']}")
    require(bool(torch.isfinite(res["u"]).all()) and
            res["u"].shape == (n, n), "solution not finite or misshapen")
    u_flat = res["u"].reshape(-1)
    eval_err = ((apply_a(u_flat).double() - a64(u_flat)).norm() /
                a64(u_flat).norm()).item()
    xr = torch.randn(n * n, generator=torch.Generator().manual_seed(4)
                     ).to(device)
    eval_err_rand = ((apply_a(xr).double() - a64(xr)).norm() /
                     a64(xr).norm()).item()
    log(f"[solve] A applied in float32 against float64 (same values): "
        f"{eval_err:.3e} relative on the solution (D u and K u cancel), "
        f"{eval_err_rand:.3e} on a random vector")
    del a64
    pre = pf.make_preconditioner(prob, device=device)
    state = krylov.pcg_init(apply_a, b, pre)
    out_ops = {name: device_ops(torch, fn, b) for name, fn in (
        ("apply-A", apply_a), ("precond", pre),
        ("iteration", lambda v: krylov.pcg_segment(
            apply_a, v, state, pre, steps=1, graph=False)))}
    log(f"[solve] device operations (ATen ops that do device work, plus "
        f"the kernels' launches) per eager call: {out_ops}")
    log(f"[solve] launches that ran on the solve path (build included): "
        f"{launches}; by route: {routes}; segment captures {captures}; of "
        f"them: the wrappers' counts {tally['wrappers']}, less the calls "
        f"recorded while capturing {tally['captured']}, plus the launches "
        f"replayed from the graphs {tally['replayed']}")

    out = dict(n=n, iters=res["iters"], relres=res["relres"],
               true_relres=res["true_relres"],
               true_relres_f64=res["true_relres_f64"],
               f32_eval_err=dict(solution=eval_err, random=eval_err_rand),
               device_ops=out_ops,
               status=res["status"],
               scalar_dtype=str(sdt), build_s={k: v for k, v in tm.items()
                                               if k != "solve"},
               solve_s=res["timings"]["solve"], host_syncs=res["host_syncs"],
               call_s=t_total, max_memory_allocated=peak, ranks=shape.ranks,
               launches=launches, routes=routes,
               launch_tally=tally,
               fp32_first=dict(iters=runs[0][1]["iters"],
                               relres=runs[0][1]["relres"],
                               status=runs[0][1]["status"]))

    pcg_args = dict(tol=SOLVE_ARGS["tol"], maxiter=SOLVE_ARGS["maxiter"],
                    stag_window=SOLVE_ARGS["stag_window"], scalar_dtype=sdt)
    # the same solve with the default (the reference's) stagnation window
    r = krylov.pcg(apply_a, b, pre, tol=SOLVE_ARGS["tol"],
                   maxiter=SOLVE_ARGS["maxiter"], scalar_dtype=sdt,
                   graph=on_card)
    hist = r.res_history[:int(r.iters) + 1].cpu()
    out["default_window"] = dict(iters=int(r.iters), status=int(r.status),
                                 relres=float(r.relres),
                                 peak_relres=float(hist.max()))
    log(f"[solve] the same PCG with the default stag_window=30: "
        f"{int(r.iters)} iterations, status {int(r.status)}, relres "
        f"{float(r.relres):.3e} (history peak {float(hist.max()):.3f} at "
        f"iteration {int(hist.argmax())})")

    # eager against graph on the same operator and preconditioner
    timing = {}
    for what, graph in (("graph, capture included", True),
                        ("graph, warm", True), ("eager", False)):
        sync()
        t0 = time.perf_counter()
        r = krylov.pcg(apply_a, b, pre, graph=graph and on_card, **pcg_args)
        sync()
        wall = time.perf_counter() - t0
        it = int(r.iters)
        timing[what] = dict(s=wall, iters=it, ms_per_iter=wall / it * 1e3)
        log(f"[solve] pcg {what}: {it} iterations in {wall:.3f} s, "
            f"{wall / it * 1e3:.3f} ms per iteration")
        require(it == res["iters"] and torch.equal(r.x.reshape(n, n),
                                                   res["u"]),
                f"pcg ({what}) differs from the solve: {it} iterations "
                f"against {res['iters']}")
    out["pcg_timing"] = timing
    if on_card:
        require(krylov.TRACE_COUNTS["pcg"] - captures0["pcg"] ==
                2 + len(runs), "a warm graph solve captured again")
        # one segment replayed from its graph against the same segment run
        # eagerly, from the same state: bitwise
        state = krylov.pcg_init(apply_a, b, pre)
        seg = {g: krylov.pcg_segment(apply_a, b, state, pre,
                                     tol=SOLVE_ARGS["tol"],
                                     steps=krylov.SEGMENT_STEPS,
                                     maxiter=SOLVE_ARGS["maxiter"], graph=g)
               for g in (False, True)}
        same = {f: torch.equal(getattr(seg[False], f), getattr(seg[True], f))
                for f in ("x", "r", "k")}
        log(f"[solve] one segment of {krylov.SEGMENT_STEPS} iterations, "
            f"graph vs eager from the same state: bitwise equal {same}")
        require(all(same.values()), f"graph segment differs: {same}")
        split = iteration_split(torch, apply_a, pre, b,
                                krylov.SEGMENT_STEPS)
        out["iteration_split_ms"] = split
        log("[solve] per-iteration split of an eager segment (ms, CUDA "
            "events at each phase's entry and exit; nested phases "
            "overlap): " + ", ".join(f"{k}={v:.3f}" for k, v in
                                     split.items()))
        gsplit = graph_split(torch, apply_a, pre, b)
        out["graph_split_ms"] = gsplit
        log("[solve] one application captured alone and replayed (ms by "
            "CUDA events, mean of 20 replays): " +
            ", ".join(f"{k}={v:.3f}" for k, v in gsplit.items()) +
            f"; graph-replayed iteration (warm solve) "
            f"{timing['graph, warm']['ms_per_iter']:.3f}")
        # the same operator with the plain HGEMV (no kernel in the loop)
        a_plain = pf.make_operator(prob, backend="torch")
        r = krylov.pcg(a_plain, b, pre, **pcg_args)
        same_rel = ((r.x.reshape(n, n) - res["u"]).norm() /
                    res["u"].norm()).item()
        out.update(same_op_plain_iters=int(r.iters), same_op_plain_u_rel=
                   same_rel)
        log(f"[solve] the same operator with the plain HGEMV "
            f"(backend=torch): {int(r.iters)} iterations against "
            f"{res['iters']}, u rel err {same_rel:.3e} (tol 1e-4)")
        require(abs(int(r.iters) - res["iters"]) <= 2 and same_rel <= 1e-4,
                f"plain HGEMV solve: {int(r.iters)} iterations, u "
                f"{same_rel:.3e}")
        del a_plain
        # the HGEMV at nv = 1: every batched_gemm and coupling_mv launch
        x1 = torch.randn(shape.n, 1, generator=torch.Generator()
                         .manual_seed(3)).to(device)
        gemms = gemm_timings(torch, timer,
                             recorded_gemms(torch, shape, prob["data"], x1),
                             lambda *s: torch.randn(*s, device=device))
        sums = {k: sum(row[k] for row in gemms["shapes"])
                for k in ("ms", "library_ms", "plain_ms", "bound_ms")}
        log("[solve] batched_gemm over one nv=1 HGEMV of K, summed: " +
            ", ".join(f"{k}={v:.4f}" for k, v in sums.items()))
        out["nv1_gemm"] = dict(shapes=gemms["shapes"], sums=sums)
        out["nv1_coupling"] = coupling_level_timings(
            torch, timer, shape, prob["data"], x1, "solve K nv=1")
    u, iters, hist1 = res["u"], res["iters"], res["history"].cpu()
    kdata, kperm = prob["data"], prob["perm"]
    # what the distributed solve reuses: the problem (K compressed on the
    # card, d_diag, kappa, perms) and this solve's solution
    keep = dict(prob=prob, u=u, iters=iters, history=hist1)
    del apply_a, pre, prob, res, runs        # their graphs go with them
    if on_card:
        torch.cuda.empty_cache()

    # the same solve on the plain backend (no kernel)
    sync()
    t0 = time.perf_counter()
    plain = pf.solve(n, device=device, backend="torch", scalar_dtype=sdt,
                     **SOLVE_ARGS)
    sync()
    t_plain = time.perf_counter() - t0
    u_rel = ((plain["u"] - u).norm() / plain["u"].norm()).item()
    log(f"[solve] backend=torch (plain PyTorch, graphs; its own build, "
        f"compress by torch.linalg): {plain['iters']} iterations, status "
        f"{plain['status']}, relres {plain['relres']:.3e}, ranks "
        f"{plain['prob']['shape'].ranks}; whole call {t_plain:.3f} s (solve "
        f"{plain['timings']['solve']:.3f} s); cuda vs torch: iterations "
        f"{iters} vs {plain['iters']}, u rel err {u_rel:.3e} (tol "
        f"{TWIN_U_TOL:g}: the float32 solution's own accuracy, see above)")
    require(plain["status"] == 0 and abs(plain["iters"] - iters) <= 2,
            f"plain backend took {plain['iters']} iterations against "
            f"{iters}")
    require(u_rel <= TWIN_U_TOL, f"cuda vs plain solution {u_rel:.3e}")
    out.update(plain_iters=plain["iters"], plain_call_s=t_plain,
               plain_solve_s=plain["timings"]["solve"], plain_u_rel=u_rel)
    # the kernels' compress (batched_qr, batched_svd) against
    # torch.linalg's, on the operator the solve built: the same ranks, and
    # both compressed operators, applied by the plain HGEMV, within
    # OP_GAP_TOL of each other on one random vector
    from repro_torch.core.matvec import h2_matvec
    pshape, pdata = plain["prob"]["shape"], plain["prob"]["data"]
    xg = torch.randn(shape.n, 1, generator=torch.Generator().manual_seed(6)
                     ).to(device)
    yk = h2_matvec(shape, kdata, xg, backend="torch")
    yp = h2_matvec(pshape, pdata, xg, backend="torch")
    gap = ((yk - yp).norm() / yp.norm()).item()
    log(f"[solve] compressed K, kernels' compress vs torch.linalg's: ranks "
        f"{shape.ranks} vs {pshape.ranks}, HGEMV (plain, both) on a random "
        f"vector {gap:.3e} relative (tol {OP_GAP_TOL:g})")
    require(pshape.ranks == shape.ranks and
            torch.equal(torch.as_tensor(plain["prob"]["perm"]),
                        torch.as_tensor(kperm)),
            f"the kernels' compress picked ranks {shape.ranks}, "
            f"torch.linalg's {pshape.ranks}")
    require(gap <= OP_GAP_TOL, f"compressed K vs the plain build's {gap:.3e}")
    out["compress_gap"] = gap
    del plain, u, kdata, pdata, yk, yp

    # solve(16) against the dense direct solve (the reference's own check)
    small = pf.solve(16, h2_tol=1e-7, tol=1e-10, device=device)
    dense = torch.as_tensor(pf.dense_reference_solution(16))
    err = ((small["u"].cpu().double() - dense).norm() / dense.norm()).item()
    log(f"[solve] solve(16, h2_tol=1e-7, tol=1e-10) on {device}: "
        f"{small['iters']} iterations, status {small['status']}; vs the "
        f"dense direct solve {err:.3e} (tol 2e-2)")
    require(small["status"] == 0 and err < 2e-2,
            f"solve(16) vs dense {err:.3e}")
    out["dense16_rel_err"] = err
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[solve] phase took {out['phase_s']:.1f} s")
    return out, keep


# ---------------------------------------------------------------------------
# distributed solve phase: the §6.4 solve over DIST_P ranks on the card
# ---------------------------------------------------------------------------

DSOLVE_MODE = "halo-plan"
# the two-step schedule (all_gather transpositions, per-level exchanges,
# one-row V-cycle halos) is held to the fused one over this many
# iterations from the same start instead of a whole solve, which would
# take the phase past ~150 s at ~0.3-0.5 s an iteration (PERF.md §6); 10
# (one segment) rather than 30 or 20 keeps the whole script within its
# time limit
TWO_STEP_ITERS = 10
# the two schedules' H^2 products may sum in other orders; over
# TWO_STEP_ITERS iterations their iterates stay within the phase's
# solution bound
DSOLVE_U_TOL = 1e-4
# iterations: the rate (iterations to reach 1e-6) within 2 of the single
# device's, the final count within 5.  At tol 1e-8 the count sits on the
# float32 floor: both solves' recurrences hover at 0.86-1.7e-8 over their
# last 8 iterations (the phase's tail line), so the order of the sums
# moves the count by a few iterations (258 against 261 on an H100, both
# reaching 1e-6 at iteration 177; PERF.md §6)
DSOLVE_RATE_SLACK = 2
DSOLVE_ITER_SLACK = 5


def _dsolve_rank_work(rank: int, args, on_card: bool, dshape, mg, n: int,
                      h: float) -> dict:
    """The distributed solve on one rank: the fused halo-plan PCG to the
    end (eager), one iteration split by phase with its received bytes,
    then the fused and the two-step schedules over ``TWO_STEP_ITERS``
    iterations from the same start.  ``args``: the rank's views
    (``local_args``).  Returns host tensors and numbers."""
    import torch
    from repro_torch.apps import fractional as pf
    from repro_torch.core.comm import Comm
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import phase_times
    from repro_torch.solvers import graphs, krylov

    torch.backends.cuda.matmul.allow_tf32 = False
    comm = Comm()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dev = args[0].u_leaf.device
    b = torch.ones((n * n // dshape.p,), dtype=torch.float32,
                   device=dev) * h * h
    solve_kw = dict(mode=DSOLVE_MODE, tol=SOLVE_ARGS["tol"],
                    maxiter=SOLVE_ARGS["maxiter"],
                    stag_window=SOLVE_ARGS["stag_window"], backend="cuda")
    parts = pf.make_dist_solve_local(dshape, mg, args, comm, n, h,
                                     fused=True, **solve_kw)
    res = {"tcaps": parts["tcaps"]}

    # the path: counts set to 0 just before, read just after
    comm.barrier()
    sync()
    ops.reset_launch_counts()
    comm.reset_counts()
    syncs = graphs.HOST_SYNCS
    t0 = time.perf_counter()
    sol = parts["fn"](b)
    sync()
    res["solve_s"] = time.perf_counter() - t0
    res["launches"] = ops.launch_counts()
    res["recv_bytes_solve"] = comm.recv_bytes
    res["host_syncs"] = graphs.HOST_SYNCS - syncs
    res.update(iters=int(sol.iters), status=int(sol.status),
               relres=float(sol.relres), converged=bool(sol.converged),
               history=sol.res_history.cpu(), x=sol.x.cpu())

    # one iteration, synchronized at every phase boundary, and its bytes
    pre, apply_a = parts["precond"], parts["apply_a"]
    st = krylov.pcg_init(apply_a, b, pre, comm=comm)
    comm.barrier()
    comm.reset_counts()
    with phase_times(sync) as pt:
        krylov._pcg_step(apply_a, pre, st.x, st.r, st.p, st.rz, comm=comm)
    res["iteration_bytes"] = comm.recv_bytes
    res["iteration_phase_ms"] = dict(pt)

    # fused against two-step over TWO_STEP_ITERS iterations
    steps = krylov.SEGMENT_STEPS
    two = pf.make_dist_solve_local(dshape, mg, args, comm, n, h,
                                   fused=False, **solve_kw)
    for what, pp in (("fused", parts), ("two_step", two)):
        state = krylov.pcg_init(pp["apply_a"], b, pp["precond"], comm=comm)
        comm.barrier()
        sync()
        t0 = time.perf_counter()
        for _ in range(TWO_STEP_ITERS // steps):
            state = krylov.pcg_segment(pp["apply_a"], b, state,
                                       pp["precond"], tol=SOLVE_ARGS["tol"],
                                       steps=steps,
                                       maxiter=SOLVE_ARGS["maxiter"],
                                       comm=comm)
        sync()
        res[f"{what}_ms_per_iter"] = (time.perf_counter() - t0) * 1e3 / \
            TWO_STEP_ITERS
        res[f"{what}_k"] = int(state.k)
        res[f"{what}_x"] = state.x.cpu()
    st = krylov.pcg_init(two["apply_a"], b, two["precond"], comm=comm)
    comm.reset_counts()
    krylov._pcg_step(two["apply_a"], two["precond"], st.x, st.r, st.p,
                     st.rz, comm=comm)
    res["two_step_iteration_bytes"] = comm.recv_bytes
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if on_card else 0
    comm.barrier()
    return res


def to_reach(hist, level: float) -> int:
    """The first iteration whose recurrence residual is at most ``level``
    (-1 if none)."""
    hit = (hist <= level).nonzero()
    return int(hit[0]) if len(hit) else -1


def dsolve_phase(torch, keep: dict, device: str = "cuda") -> dict:
    """The §6.4 solve over ``DIST_P`` ranks on the one card: the parent
    partitions the single-device solve's problem (``build_dist_problem``,
    K compressed on the card, no second build of the extended operator)
    and hands each of ``DIST_P`` spawned gloo ranks its views over CUDA
    IPC; each runs the fused halo-plan PCG (``make_dist_solve_local``).
    Holds every rank to the same iterations and status, the gathered
    solution to the single-device one, the counted bytes of an iteration
    to ``dist_solve_comm_bytes`` and the two-step schedule to the fused
    one.  ``device="cpu"`` rehearses the phase without a card (no kernel
    runs, so the launch check fails there)."""
    from repro_torch.apps import fractional as pf
    from repro_torch.solvers.krylov import SEGMENT_STEPS

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prob, u1, iters1 = keep["prob"], keep["u"], keep["iters"]
    n, h = prob["n"], prob["h"]
    sync()
    t0 = time.perf_counter()
    dshape, mg, args = pf.build_dist_problem(prob, DIST_P, device=device)
    sync()
    t_build = time.perf_counter() - t0
    log(f"[dsolve] build_dist_problem(n={n}, p={DIST_P}) {t_build:.3f} s: "
        f"K depth {dshape.depth}, C-level {dshape.lc}, {n // DIST_P} grid "
        f"rows per rank; V-cycle levels {mg.levels}, the first "
        f"{mg.n_sharded} sharded; transposition caps "
        f"{args[1]['tin_send'].shape[1]} in, "
        f"{args[1]['tout_send'].shape[1]} out (of {n * n // DIST_P} rows)")
    t0 = time.perf_counter()
    ranks = run_ranks(torch, _dsolve_rank_work, (dshape, mg, n, h),
                      [pf.local_args(dshape, mg, args, r)
                       for r in range(DIST_P)], device)
    t_ranks = time.perf_counter() - t0
    # the stacked partition stays for [chaos]; the views are gone
    keep["dsolve_dist"] = (dshape, args[0])
    del args
    if on_card:
        torch.cuda.ipc_collect()

    r0 = ranks[0]
    keep["dsolve_history"] = r0["history"]
    keep["dsolve_relres"] = r0["relres"]
    model = pf.dist_solve_comm_bytes(dshape, mg, DSOLVE_MODE,
                                     tcaps=r0["tcaps"], fused=True)
    model_two = pf.dist_solve_comm_bytes(dshape, mg, DSOLVE_MODE,
                                         fused=False)
    steps_run = r0["host_syncs"] * SEGMENT_STEPS
    packs_per_iter = 3        # the two transpositions + the merged exchange
    for r, res in enumerate(ranks):
        log(f"[dsolve] rank {r}: {res['iters']} iterations, status "
            f"{res['status']}, relres {res['relres']:.3e}; solve "
            f"{res['solve_s']:.3f} s ({res['host_syncs']} segments); "
            f"received {res['recv_bytes_solve']} bytes in the solve; one "
            f"iteration received {res['iteration_bytes']} bytes (model "
            f"{model}), two-step {res['two_step_iteration_bytes']} (model "
            f"{model_two}); halo_pack launches {res['launches']['halo_pack']}"
            f"; max_memory_allocated {res['max_memory_allocated']}")
        require(res["iters"] == r0["iters"] and
                res["status"] == r0["status"] and
                res["relres"] == r0["relres"] and
                torch.equal(res["history"].nan_to_num(-1.0),
                            r0["history"].nan_to_num(-1.0)),
                f"rank {r} disagrees with rank 0: {res['iters']} "
                f"iterations, status {res['status']}")
        require(res["iteration_bytes"] == model,
                f"rank {r} received {res['iteration_bytes']} bytes in one "
                f"iteration, model {model}")
        require(res["two_step_iteration_bytes"] == model_two,
                f"rank {r} two-step iteration received "
                f"{res['two_step_iteration_bytes']}, model {model_two}")
        require(res["launches"]["halo_pack"] == packs_per_iter * steps_run,
                f"rank {r} halo_pack launches {res['launches']['halo_pack']}"
                f" != {packs_per_iter} x {steps_run} iterations run")
    rate = {what: [to_reach(h, t) for t in (1e-6, 1e-7)]
            for what, h in (("distributed", r0["history"]),
                            ("single device", keep["history"]))}
    tails = {what: [f"{v:.3e}" for v in h[max(0, k - 7):k + 1].tolist()]
             for what, h, k in (("distributed", r0["history"], r0["iters"]),
                                ("single device", keep["history"], iters1))}
    log(f"[dsolve] iterations to reach 1e-6 and 1e-7: {rate}; the last 8 "
        f"recurrence residuals: {tails}")
    u = torch.cat([res["x"] for res in ranks]).reshape(n, n)
    keep["dsolve_u"] = u
    u_rel = ((u.double() - u1.cpu().double()).norm() /
             u1.cpu().double().norm()).item()
    fused_x = torch.cat([res["fused_x"] for res in ranks])
    two_x = torch.cat([res["two_step_x"] for res in ranks])
    two_rel = ((two_x.double() - fused_x.double()).norm() /
               fused_x.double().norm()).item()
    ms_iter = statistics.median(res["solve_s"] / res["iters"] * 1e3
                                for res in ranks)
    phases = {k: statistics.median(res["iteration_phase_ms"].get(k, 0.0)
                                   for res in ranks)
              for k in sorted(r0["iteration_phase_ms"])}
    two_ms = {k: statistics.median(res[f"{k}_ms_per_iter"] for res in ranks)
              for k in ("fused", "two_step")}
    launches = {k: sum(res["launches"][k] for res in ranks)
                for k in r0["launches"]}
    log(f"[dsolve] fused {DSOLVE_MODE} PCG over {DIST_P} gloo ranks on one "
        f"card, eager: {r0['iters']} iterations (single device "
        f"{iters1}), status {r0['status']}, recurrence relres "
        f"{r0['relres']:.3e}; {ms_iter:.3f} ms per iteration (median over "
        f"ranks of solve time / iterations; {steps_run} iterations ran, "
        f"the masked tail of the last segment included); gathered u vs "
        f"the single-device solve {u_rel:.3e} (tol {DSOLVE_U_TOL:g})")
    log("[dsolve] one iteration by phase (ms, synchronize at each phase "
        "boundary, median over ranks; nested phases overlap): " +
        ", ".join(f"{k}={v:.3f}" for k, v in phases.items()))
    log(f"[dsolve] two-step schedule vs fused over {TWO_STEP_ITERS} "
        f"iterations from the same start: iterate rel diff {two_rel:.3e} "
        f"(tol {DSOLVE_U_TOL:g}); ms per iteration " +
        ", ".join(f"{k}={v:.3f}" for k, v in two_ms.items()))
    log(f"[dsolve] launches over the distributed solve (all ranks): "
        f"{launches}")
    require(r0["status"] == 0 and r0["converged"],
            f"distributed solve status {r0['status']}")
    require(abs(rate["distributed"][0] - rate["single device"][0]) <=
            DSOLVE_RATE_SLACK and abs(r0["iters"] - iters1) <=
            DSOLVE_ITER_SLACK,
            f"distributed solve took {rate['distributed'][0]} iterations to "
            f"1e-6 and {r0['iters']} in all, single device "
            f"{rate['single device'][0]} and {iters1}")
    require(bool(torch.isfinite(u).all()) and u_rel <= DSOLVE_U_TOL,
            f"distributed u vs single device {u_rel:.3e}")
    require(all(res["fused_k"] == res["two_step_k"] == TWO_STEP_ITERS
                for res in ranks), "the schedules' segments stopped early")
    require(two_rel <= DSOLVE_U_TOL, f"two-step vs fused {two_rel:.3e}")
    require(launches["halo_pack"] > 0, "halo_pack was not launched on the "
            "distributed solve")
    t_phase = time.perf_counter() - t_phase
    log(f"[dsolve] phase took {t_phase:.1f} s (build {t_build:.1f} s, "
        f"ranks {t_ranks:.1f} s)")
    return dict(iters=r0["iters"], single_iters=iters1, to_reach=rate,
                status=r0["status"], relres=r0["relres"], u_rel=u_rel,
                ms_per_iter=ms_iter, iterations_run=steps_run,
                iteration_bytes=r0["iteration_bytes"], model_bytes=model,
                two_step_iteration_bytes=r0["two_step_iteration_bytes"],
                two_step_model_bytes=model_two,
                solve_recv_bytes=r0["recv_bytes_solve"],
                iteration_phase_ms=phases, schedules_ms_per_iter=two_ms,
                two_step_rel=two_rel, tcaps=r0["tcaps"], launches=launches,
                build_s=t_build, phase_s=t_phase,
                max_memory_allocated=max(res["max_memory_allocated"]
                                         for res in ranks))


# ---------------------------------------------------------------------------
# chaos phase: the elastic distributed §6.4 solve (checkpoints, remesh)
# ---------------------------------------------------------------------------

# the drills' tolerance: float32 evaluation of A leaves the recomputed
# residual of the n = 512 solution on a plateau (7.8e-4, the [solve]
# line's "true relres") that the reference's tripwire ``true > 10 * rec +
# 1e-5`` reads as corruption once the recurrence falls below it / 10; at
# tol 1e-4 the tripwire's floor 10 * tol + 1e-5 stays above the plateau
# (required with a margin: a higher plateau fails here, not as a flake)
CHAOS_TOL = 1e-4
CHAOS_EVERY = 10
CHAOS_MAXITER = 500
CHAOS_PLAN = dict(device_loss_at={3: 2}, nan_at={6}, straggle_at={8: 1000.0})
CHAOS_STRAGGLER = dict(threshold=3.0, warmup=3)
CHAOS_ITER_SLACK = 2
CHAOS_U_TOL = 1e-3             # tol 1e-4 resolves u to about this
CHAOS_MARGIN = 0.9             # plateau <= margin x the tripwire's floor
# the cut pieces: N = 4,096 (cut from n = 128 to keep the whole script
# within its time limit)
CHAOS_CUT_N = 64
CHAOS_CUT_EVERY = 4            # the bf16 drill's checkpoint interval
# the cut pieces' tolerance: the float32 plateau at n = 128 (9.1e-5 on the
# CPU) is above the tripwire's floor at the reference's tol 1e-8 (1.0e-5)
# as at n = 512; 2e-5 keeps the floor (2.1e-4) twice above it (n = 64's
# plateau is lower)
CHAOS_CUT_TOL = 2e-5


def _chaos_rank_work(rank: int, payload, on_card: bool, ckpt_root: str,
                     dsolve_u, dsolve_relres: float) -> dict:
    """The elastic solves on one rank of the world group: the tripwire on
    ``[dsolve]``'s final state, the fault-free and the faulted n = 512
    runs, then the n = 64 pieces (the elastic solve against the
    monolithic one at tol 1e-8, the bf16 escalation drill).  ``payload``:
    per n, the grid arrays and the stacked p = 4 partition (CUDA IPC).
    Returns host tensors and numbers."""
    import torch
    from repro_torch.apps import fractional as pf
    from repro_torch.core.comm import Comm
    from repro_torch.guard import GUARD_COUNTERS
    from repro_torch.kernels import ops
    from repro_torch.runtime.chaos import ChaosPlan
    from repro_torch.runtime.fault import StragglerMonitor
    from repro_torch.solvers.krylov import PCGState

    torch.backends.cuda.matmul.allow_tf32 = False
    comm = Comm()
    dev = torch.device("cuda" if on_card else "cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    grid, dshape, ddata = payload["main"]
    n = grid["n"]
    out: dict = {}

    def summary(r, t):
        if r["lost_at"] is not None:
            return dict(r, seconds=t)
        rep, fin = r["report"], r["parts"]
        return dict(
            model_bytes=pf.dist_solve_comm_bytes(
                fin["dshape"], fin["mg"], r["comm_final"],
                tcaps=fin["tcaps"], fused=fin["fused"]),
            lost_at=None, iters=r["iters"], relres=r["relres"],
            converged=r["converged"], status=r["status"],
            history=list(r["history"]), true=list(r["true_history"]),
            u=r["u"].cpu(), p_final=r["p_final"],
            comm_final=r["comm_final"], restarts=r["restarts"],
            summary=rep.summary(), seconds=t,
            events=[dict(kind=e.kind, segment=e.segment, p_from=e.p_from,
                         p_to=e.p_to, iters_lost=e.iters_lost,
                         recover_s=e.recover_s) for e in rep.events],
            flags=list(rep.straggler_flags), seg_wall_s=rep.seg_wall_s,
            ckpt_save_s=rep.ckpt_save_s,
            ckpt_overhead_pct=rep.checkpoint_overhead_pct(),
            segments=r["segments"], remesh_s=r["remesh_s"],
            restore_s=r["restore_s"])

    comm.barrier()
    sync()
    ops.reset_launch_counts()

    # the reference's tripwire on [dsolve]'s final state (tol 1e-8)
    parts = pf.make_dist_solve_segment(
        grid, comm, tol=SOLVE_ARGS["tol"], steps=CHAOS_EVERY,
        maxiter=CHAOS_MAXITER, dist_source=(dshape, ddata), device=dev)
    b = torch.ones((n * n // comm.p,), dtype=torch.float32, device=dev) * \
        grid["h"] ** 2
    rows = n // comm.p
    x = dsolve_u[rank * rows:(rank + 1) * rows].reshape(-1).to(dev)
    bn = float(pf._norm(b, comm=comm))
    st = PCGState(k=torch.zeros((), dtype=torch.int32, device=dev), x=x,
                  r=b, p=b, rz=b.new_zeros(()),
                  res=b.new_tensor(dsolve_relres * bn))
    true_t, rec_t = parts["residual"](b, st)
    out["tripwire_probe"] = dict(true=float(true_t), rec=float(rec_t))
    del parts, st, x

    runs = dict(
        clean=dict(chaos=None, monitor=None),
        faulted=dict(chaos=ChaosPlan(**{k: dict(v) if isinstance(v, dict)
                                        else set(v)
                                        for k, v in CHAOS_PLAN.items()}),
                     monitor=StragglerMonitor(**CHAOS_STRAGGLER)))
    for name, kw in runs.items():
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        comm.barrier()
        sync()
        t0 = time.perf_counter()
        r = pf.solve_elastic_local(
            grid, comm, (dshape, ddata), tol=CHAOS_TOL,
            maxiter=CHAOS_MAXITER, mode=DSOLVE_MODE,
            ckpt_dir=f"{ckpt_root}/{name}", ckpt_every=CHAOS_EVERY,
            device=dev, backend="cuda", **kw)
        sync()
        out[name] = summary(r, time.perf_counter() - t0)
        out[name]["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated() if on_card else 0
        del r
        comm.barrier()
    del ddata

    # the cut pieces at n = 64, over the whole world again
    grid, dshape, ddata = payload["cut"]
    n = grid["n"]
    comm.barrier()
    t0 = time.perf_counter()
    r = pf.solve_elastic_local(
        grid, comm, (dshape, ddata), tol=CHAOS_CUT_TOL,
        maxiter=SOLVE_ARGS["maxiter"], mode=DSOLVE_MODE,
        ckpt_dir=f"{ckpt_root}/cut_clean", ckpt_every=CHAOS_EVERY,
        device=dev, backend="cuda")
    sync()
    out["cut_clean"] = summary(r, time.perf_counter() - t0)
    del r
    dsn, mg, stacked = pf.build_dist_problem(grid, comm.p, device=dev,
                                             dist_source=(dshape, ddata))
    mono = pf.make_dist_solve_local(
        dsn, mg, pf.local_args(dsn, mg, stacked, comm.rank), comm, n,
        grid["h"], mode=DSOLVE_MODE, tol=CHAOS_CUT_TOL,
        maxiter=SOLVE_ARGS["maxiter"],
        stag_window=SOLVE_ARGS["stag_window"], backend="cuda")
    b = torch.ones((n * n // comm.p,), dtype=torch.float32, device=dev) * \
        grid["h"] ** 2
    res = mono["fn"](b)
    out["cut_monolithic"] = dict(iters=int(res.iters), u=res.x.cpu(),
                                 status=int(res.status))
    del mono, res, stacked, mg
    GUARD_COUNTERS.clear()
    comm.barrier()
    t0 = time.perf_counter()
    r = pf.solve_elastic_local(
        grid, comm, (dshape, ddata), tol=CHAOS_CUT_TOL,
        maxiter=SOLVE_ARGS["maxiter"], mode="halo-plan-bf16",
        ckpt_dir=f"{ckpt_root}/cut_bf16", ckpt_every=CHAOS_CUT_EVERY,
        chaos=ChaosPlan(nan_at={1}), device=dev, backend="cuda")
    sync()
    out["cut_bf16"] = summary(r, time.perf_counter() - t0)
    out["cut_bf16"]["fp32_comm"] = GUARD_COUNTERS["elastic/fp32-comm"]
    del r, ddata
    sync()
    out["launches"] = ops.launch_counts()
    comm.barrier()
    return out


def _grid_payload(prob, dist_source) -> tuple:
    """What a chaos rank gets of a problem: its grid arrays (no K) and K's
    stacked partition ``(dshape, ddata)``."""
    grid = {k: prob[k] for k in ("kappa", "d_diag", "perm", "unperm",
                                 "gamma", "h", "n")}
    return (grid, *dist_source)


def chaos_phase(torch, keep: dict, device: str = "cuda",
                cut_n: int = CHAOS_CUT_N) -> dict:
    """The elastic distributed §6.4 solve over ``DIST_P`` gloo ranks on
    the one card (``apps.fractional.solve_elastic_local``): the n = 512
    problem of ``[solve]`` partitioned in the parent and handed to every
    rank whole (CUDA IPC), fault-free and under ``CHAOS_PLAN`` (a loss to
    2 ranks at segment 3, a NaN at segment 6, a straggler at segment 8),
    then the n = 64 cut pieces.  Holds the fault-free run to
    ``[dsolve]``'s recurrence, the faulted run to the reference's drill
    outcomes, the bytes after the remesh to ``dist_solve_comm_bytes``.
    ``device="cpu"`` rehearses it without a card (``cut_n`` smaller; the
    launch checks fail there)."""
    import tempfile
    from repro_torch.apps import fractional as pf
    from repro_torch.core.dist import partition_h2

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    prob, hist = keep["prob"], keep["dsolve_history"]
    n = prob["n"]
    plateau_floor = 10 * CHAOS_TOL + 1e-5
    t0 = time.perf_counter()
    cut = pf.FractionalProblem(cut_n, beta=SOLVE_ARGS["beta"],
                               h2_tol=SOLVE_ARGS["h2_tol"],
                               device=device).build()
    payload = {"main": _grid_payload(prob, keep.pop("dsolve_dist")),
               "cut": _grid_payload(cut, partition_h2(
                   cut["shape"], cut["data"], DIST_P, device=device))}
    del cut
    t_build = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as ckpt_root:
        t0 = time.perf_counter()
        ranks = run_ranks(torch, _chaos_rank_work,
                          (ckpt_root, keep["dsolve_u"],
                           keep["dsolve_relres"]),
                          [payload] * DIST_P, device)
        t_ranks = time.perf_counter() - t0
    del payload
    if on_card:
        torch.cuda.ipc_collect()

    r0 = ranks[0]
    probe = r0["tripwire_probe"]
    fires = probe["true"] > 10 * probe["rec"] + 1e-5
    log(f"[chaos] the reference's tripwire on [dsolve]'s final state "
        f"(tol {SOLVE_ARGS['tol']:g}): recomputed relres {probe['true']:.3e}"
        f" (float32 plateau), recurrence {probe['rec']:.3e}: fires "
        f"{fires}; at tol {CHAOS_TOL:g} its floor 10 tol + 1e-5 = "
        f"{plateau_floor:.3e} (margin required {CHAOS_MARGIN:g})")
    require(probe["true"] <= CHAOS_MARGIN * plateau_floor,
            f"the float32 plateau {probe['true']:.3e} leaves no margin "
            f"under the tripwire's floor {plateau_floor:.3e} at tol "
            f"{CHAOS_TOL:g}")

    clean = r0["clean"]
    want = to_reach(hist, CHAOS_TOL)
    seg_hist = torch.tensor(clean["history"], dtype=hist.dtype)
    ks = [s["k"] for s in clean["segments"]]
    log(f"[chaos] fault-free n={n}, p={DIST_P}, tol {CHAOS_TOL:g}, "
        f"ckpt_every {CHAOS_EVERY}: {clean['iters']} iterations "
        f"([dsolve] reaches {CHAOS_TOL:g} at {want}), status "
        f"{clean['status']}, {len(ks)} segments in {clean['seconds']:.2f} s"
        f"; checkpoint save per segment (rank 0) "
        f"{[round(v * 1e3, 2) for v in clean['ckpt_save_s']]} ms, "
        f"checkpoint_overhead_pct {clean['ckpt_overhead_pct']:.3f}; "
        f"true relres per segment "
        f"{[f'{v:.2e}' for v in clean['true']]}; max_memory_allocated "
        f"{clean['max_memory_allocated']}")
    for r, res in enumerate(ranks):
        c = res["clean"]
        require(c["iters"] == clean["iters"] and
                c["history"] == clean["history"] and c["status"] == 0,
                f"rank {r} fault-free run disagrees with rank 0")
    require(clean["converged"] and clean["restarts"] == 0 and
            clean["iters"] == want,
            f"fault-free elastic run took {clean['iters']} iterations, "
            f"[dsolve] reached {CHAOS_TOL:g} at {want}")
    require(torch.equal(seg_hist, hist[ks]),
            "the fault-free segment-end recurrence residuals differ from "
            "[dsolve]'s history at the same iterations")

    f0 = r0["faulted"]
    survivors = [res["faulted"] for res in ranks
                 if res["faulted"]["lost_at"] is None]
    lost = [res["faulted"]["lost_at"] for res in ranks]
    ev = {e["kind"]: e for e in f0["events"]}
    u_clean = torch.cat([res["clean"]["u"] for res in ranks]).reshape(n, n)
    u_fault = torch.cat([s["u"] for s in survivors]).reshape(n, n)
    u_rel = ((u_fault.double() - u_clean.double()).norm() /
             u_clean.double().norm()).item()
    after = [s for s in f0["segments"] if s["p"] == 2]
    # a segment: CHAOS_EVERY iterations (masked ones move their bytes
    # too) and the segment's one psum of ||b||
    model2 = f0["model_bytes"]
    seg_model2 = CHAOS_EVERY * model2 + (2 - 1) * 4
    log(f"[chaos] faulted n={n} ({CHAOS_PLAN}): converged "
        f"{f0['converged']}, status {f0['status']}, {f0['iters']} iterations"
        f" (fault-free {clean['iters']}), restarts {f0['restarts']}, p_final "
        f"{f0['p_final']}; lost at {lost}; events "
        + "; ".join(f"{e['kind']}@{e['segment']} p {e['p_from']}->"
                    f"{e['p_to']} lost {e['iters_lost']} recover "
                    f"{e['recover_s']:.3f} s" for e in f0["events"])
        + f"; straggler flags {f0['flags']}; repartition+rebuild "
        f"{[round(v, 3) for v in f0['remesh_s']]} s, restore "
        f"{[round(v, 3) for v in f0['restore_s']]} s; u vs fault-free "
        f"{u_rel:.3e}; {f0['seconds']:.2f} s; max_memory_allocated "
        f"{max(res['faulted'].get('max_memory_allocated', 0) for res in ranks)}")
    log(f"[chaos] after the remesh, per segment at p = 2: received bytes "
        f"{[s['recv_bytes'] for s in after]} (model {CHAOS_EVERY} x "
        f"{model2} + the ||b|| psum = {seg_model2}), halo_pack launches "
        f"{[s['launches']['halo_pack'] for s in after]}")
    require(f0["converged"] and f0["status"] == 0 and
            f0["restarts"] == 2 and f0["p_final"] == 2,
            f"faulted run: converged {f0['converged']}, status "
            f"{f0['status']}, restarts {f0['restarts']}, p_final "
            f"{f0['p_final']}")
    require(lost == [None, None, 3, 3], f"ranks lost at {lost}")
    kinds = [e["kind"] for e in f0["events"]]
    require(kinds.count("device-loss") == 1 and
            kinds.count("corruption") == 1 and
            set(kinds) <= {"device-loss", "corruption", "straggler"} and
            all(e["iters_lost"] == 0 for e in f0["events"]
                if e["kind"] == "straggler") and
            ev["device-loss"]["p_from"] == 4 and
            ev["device-loss"]["p_to"] == 2 and
            ev["device-loss"]["iters_lost"] == 0 and
            ev["corruption"]["iters_lost"] == CHAOS_EVERY and
            8 in f0["flags"],
            f"faulted run events {f0['events']}")
    require(abs(f0["iters"] - clean["iters"]) <= CHAOS_ITER_SLACK,
            f"faulted run {f0['iters']} iterations, fault-free "
            f"{clean['iters']}")
    require(bool(torch.isfinite(u_fault).all()) and u_rel <= CHAOS_U_TOL,
            f"faulted u vs fault-free {u_rel:.3e}")
    require(bool(after) and all(s["recv_bytes"] == seg_model2
                                for s in after),
            f"p = 2 segment bytes {[s['recv_bytes'] for s in after]}, model "
            f"{seg_model2}")
    require(all(s["launches"]["halo_pack"] > 0 for s in after),
            "halo_pack was not launched after the remesh")

    cc, mono = r0["cut_clean"], r0["cut_monolithic"]
    u_cc = torch.cat([res["cut_clean"]["u"] for res in ranks])
    u_mono = torch.cat([res["cut_monolithic"]["u"] for res in ranks])
    bf = r0["cut_bf16"]
    log(f"[chaos] cut n={cut_n}, tol {CHAOS_CUT_TOL:g}: elastic "
        f"{cc['iters']} iterations (restarts {cc['restarts']}, status "
        f"{cc['status']}, {cc['seconds']:.2f} s), monolithic "
        f"{mono['iters']} (status {mono['status']}); u bitwise equal "
        f"{torch.equal(u_cc, u_mono.reshape(u_cc.shape))}; true relres per "
        f"segment {[f'{v:.2e}' for v in cc['true']]}")
    log(f"[chaos] bf16 escalation drill n={cut_n} (halo-plan-bf16, NaN at "
        f"segment 1, ckpt_every {CHAOS_CUT_EVERY}): converged "
        f"{bf['converged']}, status {bf['status']}, {bf['iters']} "
        f"iterations, restarts {bf['restarts']}, comm_final "
        f"{bf['comm_final']}, elastic/fp32-comm {bf['fp32_comm']}, "
        f"{bf['seconds']:.2f} s")
    require(cc["converged"] and cc["restarts"] == 0 and
            cc["iters"] == mono["iters"] and
            torch.equal(u_cc, u_mono.reshape(u_cc.shape)),
            f"cut elastic {cc['iters']} iterations vs monolithic "
            f"{mono['iters']}")
    require(bf["converged"] and bf["status"] == 0 and
            bf["comm_final"] == DSOLVE_MODE and bf["restarts"] == 1 and
            all(res["cut_bf16"]["fp32_comm"] == 1 for res in ranks),
            f"bf16 drill: {bf['comm_final']}, counter {bf['fp32_comm']}")

    launches = {k: sum(res["launches"][k] for res in ranks)
                for k in r0["launches"]}
    log(f"[chaos] launches over the chaos path (all ranks): {launches}")
    require(launches["halo_pack"] > 0, "halo_pack was not launched on the "
            "chaos path")
    t_phase = time.perf_counter() - t_phase
    log(f"[chaos] phase took {t_phase:.1f} s (partitions and the n = "
        f"{cut_n} build {t_build:.1f} s, ranks {t_ranks:.1f} s)")
    return dict(
        tripwire_probe=dict(probe, fires=fires, floor=plateau_floor),
        clean=dict(iters=clean["iters"], want=want,
                   seconds=clean["seconds"],
                   ckpt_save_s=clean["ckpt_save_s"],
                   ckpt_overhead_pct=clean["ckpt_overhead_pct"]),
        faulted=dict(iters=f0["iters"], restarts=f0["restarts"],
                     p_final=f0["p_final"], events=f0["events"],
                     flags=f0["flags"], remesh_s=f0["remesh_s"],
                     restore_s=f0["restore_s"], u_rel=u_rel,
                     seconds=f0["seconds"],
                     p2_segment_bytes=[s["recv_bytes"] for s in after],
                     p2_model=seg_model2),
        cut=dict(iters=cc["iters"], monolithic_iters=mono["iters"],
                 bf16_iters=bf["iters"], bf16_comm_final=bf["comm_final"]),
        launches=launches, phase_s=t_phase)


# ---------------------------------------------------------------------------
# sketch phase: the on-device sketch construction (repro_torch.sketch)
# ---------------------------------------------------------------------------

SKETCH_N = 512                 # K of the §6.4 problem, N = 262,144, uncut
SKETCH_OPTS = dict(tol=1e-4, max_rank=64, oversample=10, seed=0, chunk=256,
                   backend="cuda")
SKETCH_ROWS_TOL = 1e-3         # the reference's acceptance at tol 1e-4
SKETCH_ORTH_TOL = 1e-4
SKETCH_PLAIN_TOL = 1e-3        # torch-backend bases' operator vs kernels'
SKETCH_SOLVE_N = 128           # n = 512 waits on a fused sampler (ROADMAP)
SKETCH_SOLVE_ARGS = dict(beta=0.75, h2_tol=1e-6, tol=1e-8, maxiter=500,
                         stag_window=60)
BB_SIDE = 128                  # B: the paper's 2D set at N = 16,384
BB_TOL = 5e-3                  # the reference's A = B B threshold
SHAPE_TOL = 1e-4               # a QR/SVD kernel vs its plain version


def sketch_shape_checks(torch, timer, seen: dict, inputs: dict) -> list:
    """Each distinct QR / SVD launch of the sketch construction, on the
    input it had there: the kernel on its planned route against the plain
    version (QR: R^T R, Q R against A and Q^T Q; SVD: sigma and
    U S U^T = (A A^T)^(1/2), both free of the factors' signs; each
    relative to the largest entry of the batch, the scale the rank picks
    read), then the kernel's ms on its route, on the general kernel
    (where its shared memory fits), the bound and ``torch.linalg``'s ms
    (one call).  The SVD's plain version runs in float64: in float32
    cuSOLVER's sigma is itself up to 4e-5 off on these inputs (logged),
    more than the kernel's."""
    from repro_torch.kernels import batched_qr as kbq
    from repro_torch.kernels import batched_svd as kbs
    from repro_torch.kernels import ref

    def rel(got, want):
        return ((got.double() - want.double()).abs().max() /
                want.double().abs().max().clamp_min(1e-30)).item()

    rows = []
    for key, count in sorted(seen.items(),
                             key=lambda kv: (kv[0][0], kv[0][1])):
        entry, shp, _ = key
        a = inputs[key]
        nb, n, k = shp
        kn = min(n, k)
        f32 = None
        if entry in ("qr", "qr_r"):
            want_q = entry == "qr"
            route = kbq.qr_plan(n, k, want_q, nb=nb)
            fits_general = True
            if want_q:
                q, r = kbq.batched_qr(a, route=route)
                qp, rp = ref.batched_qr(a)
                err = max(rel(r.transpose(-1, -2) @ r,
                              rp.transpose(-1, -2) @ rp),
                          rel(q @ r, a),
                          rel(q.transpose(-1, -2) @ q,
                              torch.eye(kn, device=a.device).expand(
                                  nb, kn, kn)))
                run = lambda rt: kbq.batched_qr(a, route=rt)
                lib = lambda: torch.linalg.qr(a)
            else:
                r = kbq.batched_qr_r(a, route=route)
                rp = ref.batched_qr(a)[1]
                err = rel(r.transpose(-1, -2) @ r, rp.transpose(-1, -2) @ rp)
                run = lambda rt: kbq.batched_qr_r(a, route=rt)
                lib = lambda: torch.linalg.qr(a, mode="r")
            nbytes = 4 * nb * (n * k + (n * kn if want_q else 0) + kn * k)
            flops = qr_flops(nb, n, k, want_q)
        else:
            polish = entry != "svals"
            route = kbs.svd_plan(n, k, want_vt=False)
            fits_general = kbs.general_bytes(n, k) <= kbs.SMEM_LIMIT
            u, sv, _ = kbs.batched_svd(a, route=route, want_vt=False,
                                       polish=polish)
            up, sp, _ = ref.batched_svd(a.double())
            err = rel(sv, sp)
            if polish:
                err = max(err, rel(u * sv[:, None, :] @ u.transpose(-1, -2),
                                   up * sp[:, None, :] @
                                   up.transpose(-1, -2)))
            run = lambda rt: kbs.batched_svd(a, route=rt, want_vt=False,
                                             polish=polish)
            lib = lambda: torch.linalg.svdvals(a) if not polish else \
                torch.linalg.svd(a, full_matrices=False)
            nbytes = 4 * nb * (n * k + (n * kn if polish else 0) + kn)
            flops = svd_flops(nb, n, k, want_vt=False)
        bnd, by = bound_ms(nbytes, flops)
        ms = timer.ms(lambda: run(route), reps=3)
        gms = timer.ms(lambda: run("general"), reps=2) \
            if route != "general" and fits_general else \
            (ms if route == "general" else None)
        lms, got = timer.once(lib)
        if entry not in ("qr", "qr_r"):
            # cuSOLVER's float32 sigma: the library call just timed
            # (torch.linalg.svd, the plain version, or svdvals)
            f32 = rel(got[1] if polish else got, sp)
        row = dict(entry=entry, shape=list(shp), launches=count, route=route,
                   rel_err=err, f32_plain_sigma_err=f32, ms=ms,
                   general_ms=gms,
                   bound_ms=bnd, bound_by=by, library_ms=lms)
        rows.append(row)
        gtxt = f"{gms:.4f}" if gms is not None else "does not fit"
        ftxt = f" (float64; float32 torch.linalg sigma off by {f32:.2e})" \
            if f32 is not None else ""
        log(f"[kernel] sketch shape {entry} {list(shp)}: launches {count}, "
            f"route {route}, vs plain {err:.3e}{ftxt} (tol {SHAPE_TOL:g}), "
            f"ms={ms:.4f} general ms={gtxt} bound_ms={bnd:.4f} ({by}) "
            f"torch.linalg ms={lms:.1f}")
        require(err <= SHAPE_TOL, f"sketch shape {entry} {list(shp)} on "
                f"route {route}: {err:.3e} from the plain version")
    log("[kernel] sketch QR+SVD kernel time per construction, sum of "
        f"launches x ms: {sum(r['launches'] * r['ms'] for r in rows):.2f} "
        "ms")
    return rows


def sketch_phase(torch, timer, keep, device: str = "cuda",
                 n: int = SKETCH_N, solve_n: int = SKETCH_SOLVE_N,
                 bb_side: int = BB_SIDE) -> dict:
    """The sketch path, its launches counted from reset to end: K of the
    §6.4 problem at ``n`` by ``construct_h2(method="sketch")`` (split by
    phase, QR/SVD launches per route and shape), its HGEMV against exact
    float64 rows and its bases' orthogonality; ``solve(solve_n,
    construction="sketch")`` with CUDA graphs; the black box
    ``construct_from_matvec`` of A = B B with B the paper's 2D set at
    N = ``bb_side``^2.  Then, outside the count: each QR/SVD shape of the
    construction against its plain version and timed, the same sketches'
    bases on the plain backend (ranks within 1 per level, operator within
    1e-3), the card's Gaussians against the CPU's (bitwise), the distance
    to the ``[solve]`` phase's cheb-built K (``keep``), the cheb-built
    ``solve(solve_n)``.  ``device="cpu"`` rehearses it without a card (no
    kernel runs: the launch checks fail and nothing is timed there)."""
    from repro_torch.apps import fractional as pf
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import (exponential_kernel,
                                             fractional_kernel_2d)
    from repro_torch.core.matvec import h2_matvec
    from repro_torch.core.reconstruct import check_orthogonal
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import phase_times
    from repro_torch.sketch import construct as scon
    from repro_torch.sketch import rangefinder, rng
    from repro_torch.sketch.blackbox import construct_from_matvec
    from repro_torch.sketch.sample import project_coupling_blocks

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    opts = dict(SKETCH_OPTS, backend="cuda")
    pts = pf.interior_grid(n)
    kern = fractional_kernel_2d(0.75)

    # ---- 1. K at n by sketch ----
    captured, budgets = {}, []
    real_nb, real_draw = scon.build_nested_bases, rng.level_gaussians

    def capture(sketches, *a, **kw):      # kept for the plain-backend check
        captured["sketches"] = sketches
        return real_nb(sketches, *a, **kw)

    def draw(seed, level, n_nodes, rows, cols, *a, **kw):
        if not budgets or budgets[-1] != cols:
            budgets.append(cols)
        return real_draw(seed, level, n_nodes, rows, cols, *a, **kw)

    def build():
        return construct_h2(pts, kern, leaf_size=64, cheb_p=6, eta=0.9,
                            method="sketch", sketch_opts=opts, device=device)

    ops.reset_launch_counts()
    start = tally_start()
    scon.build_nested_bases, rng.level_gaussians = capture, draw
    try:
        with phase_times(sync) as split:
            sync()
            t0 = time.perf_counter()
            seen, inputs, (shape, data, tree, bs) = record_qr_svd(
                torch, build, keep_inputs=True) if on_card else \
                ({}, {}, build())
            sync()
            t_build = time.perf_counter() - t0
    finally:
        scon.build_nested_bases, rng.level_gaussians = real_nb, real_draw
    split = dict(split)
    build_routes = {k: dict(v) for k, v in ops.route_launch_counts().items()
                    if k in ("batched_qr", "batched_svd")}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"[sketch] construct_h2(method='sketch') n={n} N={shape.n} depth "
        f"{shape.depth}: {t_build:.3f} s (synchronised at each phase), "
        f"ranks {shape.ranks}, budgets drawn {budgets} (samples used "
        f"{budgets[-1]}), operator {data.nbytes() / 1e9:.3f} GB, peak "
        f"memory {peak / 1e9:.2f} GB")
    log("[sketch] construction by phase (ms, synchronised): " +
        ", ".join(f"{k}={v:.1f}" for k, v in split.items()
                  if k.startswith("sketch/")))
    log(f"[sketch] construction QR/SVD launches by route: {build_routes}; "
        f"distinct shapes {len(seen)}")

    gen = torch.Generator().manual_seed(11)
    x = torch.randn(shape.n, 1, generator=gen).to(device)
    y = h2_matvec(shape, data, x, backend="cuda")
    rows = torch.randperm(shape.n, generator=torch.Generator().manual_seed(2)
                          )[:512].to(device)
    exact = kernel_rows(torch, pts, kern, tree.perm, rows, x)
    rel_rows = ((y[rows].double() - exact).norm() / exact.norm()).item()
    orth = check_orthogonal(shape, data)
    log(f"[sketch] h2_matvec of the sketch-built K vs 512 exact rows "
        f"(float64): rel err {rel_rows:.3e} (tol {SKETCH_ROWS_TOL:g}); "
        f"check_orthogonal {orth:.3e} (tol {SKETCH_ORTH_TOL:g})")
    require(bool(torch.isfinite(y).all()) and y.shape == (shape.n, 1),
            "sketch HGEMV not finite or of the wrong shape")
    require(rel_rows <= SKETCH_ROWS_TOL,
            f"sketch-built K vs exact rows {rel_rows:.3e}")
    require(orth < SKETCH_ORTH_TOL, f"sketch bases not orthonormal {orth:.3e}")

    # ---- 2. the §6.4 solve on sketch-built operators ----
    sync()
    t0 = time.perf_counter()
    res = pf.solve(solve_n, construction="sketch", device=device,
                   backend="cuda", **SKETCH_SOLVE_ARGS)
    sync()
    t_solve = time.perf_counter() - t0
    sprob = res["prob"]
    log(f"[sketch] solve({solve_n}, construction='sketch'): "
        f"{res['iters']} iterations, status {res['status']}, relres "
        f"{res['relres']:.3e}, {t_solve:.2f} s (build " +
        ", ".join(f"{k} {v:.2f} s" for k, v in res["timings"].items()) +
        f"); K ranks {sprob['shape'].ranks}")
    require(res["status"] == 0, f"sketch solve status {res['status']}")

    # ---- 3. black box: A = B B from its matvec alone ----
    bpts = regular_grid_points(bb_side, 2)
    bshape, bdata, _, _ = construct_h2(bpts, exponential_kernel(0.1),
                                       leaf_size=64, cheb_p=6, eta=0.9,
                                       device=device)
    calls = []

    def bb(v):
        calls.append(v.shape[-1])
        return h2_matvec(bshape, bdata, h2_matvec(bshape, bdata, v))

    cm0 = dict(ops.route_launch_counts()["coupling_mv"])
    sync()
    t0 = time.perf_counter()
    ashape, adata, _, _ = construct_from_matvec(
        bb, bpts, 64, 0.9, tol=1e-4, max_rank=64, device=device)
    sync()
    t_bb = time.perf_counter() - t0
    cm_bb = {r: v - cm0[r] for r, v in
             ops.route_launch_counts()["coupling_mv"].items()}
    xb = torch.randn(bshape.n, 2, generator=gen).to(device)
    want = bb(xb)
    rel_bb = ((h2_matvec(ashape, adata, xb) - want).norm() /
              want.norm()).item()
    log(f"[sketch] construct_from_matvec(B B), N={bshape.n}: {t_bb:.2f} s, "
        f"{len(calls) - 1} matvec calls = {2 * (len(calls) - 1)} HGEMVs of "
        f"B over {sum(calls[:-1])} probe columns (widest {max(calls[:-1])});"
        f" coupling_mv by route {cm_bb}; ranks {ashape.ranks}; A x vs "
        f"B (B x): {rel_bb:.3e} (tol {BB_TOL:g})")
    require(rel_bb <= BB_TOL, f"black-box A = B B off by {rel_bb:.3e}")

    # the sketch path ends here
    launches, routes, _ = launches_that_ran(start)
    log(f"[sketch] launches on the sketch path: {launches}; by route "
        f"{routes}")

    # ---- outside the count: comparisons ----
    shape_rows = sketch_shape_checks(torch, timer, seen, inputs) \
        if on_card else []
    del inputs
    u_p, e_p, ranks_p = rangefinder.build_nested_bases(
        captured.pop("sketches"), 64, opts["tol"], opts["max_rank"],
        backend="torch")
    u_exp = rangefinder.explicit_bases(u_p, e_p)
    ppts = torch.as_tensor(tree.points, device=device).float()
    s_p = [project_coupling_blocks(
        ppts.reshape(1 << l, shape.n >> l, -1), data.s_rows[l],
        data.s_cols[l], u_exp[l], u_exp[l], kernel=kern,
        chunk=opts["chunk"]) if shape.coupling_counts[l] else
        ppts.new_zeros((0, ranks_p[l], ranks_p[l]))
        for l in range(shape.depth + 1)]
    del u_exp
    pshape, pdata = scon._assemble(tree, bs, u_p, e_p, ranks_p, s_p,
                                   data.dense, plan=data.plan)
    y_p = h2_matvec(pshape, pdata, x, backend="torch")
    rel_p = ((y_p - y).norm() / y.norm()).item()
    rank_gap = max(abs(a - b) for a, b in zip(ranks_p, shape.ranks))
    log(f"[sketch] the same sketches' bases on the plain backend: ranks "
        f"{ranks_p} (largest gap {rank_gap}, tol 1); operator vs the "
        f"kernels' {rel_p:.3e} (tol {SKETCH_PLAIN_TOL:g})")
    require(rank_gap <= 1, f"plain-backend ranks {ranks_p} vs "
            f"{shape.ranks}")
    require(rel_p <= SKETCH_PLAIN_TOL,
            f"plain-backend sketch operator off by {rel_p:.3e}")
    del pdata, s_p

    lv, nn, w = 3, 8, shape.n >> 3
    g_dev = rng.level_gaussians(0, lv, nn, w, opts["max_rank"] +
                                opts["oversample"], device=device)
    g_cpu = rng.level_gaussians(0, lv, nn, w, opts["max_rank"] +
                                opts["oversample"])
    same = torch.equal(g_dev.cpu(), g_cpu)
    log(f"[sketch] level_gaussians level {lv} {list(g_cpu.shape)}: card "
        f"vs CPU {'bitwise equal' if same else 'DIFFER'}")
    require(same, "the card's Gaussians differ from the CPU's")
    del g_dev, g_cpu

    dist_cheb = rows_cheb = None
    kp = keep["prob"] if keep is not None else None
    if kp is not None and kp["shape"].n == shape.n and \
            kp["shape"].leaf_size == shape.leaf_size:
        yc = h2_matvec(kp["shape"], kp["data"], x, backend="cuda")
        dist_cheb = ((y - yc).norm() / yc.norm()).item()
        rows_cheb = ((yc[rows].double() - exact).norm() /
                     exact.norm()).item()
        log(f"[sketch] sketch-built K vs the [solve] phase's cheb-built K "
            f"(compressed at h2_tol 1e-6), one random vector: "
            f"{dist_cheb:.3e}; the cheb-built K vs the same 512 exact rows:"
            f" {rows_cheb:.3e} (the sketch-built: {rel_rows:.3e})")
    cheb = pf.solve(solve_n, device=device, backend="cuda",
                    **SKETCH_SOLVE_ARGS)
    log(f"[sketch] cheb-built solve({solve_n}): {cheb['iters']} iterations,"
        f" status {cheb['status']}; sketch-built {res['iters']}; u apart "
        f"{((res['u'] - cheb['u']).norm() / cheb['u'].norm()).item():.3e}")
    t_phase = time.perf_counter() - t_phase
    log(f"[sketch] phase took {t_phase:.1f} s (construction {t_build:.1f} s,"
        f" solve {t_solve:.1f} s, black box {t_bb:.1f} s)")
    return dict(
        n=n, build_s=t_build, split_ms={k: v for k, v in split.items()
                                        if k.startswith("sketch/")},
        ranks=shape.ranks, budgets=budgets, samples_used=budgets[-1],
        max_memory_allocated=peak, build_routes=build_routes,
        rows_rel=rel_rows, orthogonality=orth, plain_ranks=ranks_p,
        plain_rel=rel_p, gaussians_equal=same, vs_cheb_k=dist_cheb,
        cheb_k_rows_rel=rows_cheb,
        shapes=shape_rows,
        solve=dict(n=solve_n, iters=res["iters"], status=res["status"],
                   relres=res["relres"], s=t_solve,
                   build_s=dict(res["timings"]), cheb_iters=cheb["iters"],
                   k_ranks=sprob["shape"].ranks),
        blackbox=dict(n=bshape.n, s=t_bb, matvec_calls=len(calls) - 1,
                      probe_columns=sum(calls[:-1]),
                      widest=max(calls[:-1]), coupling_mv_routes=cm_bb,
                      ranks=ashape.ranks, rel=rel_bb),
        launches=launches, routes=routes, phase_s=t_phase)


# ---------------------------------------------------------------------------
# guard phase: validate, certify, the drills, the certified sketch and the
# guarded solve (repro_torch.guard, solve_with_guards)
# ---------------------------------------------------------------------------

GUARD_PROBES = 8
GUARD_OP_TOL = 5e-3            # compressed vs uncompressed (the main path's)
GUARD_SKETCH_TOL = 1e-3        # the sketch-built K against the kernel itself
GUARD_REF_CHUNK = 256          # rows per float64 strip of the kernel apply
STARVED_N = 128                # the rank-starved drill: N = 16,384
STARVED_TOL = 1e-2             # the reference's drill certificate
STARVED_ROUNDS = 4
GUARD_ITER_SLACK = 2           # the guarded primary rung vs [solve]


def _mem_reset(torch, on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def guard_operator_phase(torch, state: dict, device: str = "cuda") -> dict:
    """The guard path's first part, on the main path's operators at
    N = 2^20 (launches counted from reset to end): ``validate_h2`` of the
    uncompressed and the compressed operator, timed; the compressed HGEMV
    certified against the uncompressed one (``GUARD_PROBES`` probes,
    ``GUARD_OP_TOL``); and ``drill_corrupt_operator`` in ``"scale"`` and
    ``"nan"`` mode on shallow copies of the compressed operator with
    ``backend="cuda"`` (``s`` rewritten, ``s_mar`` left), each caught by
    ``validate_h2`` and failing its certificate against the healthy
    HGEMV; the healthy operator validated again after.  The probes are 8
    columns wide, so ``coupling_mv`` takes its ``general`` route here:
    the routes are logged, not required."""
    import dataclasses
    from repro_torch import guard as tg
    from repro_torch.core.matvec import h2_matvec

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    shape, data = state["shape"], state["data"]
    cshape, cdata = state["cshape"], state["cdata"]
    t_phase = time.perf_counter()
    _mem_reset(torch, on_card)
    start = tally_start()
    out: dict = {}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t0

    for what, s_, d_ in (("uncompressed", shape, data),
                         ("compressed", cshape, cdata)):
        rep, t = timed(lambda: tg.validate_h2(s_, d_))
        log(f"[guard] validate_h2 {what} N={s_.n}: {rep.summary()}; "
            f"orthogonality {rep.orthogonality:.3e}; {t:.3f} s")
        require(rep.ok, f"validate_h2 {what}: {rep.summary()}")
        out[what] = dict(validate_s=t, orthogonality=rep.orthogonality,
                         warnings=rep.warnings)

    def healthy(x):
        return h2_matvec(cshape, cdata, x, "cuda")

    cert, t = timed(lambda: tg.certify_matvec(
        healthy, lambda x: h2_matvec(shape, data, x, "cuda"), shape.n,
        probes=GUARD_PROBES, tol=GUARD_OP_TOL, device=device))
    log(f"[guard] certify_matvec compressed vs uncompressed HGEMV "
        f"({GUARD_PROBES} probes): rel_err {cert.rel_err:.3e} (tol "
        f"{GUARD_OP_TOL:g}), ok {cert.ok}; {t:.3f} s")
    require(cert.ok, f"compressed operator not certified: {cert.rel_err}")
    out["certify"] = dict(rel_err=cert.rel_err, s=t)
    drills = {}
    for mode, sign in (("scale", "incoherent"), ("nan", "non-finite")):
        bad = dataclasses.replace(cdata, s=list(cdata.s),
                                  s_mar=list(cdata.s_mar))
        desc = tg.drill_corrupt_operator(bad, mode=mode, backend="cuda")
        rep, t_val = timed(lambda: tg.validate_h2(cshape, bad))
        c, t_cert = timed(lambda: tg.certify_matvec(
            lambda x: h2_matvec(cshape, bad, x, "cuda"), healthy, shape.n,
            probes=GUARD_PROBES, tol=GUARD_OP_TOL, device=device))
        caught = any(sign in e for e in rep.errors)
        log(f"[guard] drill {mode} (backend=cuda): {desc}; validate_h2 "
            f"{'caught' if not rep.ok and caught else 'MISSED'} it "
            f"({rep.summary()}; {t_val:.3f} s); certificate vs the "
            f"healthy HGEMV rel_err {c.rel_err:.3e}, ok {c.ok} "
            f"({t_cert:.3f} s)")
        require(not rep.ok and caught, f"validate_h2 missed the {mode} "
                f"drill: {rep.summary()}")
        require(not c.ok, f"the {mode} drill certified: {c.rel_err}")
        drills[mode] = dict(desc=desc, errors=rep.errors[:4],
                            rel_err=c.rel_err, validate_s=t_val)
        del bad, rep
    rep = tg.validate_h2(cshape, cdata, check_orth=False)
    require(rep.ok, f"the healthy operator changed: {rep.summary()}")
    sync()
    launches, routes, _ = launches_that_ran(start)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    t_phase = time.perf_counter() - t_phase
    log(f"[guard] operator checks: coupling_mv by route "
        f"{routes.get('coupling_mv')} (nv = {GUARD_PROBES} probes: "
        f"warp16 needs nv % 16 == 0); max_memory_allocated {peak} bytes; "
        f"{t_phase:.1f} s")
    out.update(drills=drills, launches=launches, routes=routes,
               max_memory_allocated=peak, phase_s=t_phase)
    return out


def guard_phase(torch, solve_iters: int, device: str = "cuda",
                n: int = SKETCH_N, starved_n: int = STARVED_N,
                solve_n: int = SOLVE_N) -> dict:
    """The guard path's second part (launches counted from reset to end,
    graph replays included): ``construct_h2_certified`` of K of the §6.4
    problem at ``n`` with the ``[sketch]`` phase's options, certified at
    ``GUARD_SKETCH_TOL`` against ``kernel_reference_apply`` on the card;
    the rank-starved drill at ``starved_n`` (must need more than one round,
    then certify); ``solve_with_guards(solve_n)`` with the ``[solve]``
    phase's arguments (accepted on its primary rung, status 0, iterations
    within ``GUARD_ITER_SLACK`` of ``solve_iters``) and with the
    reference's defaults (every rung walked printed).
    ``device="cpu"`` rehearses it at small sizes (no kernel runs there)."""
    from repro_torch import guard as tg
    from repro_torch.apps import fractional as pf
    from repro_torch.core.kernels_fn import fractional_kernel_2d
    from repro_torch.obs.trace import phase_times
    from repro_torch.solvers import krylov

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    _mem_reset(torch, on_card)
    start = tally_start()
    tg.reset_guard_counters()
    kern = fractional_kernel_2d(0.75)
    out: dict = {}

    sync()
    t0 = time.perf_counter()
    with phase_times(sync) as pt:
        shape, data, _, _, cert, rounds = tg.construct_h2_certified(
            pf.interior_grid(n), kern, 64, 0.9, cert_tol=GUARD_SKETCH_TOL,
            probes=GUARD_PROBES, chunk=GUARD_REF_CHUNK,
            sketch_opts=SKETCH_OPTS, device=device)
    t_cert = time.perf_counter() - t0
    t_ref = pt.get("guard/certify", 0.0) / 1e3
    log(f"[guard] construct_h2_certified K n={n} (N={shape.n}, "
        f"{SKETCH_OPTS}): {rounds} round(s), ranks {shape.ranks}, "
        f"rel_err {cert.rel_err:.3e} against kernel_reference_apply "
        f"(float64 strips of {GUARD_REF_CHUNK} rows, {shape.n ** 2:.3e} "
        f"entries; tol {GUARD_SKETCH_TOL:g}), ok {cert.ok}; {t_cert:.2f} s "
        f"(certificate {t_ref:.2f} s, synchronised phases)")
    require(cert.ok, f"sketch-built K not certified: {cert.rel_err}")
    out["certified_sketch"] = dict(n=shape.n, rounds=rounds,
                                   ranks=shape.ranks, rel_err=cert.rel_err,
                                   s=t_cert, certificate_s=t_ref)
    del data

    sync()
    t0 = time.perf_counter()
    sshape, sdata, _, _, scert, srounds = tg.construct_h2_certified(
        pf.interior_grid(starved_n), kern, 64, 0.9, cert_tol=STARVED_TOL,
        probes=GUARD_PROBES, max_rounds=STARVED_ROUNDS,
        chunk=GUARD_REF_CHUNK, sketch_opts=tg.drill_rank_starved(),
        device=device)
    sync()
    t_starved = time.perf_counter() - t0
    counters = dict(tg.GUARD_COUNTERS)
    log(f"[guard] rank-starved drill n={starved_n} (N={sshape.n}, "
        f"{tg.drill_rank_starved()}): {srounds} round(s), ranks "
        f"{sshape.ranks}, rel_err {scert.rel_err:.3e} (tol {STARVED_TOL:g})"
        f", ok {scert.ok}; counters {counters}; {t_starved:.2f} s")
    require(scert.ok and srounds > 1,
            f"rank-starved drill: {srounds} rounds, ok {scert.ok}")
    out["rank_starved"] = dict(n=sshape.n, rounds=srounds,
                               ranks=sshape.ranks, rel_err=scert.rel_err,
                               s=t_starved, counters=counters)
    del sdata

    def ladder(what, **kw):
        captures0 = dict(krylov.TRACE_COUNTS)
        sync()
        t0 = time.perf_counter()
        g = pf.solve_with_guards(solve_n, device=device, **kw)
        sync()
        t = time.perf_counter() - t0
        captures = {k: v - captures0[k] for k, v in
                    krylov.TRACE_COUNTS.items() if v != captures0[k]}
        for name, r in g["rungs"].items():
            log(f"[guard] solve_with_guards({solve_n}) {what}: rung {name}: "
                + (f"status {r['status']}, {r['iters']} iterations, relres "
                   f"{r['relres']:.3e}, " if "iters" in r else "raised, ")
                + f"{r['seconds']:.3f} s (its graph capture included)")
        log(f"[guard] solve_with_guards({solve_n}) {what}: attempts "
            f"{g['attempts']}; accepted rung "
            f"{g['rung'] if g['guard_ok'] else 'none (ladder exhausted)'}; "
            f"status {g['status']}, {g['iters']} iterations, relres "
            f"{g['relres']:.3e}; graph captures {captures}; whole call "
            f"{t:.2f} s (build {sum(g['timings'].values()):.2f} s)")
        return dict(attempts=g["attempts"], rung=g["rung"],
                    guard_ok=g["guard_ok"], status=g["status"],
                    iters=g["iters"], relres=g["relres"], rungs=g["rungs"],
                    captures=captures, s=t), g

    out["solve"], g = ladder("with the [solve] phase's arguments",
                             **SOLVE_ARGS)
    require(g["guard_ok"] and g["rung"] == "primary" and
            g["status"] == 0 and
            abs(g["iters"] - solve_iters) <= GUARD_ITER_SLACK,
            f"guarded solve: rung {g['rung']}, status {g['status']}, "
            f"{g['iters']} iterations against {solve_iters}")
    del g
    out["solve_defaults"], g = ladder("with the reference's defaults")
    require(g["attempts"][0][0] == "primary" and
            all(name in g["rungs"] for name, _ in g["attempts"]),
            "the default ladder did not record its rungs")
    del g
    sync()
    launches, routes, _ = launches_that_ran(start)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    t_phase = time.perf_counter() - t_phase
    log(f"[guard] certified constructions and guarded solves: coupling_mv "
        f"by route {routes.get('coupling_mv')}; max_memory_allocated {peak}"
        f" bytes; {t_phase:.1f} s")
    out.update(launches=launches, routes=routes, max_memory_allocated=peak,
               phase_s=t_phase)
    return out


# ---------------------------------------------------------------------------
# serve phase: the solver service on the paper's 2D set (repro_torch.serving)
# ---------------------------------------------------------------------------

SERVE_COMPRESS_TOL = 1e-5      # key A: the example's key_comp
SERVE_LOOSE_TOL = 1e-4         # key A loosened: the degraded="loose" entry
# the requests' tolerance: at N = 2^20 float32 CG's recomputed residual
# stalls at 2-4e-4 while the recurrence goes on down (the calibration's
# unrestarted line), so the reference's 1e-6 is out of reach of the
# answers; at 1e-4 the 10 x tol recompute check holds with room
SERVE_TOL = 1e-4
SERVE_REQUESTS = 32
SERVE_SEED = 1
SERVE_PANEL = 16               # coupling_mv's warp16 route
# iterations per dispatch: restarting CG every 25 iterations (the
# reference's default) takes 3-5x the iterations of CG(100) here (the
# calibration's restart line), which stays within 1.5x of unrestarted CG
SERVE_RESTART = 100
SERVE_MAX_SEGMENTS = 30        # a request's budget: 3,000 iterations
SERVE_DRILL_COST = 0.02        # virtual seconds per dispatch in the drills
SERVE_DRILL_REQUESTS = 16      # the drills' depth, cut from 32 for the time limit
SERVE_DRILL_PLAN = dict(device_loss_at={1: "device lost"}, nan_at={3},
                        straggle_at={5: 0.5})
SERVE_RECOMPUTE_TOL = 10 * SERVE_TOL   # recomputed with the plain HGEMV
SERVE_THREADS = 4
SERVE_PER_THREAD = 8


def _serve_recompute(torch, shape, data, bs: dict, done: dict,
                     chunk: int = 32) -> dict:
    """``||b - (x + A x)|| / ||b||`` of every completion in ``done``
    (rid -> Completion with ``x``) against its ``bs[rid]``, the HGEMV on
    the plain backend, ``chunk`` columns at a time."""
    from repro_torch.core.matvec import h2_matvec
    rids = sorted(done)
    out = {}
    for i in range(0, len(rids), chunk):
        part = rids[i:i + chunk]
        x = torch.stack([done[r].x for r in part], dim=1)
        b = torch.stack([torch.as_tensor(bs[r]).to(x.device) for r in part],
                        dim=1)
        r = b - (x + h2_matvec(shape, data, x, backend="torch"))
        rel = (r.double().norm(dim=0) / b.double().norm(dim=0)).tolist()
        out.update(zip(part, rel))
    return out


def _panel_solve(torch, seg, b, tol: float, max_dispatches: int) -> tuple:
    """Dispatches of ``seg`` (a service's segment program) on the panel
    ``b`` from zero until every column converges: (iterations per
    column, dispatches, seconds, final x)."""
    x = torch.zeros_like(b)
    its = torch.zeros(b.shape[1], dtype=torch.long)
    t0 = time.perf_counter()
    for d in range(1, max_dispatches + 1):
        res = seg(b, x, tol)
        x, its = res.x, its + res.iters.long().cpu()
        if bool((res.relres <= tol).all()):
            break
    return its.tolist(), d, time.perf_counter() - t0, x


def serve_phase(torch, device: str = "cuda", log2n: int = 20,
                keep: dict = None) -> dict:
    """The solver service (``repro_torch.serving``) on the paper's 2D set
    at N = 2^log2n, serving ``(I + A) x = b`` (exponential kernel, l =
    0.1): key A (``construct_h2`` at the main path's settings plus
    ``compress(tol=1e-5)``) comes in by a cache miss (``operator``), and
    every serve after hits it; a calibration panel gives the iterations
    per request and the time per dispatch (beside restarts of 25 and no
    restart, and the first dispatch with the Krylov guards on); a
    benchmark on the wall clock at twice the panel's service rate; the
    fault drill twice on a virtual clock (reproducible); the degraded
    paths (per-column ``pcg`` on an open breaker, and ``degraded="loose"``
    on key A loosened); the threaded front-end (4 submitters x 8
    requests); every ``ok`` answer recomputed with the plain HGEMV; the
    span trace exported.  The Krylov guards are off after the first
    dispatch (see the log line).  ``keep`` (optional) receives key A's
    points and operator, which ``[dserve]`` partitions.  ``device="cpu"``
    rehearses it at a small ``log2n``."""
    import tempfile
    import threading

    import numpy as np
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.compression import compress
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    from repro_torch.core.matvec import h2_matvec
    from repro_torch.obs.export import write_span_trace
    from repro_torch.runtime.fault import CircuitBreaker, StragglerMonitor
    from repro_torch.serving import (OperatorCache, OperatorKey,
                                     PoissonLoad, QueueFull,
                                     ServiceFaultPlan, SolverService,
                                     ThreadedSolverService, geometry_digest)
    from repro_torch.solvers import block_cg, krylov

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    backend = "cuda" if on_card else "torch"
    side = 1 << (log2n // 2)
    pts = regular_grid_points(side, 2)
    n = side * side
    key = OperatorKey(geometry=geometry_digest(pts),
                      kernel=("exponential", 0.1), tol=SERVE_COMPRESS_TOL)
    built = {}

    def build():
        sync()
        t0 = time.perf_counter()
        shape, data, _, _ = construct_h2(pts, exponential_kernel(0.1),
                                         leaf_size=64, cheb_p=6, eta=0.9,
                                         device=device)
        sync()
        built["construct_s"] = time.perf_counter() - t0
        cshape, cdata = compress(shape, data, tol=SERVE_COMPRESS_TOL,
                                 backend=backend)
        sync()
        built["build_s"] = time.perf_counter() - t0
        built["ranks"] = (shape.ranks, cshape.ranks)
        return cshape, cdata, {}

    cache = OperatorCache(max_bytes=1 << 34)
    common = dict(panel_width=SERVE_PANEL, restart_every=SERVE_RESTART,
                  max_segments=SERVE_MAX_SEGMENTS, tol=SERVE_TOL,
                  device=device, backend=backend)

    def drill_service(plan=None, **kw):
        opts = dict(dispatch_cost=SERVE_DRILL_COST, detect_delay=0.005,
                    seed=0, straggler=StragglerMonitor(threshold=3.0,
                                                       warmup=2),
                    breaker=CircuitBreaker(failure_threshold=2,
                                           cooldown=0.1))
        opts.update(kw)
        return SolverService(cache, fault_plan=plan, **opts, **common)

    def load(rate, n_requests=SERVE_REQUESTS, seed=SERVE_SEED):
        return PoissonLoad(n=n, rate=rate, n_requests=n_requests,
                           tol=SERVE_TOL, seed=seed)

    _mem_reset(torch, on_card)
    start = tally_start()
    captures0 = krylov.TRACE_COUNTS["block_cg"]
    guards = krylov.guards_enabled()
    try:
        # 1. the cache miss, then the calibration panel
        svc = SolverService(cache, **common)
        entry = svc.operator(key, build)
        shape, data = entry.shape, entry.data
        log(f"[serve] key A built by a cache miss in {built['build_s']:.3f}"
            f" s (construct {built['construct_s']:.3f} s; ranks "
            f"{built['ranks'][0]} -> {built['ranks'][1]} at tol "
            f"{SERVE_COMPRESS_TOL:g}), {entry.nbytes} bytes")
        g = torch.Generator().manual_seed(SERVE_SEED)
        bp = torch.randn(n, SERVE_PANEL, generator=g).to(device)
        seg = svc._segment_fn(entry, SERVE_RESTART)
        first = seg(bp, torch.zeros_like(bp), SERVE_TOL)
        log(f"[serve] the first dispatch with the Krylov guards on: "
            f"column statuses {sorted(set(first.status.tolist()))} "
            f"(3 = stagnation: the restarted CG residual rises above its "
            f"start within the window, relres up to "
            f"{float(first.res_history.nan_to_num(0).max()):.2f}); the "
            f"rest of the phase runs with the guards off")
        krylov.set_guards_enabled(False)
        seg = svc._segment_fn(entry, SERVE_RESTART)
        seg(bp, torch.zeros_like(bp), SERVE_TOL)          # the capture
        iters, disp, t_cal, xc = _panel_solve(torch, seg, bp, SERVE_TOL,
                                              SERVE_MAX_SEGMENTS)
        s_dispatch = t_cal / disp
        ref = SolverService(cache, **dict(common, restart_every=25))
        seg25 = ref._segment_fn(entry, 25)
        seg25(bp, torch.zeros_like(bp), SERVE_TOL)        # the capture
        it25, d25, t25, _ = _panel_solve(
            torch, seg25, bp, SERVE_TOL,
            SERVE_RESTART * SERVE_MAX_SEGMENTS // 25)
        op = entry.solvers[("seg", SERVE_PANEL, SERVE_RESTART)]
        sync()
        t0 = time.perf_counter()
        full = block_cg(op, bp, tol=SERVE_TOL,
                        maxiter=SERVE_RESTART * SERVE_MAX_SEGMENTS)
        sync()
        t_full = time.perf_counter() - t0

        def true(x):
            r = bp - (x + h2_matvec(shape, data, x, backend="torch"))
            return (r.double().norm(dim=0) / bp.double().norm(dim=0)).max()

        mean_iters = statistics.mean(iters)
        service_rate = SERVE_PANEL / (mean_iters / SERVE_RESTART *
                                      s_dispatch)
        rate = 2.0 * service_rate
        log(f"[serve] calibration panel ({SERVE_PANEL} columns, tol "
            f"{SERVE_TOL:g}): restart {SERVE_RESTART}: iterations "
            f"{min(iters)}..{max(iters)} in {disp} dispatches, "
            f"{s_dispatch * 1e3:.2f} ms a dispatch, recomputed relres "
            f"{float(true(xc)):.3e}; restart 25 (the reference's default):"
            f" {min(it25)}..{max(it25)} in {d25} dispatches, {t25:.2f} s; "
            f"unrestarted: {min(full.iters.tolist())}.."
            f"{max(full.iters.tolist())} iterations, {t_full:.2f} s, "
            f"recomputed relres {float(true(full.x)):.3e}, recurrence "
            f"peak {float(full.res_history.nan_to_num(0).max()):.2f}; "
            f"service rate {service_rate:.3f} requests/s; load rate "
            f"{rate:.3f}/s")
        require(max(iters) < SERVE_RESTART * SERVE_MAX_SEGMENTS,
                f"the calibration panel did not converge within the "
                f"budget: {iters}")
        del xc, full

        # 2. benchmark: wall clock, a cache hit
        reqs = {r.rid: r.b for r in load(rate).requests()}
        t0 = time.perf_counter()
        bench = SolverService(cache, **common).serve(load(rate).requests(),
                                                     key, build)
        t_bench = time.perf_counter() - t0
        mb = bench.metrics
        lat = bench.latencies()
        thr = mb["completed"] / mb["makespan_s"] if mb["makespan_s"] \
            else 0.0
        log(f"[serve] benchmark (dispatch_cost None, rate {rate:.3f}/s): "
            f"{mb['completed']} completed, p50 {bench.percentile(50):.3f} "
            f"s, p99 {bench.percentile(99):.3f} s, throughput {thr:.3f} "
            f"requests/s, mean occupancy {mb['mean_occupancy']:.2f} of "
            f"{SERVE_PANEL}, {mb['dispatches']} dispatches, makespan "
            f"{mb['makespan_s']:.3f} s ({t_bench:.1f} s); iterations per "
            f"request {sorted(c.iters for c in bench.completions.values())}"
            f"; cache {mb['cache']}")
        require(mb["cache"]["misses"] == 1 and mb["cache"]["hits"] >= 1,
                f"the benchmark's operator was not a cache hit: "
                f"{mb['cache']}")
        require(mb["completed"] == SERVE_REQUESTS and
                lat.size == SERVE_REQUESTS,
                f"benchmark completed {mb['completed']}, ok {lat.size}")

        # 3. the drill, twice: virtual clock, the same load
        drills = [drill_service(ServiceFaultPlan(
            **{k: dict(v) if isinstance(v, dict) else set(v)
               for k, v in SERVE_DRILL_PLAN.items()})).serve(
            load(rate, SERVE_DRILL_REQUESTS).requests(), key, build)
            for _ in range(2)]
        md = drills[0].metrics
        log(f"[serve] drill ({SERVE_DRILL_PLAN}, dispatch_cost "
            f"{SERVE_DRILL_COST}): completed {md['completed']}, dispatches "
            f"{md['dispatches']}, failures {md['dispatch_failures']}, "
            f"retries {md['retries']}, hedges {md['hedges']} (won "
            f"{md['hedge_wins']}), degraded {md['degraded_dispatches']}, "
            f"breaker trips {md['breaker_trips']}, recoveries "
            f"{md['breaker_recoveries']}, p50 "
            f"{drills[0].percentile(50):.3f} s, p99 "
            f"{drills[0].percentile(99):.3f} s (virtual)")
        require(md["completed"] == SERVE_DRILL_REQUESTS and
                all(c.status == "ok"
                    for c in drills[0].completions.values()),
                "a drill request did not end ok")
        require(md["dispatch_failures"] == 2 and md["retries"] == 2 and
                md["hedges"] >= 1,
                f"the drill's faults did not fire as planned: {md}")
        c1 = drills[1].completions
        same = all((a.status, a.iters, a.finished, a.via) ==
                   (c1[r].status, c1[r].iters, c1[r].finished, c1[r].via)
                   for r, a in drills[0].completions.items())
        bitwise = all(torch.equal(a.x, c1[r].x)
                      for r, a in drills[0].completions.items())
        m1 = drills[1].metrics
        same_m = all(md[k] == m1[k] for k in md if k != "cache")
        log(f"[serve] drill rerun: the same completions {same}, x bitwise "
            f"{bitwise}, the same metrics {same_m}")
        require(same and same_m, "the drill is not reproducible")

        # 4. the degraded paths: an open breaker serves single-RHS pcg on
        # key A (the default), then key A loosened (degraded="loose")
        loose_key = key.loosened(SERVE_LOOSE_TOL)
        cache.get_or_build(loose_key, lambda: (*compress(
            shape, data, tol=SERVE_LOOSE_TOL, backend=backend), {}))
        degraded = {}
        for mode, plan in (("pcg", {0: "dl", 1: "dl"}), ("loose", {0: "dl"})):
            dreqs = load(1000.0, 4, SERVE_SEED + 1).requests()
            drep = drill_service(ServiceFaultPlan(device_loss_at=plan),
                                 degraded=mode,
                                 degraded_tol=1e-3,
                                 breaker=CircuitBreaker(
                                     failure_threshold=len(plan),
                                     cooldown=1.0)).serve(dreqs, key, build)
            rel = _serve_recompute(torch, shape, data,
                                   {r.rid: r.b for r in dreqs},
                                   drep.completions)
            degraded[mode] = (drep, rel)
            ml = drep.metrics
            log(f"[serve] degraded='{mode}'"
                + (f" (key A loosened to {SERVE_LOOSE_TOL:g}, "
                   f"{cache.peek(loose_key).nbytes} bytes)"
                   if mode == "loose" else "")
                + f": breaker trips {ml['breaker_trips']}, degraded "
                f"dispatches {ml['degraded_dispatches']}; completions "
                + ", ".join(f"{r}: {c.status} via {c.via} iters {c.iters} "
                            f"(recomputed on key A {rel[r]:.2e})"
                            for r, c in sorted(drep.completions.items())))
            require(ml["degraded_dispatches"] >= 1 and
                    all(c.via == "degraded" and c.status == "ok" and
                        bool(torch.isfinite(c.x).all())
                        for c in drep.completions.values()),
                    f"degraded='{mode}' did not serve the open breaker")
        require(cache.lookup_loosest(key, 1e-3) is cache.peek(loose_key),
                "lookup_loosest did not find key A loosened")

        # 5. the threaded front-end: 4 submitters x 8
        ts_ = ThreadedSolverService(SolverService(cache, **common), key,
                                    build)
        rng = np.random.default_rng(SERVE_SEED + 2)
        total = SERVE_THREADS * SERVE_PER_THREAD
        tb = rng.standard_normal((total, n)).astype(np.float32)
        rids, lock = {}, threading.Lock()

        def submitter(tid):
            for i in range(tid, total, SERVE_THREADS):
                while True:
                    try:
                        rid = ts_.submit(tb[i])
                        break
                    except QueueFull as e:
                        time.sleep(e.retry_after)
                with lock:
                    rids[i] = rid

        t0 = time.perf_counter()
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        tdone = {i: ts_.result(rid, timeout=600) for i, rid in rids.items()}
        ts_.close(timeout=60)
        t_thr = time.perf_counter() - t0
        mt = ts_.metrics
        log(f"[serve] threaded: {SERVE_THREADS} submitters x "
            f"{SERVE_PER_THREAD}: {mt} in {t_thr:.1f} s")
        require(len(set(rids.values())) == total and
                mt["submitted"] == total and mt["completed"] == total and
                mt["duplicates"] == 0 and mt["timeouts"] == 0 and
                all(c.status == "ok" for c in tdone.values()),
                f"threaded requests lost, duplicated or failed: {mt}")

        # every ok answer, recomputed with the plain HGEMV
        checks = {"benchmark": (reqs, bench.completions)}
        drill_bs = {r.rid: r.b for r in
                    load(rate, SERVE_DRILL_REQUESTS).requests()}
        for i, rep in enumerate(drills):
            checks[f"drill{i}"] = (drill_bs, rep.completions)
        checks["threaded"] = ({i: tb[i] for i in tdone}, tdone)
        worst = {}
        for what, (bs, done) in checks.items():
            ok = {r: c for r, c in done.items() if c.status == "ok"}
            rel = _serve_recompute(torch, shape, data, bs, ok)
            worst[what] = max(rel.values())
            marked = sum(c.via == "degraded" for c in done.values())
            log(f"[serve] {what}: {len(ok)} ok answers, recomputed "
                f"||b - (x + A x)|| / ||b|| max {worst[what]:.3e}, median "
                f"{statistics.median(rel.values()):.3e} (tol "
                f"{SERVE_RECOMPUTE_TOL:g}); {marked} marked degraded")
        worst["degraded_pcg"] = max(degraded["pcg"][1].values())
        require(all(v <= SERVE_RECOMPUTE_TOL for v in worst.values()),
                f"recomputed residuals {worst}")
    finally:
        krylov.set_guards_enabled(guards)

    # the span trace
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/serve_trace.json"
        write_span_trace(path, bench.spans + drills[0].spans)
        with open(path) as f:
            doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    log(f"[serve] span trace: {len(doc['traceEvents'])} events, names "
        f"{sorted(names)}")
    require({"serve/operator", "serve/dispatch"} <= names,
            f"span trace names {names}")
    sync()
    launches, routes, _ = launches_that_ran(start)
    captures = krylov.TRACE_COUNTS["block_cg"] - captures0
    log(f"[serve] launches (graph replays included): {launches}; routes "
        f"{routes}; block_cg captures {captures}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() if on_card else 0}")
    require(launches["coupling_mv"] > 0 and launches["batched_gemm"] > 0 and
            launches["batched_qr"] > 0 and launches["batched_svd"] > 0,
            f"a kernel was not launched on the serve path: {launches}")
    require(routes["coupling_mv"].get("warp16", 0) > 0 and
            routes["coupling_mv"].get("warp1", 0) > 0,
            f"coupling_mv routes on the serve path {routes['coupling_mv']}")
    t_phase = time.perf_counter() - t_phase
    log(f"[serve] phase took {t_phase:.1f} s")
    if keep is not None:
        keep.update(serve_pts=pts, serve_shape=shape, serve_data=data)
    return dict(
        build_s=built["build_s"], operator_bytes=entry.nbytes,
        iters_per_request=sorted(c.iters
                                 for c in bench.completions.values()),
        calibration=dict(iters=iters, dispatches=disp,
                         restart25_iters=it25, restart25_dispatches=d25),
        dispatch_ms=s_dispatch * 1e3, service_rate=service_rate, rate=rate,
        p50_s=bench.percentile(50), p99_s=bench.percentile(99),
        throughput=thr, mean_occupancy=mb["mean_occupancy"],
        dispatches=mb["dispatches"], cache=mb["cache"],
        drill={k: md[k] for k in ("dispatches", "dispatch_failures",
                                  "retries", "hedges", "degraded_dispatches",
                                  "breaker_trips", "breaker_recoveries")},
        drill_bitwise=bitwise, recomputed_max=worst, threaded=mt,
        captures=captures, launches=launches, phase_s=t_phase)


# ---------------------------------------------------------------------------
# obs phase: trace neutrality, timers, the solve's phase profile and the
# device's idle share
# ---------------------------------------------------------------------------

OBS_DIR = ROOT / "build"        # the Chrome traces of the idle shares
OBS_REPS = 10                   # interleaved rounds of the two HGEMVs
OBS_SOLVE_STEPS = 10            # graph-replayed [solve] iterations traced
# the profile of the [dsolve] problem: each round times a whole solve
# capped at one segment (10 iterations) and the 11 truncated loops of one
# iteration each, in both comm modes; 1 round (and a warmup round) keeps
# the profile under a minute at ~0.2-0.5 s an eager iteration
OBS_PROFILE = dict(modes=("halo-plan", "allgather"), tol=1e-8, maxiter=10,
                   reps=1, loop_m=1)
# device work in a profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_idle_share(torch, fn, path, reps: int = 5) -> dict:
    """The device's idle share over one call of ``fn()``: a
    ``torch.profiler`` trace with CUDA activity; the window is the host
    range of the call and its synchronize, the busy time the union of the
    device's kernel, copy and set intervals inside it; idle share = 1 -
    busy / window.  Tracing slows the host's enqueue (and the replay of
    a graph's kernels), which widens the window, so the share is also
    given against the call's untraced time (median of ``reps`` calls,
    host clock, synchronized): ``idle_share_untraced`` = 1 - busy /
    untraced.  Writes the Chrome trace to ``path``.  When the trace holds
    no device activity, both shares are None (not measured)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    untraced = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("obs/idle-window"):
            fn()
            torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == "obs/idle-window"
           and e.get("cat") == "user_annotation"]
    require(len(win) == 1, f"{len(win)} idle windows in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans = sorted((max(float(e["ts"]), w0),
                    min(float(e["ts"]) + float(e.get("dur", 0)), w1))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, w0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    share = 1.0 - busy / (w1 - w0) if spans else None
    share_u = max(0.0, 1.0 - busy / untraced) if spans else None
    return dict(window_us=w1 - w0, busy_us=busy, idle_share=share,
                untraced_us=untraced, idle_share_untraced=share_u,
                device_ops=len(spans), trace=str(path.relative_to(ROOT)))


def obs_hgemv_phase(torch, state: dict, device: str = "cuda") -> dict:
    """The first part of ``[obs]``, on the main path's operator (N = 2^20,
    nv = 16): the eager HGEMV's device operations and bits with tracing on
    and off (``obs.trace.set_enabled``), the ``cuda`` and ``torch`` HGEMVs
    by ``obs.timers.interleaved_times`` with their ``median_ratio``, and
    the device's idle share over one eager HGEMV (``device="cpu"``
    rehearses the rest)."""
    from repro_torch.core.matvec import h2_matvec
    from repro_torch.obs import trace
    from repro_torch.obs.timers import interleaved_times, median_ratio

    t_phase = time.perf_counter()
    start = tally_start()
    shape, data, x = state["shape"], state["data"], state["x"]
    fns = {b: (lambda b=b: h2_matvec(shape, data, x, backend=b))
           for b in ("cuda", "torch")}
    counts, outs = {}, {}
    try:
        for flag in (True, False):
            trace.set_enabled(flag)
            counts[flag] = device_ops(
                torch, lambda v: h2_matvec(shape, data, v, backend="cuda"), x)
            outs[flag] = fns["cuda"]()
    finally:
        trace.set_enabled(True)
    bitwise = torch.equal(outs[True], outs[False])
    log(f"[obs] neutrality, eager HGEMV N={shape.n} nv={x.shape[1]}: "
        f"device operations with tracing on {counts[True]}, off "
        f"{counts[False]}; results bitwise equal {bitwise}")
    require(counts[True] == counts[False] and bitwise,
            "tracing changed the HGEMV's device work or its result")
    del outs
    acc = interleaved_times(fns, reps=OBS_REPS, warmup=1)
    med = {b: statistics.median(v) * 1e3 for b, v in acc.items()}
    ratio = median_ratio(acc["torch"], acc["cuda"])
    log(f"[obs] timers: interleaved_times over {OBS_REPS} rounds, host "
        f"clock synchronized: HGEMV cuda {med['cuda']:.3f} ms, torch "
        f"{med['torch']:.3f} ms (medians); median_ratio(torch, cuda) "
        f"{ratio:.3f}")
    idle = device_idle_share(torch, fns["cuda"],
                             OBS_DIR / "obs_hgemv_trace.json") \
        if device == "cuda" else None
    log(f"[obs] idle share, one eager HGEMV: {idle}")
    launches, _, _ = launches_that_ran(start)
    t_phase = time.perf_counter() - t_phase
    log(f"[obs] first part took {t_phase:.1f} s")
    return dict(device_ops=counts[True], bitwise=bitwise, hgemv_ms=med,
                torch_over_cuda=ratio, idle_hgemv=idle, launches=launches,
                first_part_s=t_phase)


def _obs_rank_work(rank: int, args, on_card: bool, dshape, mg, n: int,
                   h: float) -> dict:
    """One rank of the ``[obs]`` profile: ``profile_rank`` on its views of
    the [dsolve] problem; returns its document and its launches."""
    import torch
    from repro_torch.core.comm import Comm
    from repro_torch.kernels import ops
    from repro_torch.obs.profile_solve import profile_rank

    torch.backends.cuda.matmul.allow_tf32 = False
    comm = Comm()
    ops.reset_launch_counts()
    doc = profile_rank(comm, dshape, mg, args, n, h, backend="cuda",
                       **OBS_PROFILE)
    return dict(doc=doc, launches=ops.launch_counts())


def obs_phase(torch, keep: dict, device: str = "cuda") -> dict:
    """The second part of ``[obs]``: the device's idle share over
    ``OBS_SOLVE_STEPS`` graph-replayed iterations of the ``[solve]``
    problem, then ``obs.profile_solve.profile_rank`` of the ``[dsolve]``
    problem over ``DIST_P`` gloo ranks on the card (the partition
    ``[dsolve]`` left, the halo-plan fused and the allgather two-step
    schedules): per-phase microseconds per iteration, coverage, each
    phase's counted bytes against ``phase_comm_model`` and the iteration's
    against ``dist_solve_comm_bytes``, on every rank."""
    from repro_torch.apps import fractional as pf
    from repro_torch.obs.profile_solve import PHASE_ORDER
    from repro_torch.solvers import krylov

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    start = tally_start()
    prob = keep["prob"]
    n, h = prob["n"], prob["h"]
    out = {}
    if on_card:
        apply_a = pf.make_operator(prob, backend="cuda")
        pre = pf.make_preconditioner(prob)
        b = torch.ones((n * n,), dtype=torch.float32, device=device) * h * h
        st = krylov.pcg_init(apply_a, b, pre)

        def seg():
            return krylov.pcg_segment(apply_a, b, st, pre,
                                      steps=OBS_SOLVE_STEPS,
                                      maxiter=10 * OBS_SOLVE_STEPS,
                                      graph=True)
        require(int(seg().k) == OBS_SOLVE_STEPS,
                "the traced segment stopped early")      # the capture
        out["idle_solve"] = device_idle_share(
            torch, seg, OBS_DIR / "obs_solve_trace.json")
        log(f"[obs] idle share, {OBS_SOLVE_STEPS} graph-replayed [solve] "
            f"iterations (n={n}): {out['idle_solve']}")
        del apply_a, pre, b, st
    t0 = time.perf_counter()
    dshape, mg, args = pf.build_dist_problem(
        prob, DIST_P, device=device, dist_source=keep["dsolve_dist"])
    ranks = run_ranks(torch, _obs_rank_work, (dshape, mg, n, h),
                      [pf.local_args(dshape, mg, args, r)
                       for r in range(DIST_P)], device)
    t_ranks = time.perf_counter() - t0
    del args
    if on_card:
        torch.cuda.ipc_collect()
    doc = ranks[0]["doc"]
    for mode, summ in doc["summary"].items():
        us = {r["phase"]: r["us"] for r in doc["phases"]
              if r["comm"] == mode}
        log(f"[obs] profile {mode} (fused {summ['fused']}), {DIST_P} gloo "
            f"ranks, slowest rank per round, {OBS_PROFILE['reps']} rounds: "
            f"us per iteration by phase " +
            ", ".join(f"{ph}={us[ph]:.1f}" for ph in PHASE_ORDER) +
            f"; replayed sum {summ['stage_sum_us_per_iter']:.1f} us, whole "
            f"solve capped at {summ['iterations_run']} iterations "
            f"{summ['whole_us_per_iter']:.1f} us an iteration, coverage "
            f"{summ['coverage']}")
        for r, res in enumerate(ranks):
            s_r = res["doc"]["summary"][mode]
            recs = [x for x in res["doc"]["phases"] if x["comm"] == mode]
            got = {x["phase"]: x.get("measured_comm_bytes", 0) for x in recs}
            model = {x["phase"]: x["model_comm_bytes"] for x in recs}
            if r == 0:
                log(f"[obs] bytes per phase, rank 0, {mode} (counted / "
                    f"phase_comm_model): " +
                    ", ".join(f"{ph}={got[ph]:.0f}/{model[ph]}"
                              for ph in PHASE_ORDER) +
                    f"; the iteration {s_r['measured_comm_bytes_per_iter']}"
                    f" / dist_solve_comm_bytes "
                    f"{s_r['model_comm_bytes_per_iter']}")
            require(got == model and s_r["measured_comm_bytes_per_iter"] ==
                    s_r["model_comm_bytes_per_iter"],
                    f"rank {r} {mode}: counted bytes {got} differ from the "
                    f"model {model}")
    log(f"[obs] gap halo-plan - allgather (us per iteration): " +
        ", ".join(f"{g['phase']}={g['delta_us']:+.1f}" for g in doc["gap"]))
    launches, _, _ = launches_that_ran(start)
    for res in ranks:
        for k, v in res["launches"].items():
            launches[k] += v
    out.update(profile={m: {k: s[k] for k in (
        "iters", "iterations_run", "whole_us_per_iter",
        "stage_sum_us_per_iter", "coverage", "measured_comm_bytes_per_iter",
        "model_comm_bytes_per_iter")} for m, s in doc["summary"].items()},
        phase_us={m: {r["phase"]: r["us"] for r in doc["phases"]
                      if r["comm"] == m} for m in doc["summary"]},
        launches=launches, ranks_s=t_ranks,
        phase_s=time.perf_counter() - t_phase)
    log(f"[obs] launches (profile ranks and graph replays included): "
        f"{launches}; profile ranks {t_ranks:.1f} s; phase took "
        f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# dserve phase: the solver service over DIST_P ranks in lockstep
# ---------------------------------------------------------------------------

DSERVE_REQUESTS = 8
DSERVE_PANEL = 8
DSERVE_CUT_LOG2N = 14           # the allgather key, the NaN drill, [tserve]
DSERVE_RATE = 1000.0            # every request arrives within ~10 ms


def _dserve_rank_work(rank: int, shards, on_card: bool, shapes: dict,
                      dshapes: dict, geoms: dict) -> dict:
    """One rank of ``[dserve]``: a ``SolverService`` with the rank's
    ``Comm`` per episode, in lockstep with the other ranks.  ``shards``:
    the rank's ``local_shard`` of the N = 2^20 operator and of the cut
    one.  Returns per episode the metrics, the dispatch log and (rank 0)
    the gathered answers; and the rank's launches."""
    import torch
    from repro_torch.core.comm import Comm
    from repro_torch.kernels import ops
    from repro_torch.serving import (OperatorCache, OperatorKey,
                                     PoissonLoad, ServiceFaultPlan,
                                     SolverService, gather_answers)
    from repro_torch.solvers import krylov

    torch.backends.cuda.matmul.allow_tf32 = False
    krylov.set_guards_enabled(False)
    comm = Comm()
    ops.reset_launch_counts()
    dev = shards["full"].u_leaf.device
    cache = OperatorCache(max_bytes=1 << 34)

    def service(plan=None, cost=None):
        return SolverService(cache, panel_width=DSERVE_PANEL,
                             restart_every=SERVE_RESTART,
                             max_segments=SERVE_MAX_SEGMENTS, tol=SERVE_TOL,
                             dispatch_cost=cost, seed=0, fault_plan=plan,
                             device=dev, backend="cuda", comm=comm)

    def build(which):
        return lambda: (shapes[which], shards[which],
                        {"dshape": dshapes[which]})

    def key(which, mode):
        return OperatorKey(geometry=geoms[which], kernel=("exponential", 0.1),
                           tol=SERVE_COMPRESS_TOL, comm=mode)

    def load(which):
        return PoissonLoad(n=shapes[which].n, rate=DSERVE_RATE,
                           n_requests=DSERVE_REQUESTS, tol=SERVE_TOL,
                           seed=SERVE_SEED).requests()

    def must_not_build():
        raise AssertionError("the cut halo-plan operator was rebuilt")

    episodes = {
        "full/halo-plan": ("full", "halo-plan", None, None, build("full")),
        "cut/halo-plan": ("cut", "halo-plan", None, SERVE_DRILL_COST,
                          build("cut")),
        "cut/allgather": ("cut", "allgather", None, SERVE_DRILL_COST,
                          build("cut")),
        "cut/halo-plan nan drill": ("cut", "halo-plan",
                                    ServiceFaultPlan(nan_at={1}),
                                    SERVE_DRILL_COST, must_not_build)}
    out = {}
    for name, (which, mode, plan, cost, fn) in episodes.items():
        comm.barrier()
        t0 = time.perf_counter()
        rep = service(plan, cost).serve(load(which), key(which, mode), fn)
        wall = time.perf_counter() - t0
        xs = gather_answers(rep, comm)
        m = dict(rep.metrics)
        m["cache"] = {k: v for k, v in m["cache"].items()
                      if k != "build_seconds"}
        out[name] = dict(
            metrics=m, log=rep.dispatch_log(), wall_s=wall,
            p50=rep.percentile(50), p99=rep.percentile(99),
            done={r: (c.status, c.iters, c.via)
                  for r, c in rep.completions.items()},
            x={r: v.cpu() for r, v in xs.items()} if rank == 0 else None)
    out["launches"] = ops.launch_counts()
    krylov.set_guards_enabled(True)
    return out


def dserve_phase(torch, keep: dict, device: str = "cuda") -> dict:
    """The solver service over ``DIST_P`` gloo ranks on the card, in
    lockstep (``SolverService(comm=...)`` on every rank): the ``[serve]``
    operator (N = 2^20, compressed at 1e-5) partitioned by ``partition_h2``
    and keyed ``halo-plan``, 8 requests on a panel of 8 at tol 1e-4, 100
    iterations a dispatch, the Krylov guards off (as ``[serve]``), on the
    wall clock (each dispatch costs the slowest rank's wall); then, cut to
    N = 2^14 (``DSERVE_CUT_LOG2N``), the local key in this process (CUDA
    graphs), the ``halo-plan`` and ``allgather`` keys and the NaN drill on
    the cached halo-plan resident (a hit, retried).  Every answer is
    recomputed with the single-device plain HGEMV (10 x tol), the cut
    answers also held to the local service's, every rank's metrics and
    dispatch log to rank 0's."""
    import types

    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.compression import compress
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.dist import local_shard, partition_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    from repro_torch.serving import (OperatorCache, OperatorKey,
                                     PoissonLoad, SolverService,
                                     geometry_digest)
    from repro_torch.solvers import krylov

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    backend = "cuda" if on_card else "torch"
    start = tally_start()
    shapes = {"full": keep["serve_shape"]}
    datas = {"full": keep["serve_data"]}
    geoms = {"full": geometry_digest(keep["serve_pts"])}
    side = 1 << (DSERVE_CUT_LOG2N // 2)
    pts = regular_grid_points(side, 2)
    s0, d0, _, _ = construct_h2(pts, exponential_kernel(0.1), leaf_size=64,
                                cheb_p=6, eta=0.9, device=device)
    shapes["cut"], datas["cut"] = compress(s0, d0, tol=SERVE_COMPRESS_TOL,
                                           backend=backend)
    geoms["cut"] = geometry_digest(pts)
    del s0, d0
    sync()
    t0 = time.perf_counter()
    parts = {w: partition_h2(shapes[w], datas[w], DIST_P, device=device)
             for w in shapes}
    sync()
    t_part = time.perf_counter() - t0
    dshapes = {w: parts[w][0] for w in parts}

    # the local service the cut answers are held to (graphs, kernels)
    guards = krylov.guards_enabled()
    krylov.set_guards_enabled(False)
    try:
        local = SolverService(
            OperatorCache(max_bytes=1 << 34), panel_width=DSERVE_PANEL,
            restart_every=SERVE_RESTART, max_segments=SERVE_MAX_SEGMENTS,
            tol=SERVE_TOL, dispatch_cost=SERVE_DRILL_COST, seed=0,
            device=device, backend=backend).serve(
            PoissonLoad(n=shapes["cut"].n, rate=DSERVE_RATE,
                        n_requests=DSERVE_REQUESTS, tol=SERVE_TOL,
                        seed=SERVE_SEED).requests(),
            OperatorKey(geometry=geoms["cut"], kernel=("exponential", 0.1),
                        tol=SERVE_COMPRESS_TOL),
            lambda: (shapes["cut"], datas["cut"], {}))
    finally:
        krylov.set_guards_enabled(guards)
    require(all(c.status == "ok" for c in local.completions.values()),
            "a local cut request did not end ok")

    t0 = time.perf_counter()
    ranks = run_ranks(
        torch, _dserve_rank_work, (shapes, dshapes, geoms),
        [{w: local_shard(dshapes[w], parts[w][1], r) for w in parts}
         for r in range(DIST_P)], device)
    t_ranks = time.perf_counter() - t0
    cut_part = parts["cut"][1]
    del parts
    if on_card:
        torch.cuda.ipc_collect()

    r0 = ranks[0]
    worst, out = {}, {}
    for name, ep in r0.items():
        if name == "launches":
            continue
        which = name.split("/")[0]
        m = ep["metrics"]
        for r, res in enumerate(ranks[1:], start=1):
            require(res[name]["metrics"] == m and res[name]["log"] ==
                    ep["log"] and res[name]["done"] == ep["done"],
                    f"[dserve] rank {r} disagrees with rank 0 on {name}")
        reqs = PoissonLoad(n=shapes[which].n, rate=DSERVE_RATE,
                           n_requests=DSERVE_REQUESTS, tol=SERVE_TOL,
                           seed=SERVE_SEED).requests()
        done = {q: types.SimpleNamespace(x=v.to(device))
                for q, v in ep["x"].items()}
        rel = _serve_recompute(torch, shapes[which], datas[which],
                               {q.rid: q.b for q in reqs}, done)
        worst[name] = max(rel.values())
        its = sorted(v[1] for v in ep["done"].values())
        msg = (f"[dserve] {name}: {m['completed']} completed, statuses "
               f"{sorted({v[0] for v in ep['done'].values()})}, "
               f"{m['dispatches']} dispatches, failures "
               f"{m['dispatch_failures']}, retries {m['retries']}, cache "
               f"{m['cache']}; iterations {its}; virtual p50 {ep['p50']:.3f}"
               f" s, p99 {ep['p99']:.3f} s, makespan {m['makespan_s']:.3f} "
               f"s; wall {ep['wall_s']:.1f} s; recomputed ||b - (x + A x)|| "
               f"/ ||b|| max {worst[name]:.3e} (tol {SERVE_RECOMPUTE_TOL:g}); "
               f"dispatch log equal on {DIST_P} ranks "
               f"({len(ep['log'])} entries)")
        if which == "cut":
            gap = max(float((ep["x"][q].double() - c.x.cpu().double())
                            .norm() / c.x.cpu().double().norm())
                      for q, c in local.completions.items())
            msg += f"; vs the local service's answers {gap:.3e}"
            ep["vs_local"] = gap
        log(msg)
        require(m["completed"] == DSERVE_REQUESTS and
                all(v[0] == "ok" for v in ep["done"].values()),
                f"[dserve] {name}: a request did not end ok")
        out[name] = dict(completed=m["completed"],
                         dispatches=m["dispatches"],
                         failures=m["dispatch_failures"],
                         retries=m["retries"], iters=its, p50_s=ep["p50"],
                         p99_s=ep["p99"], makespan_s=m["makespan_s"],
                         wall_s=ep["wall_s"], recomputed_max=worst[name],
                         vs_local=ep.get("vs_local"))
    nan = r0["cut/halo-plan nan drill"]["metrics"]
    require(nan["dispatch_failures"] >= 1 and nan["retries"] >= 1 and
            nan["cache"]["hits"] >= 1,
            f"[dserve] the NaN drill did not retry on a cache hit: {nan}")
    require(all(v <= SERVE_RECOMPUTE_TOL for v in worst.values()),
            f"[dserve] recomputed residuals {worst}")
    launches, _, _ = launches_that_ran(start)
    for res in ranks:
        for k, v in res["launches"].items():
            launches[k] += v
    # [tserve] serves the cut operator again
    keep.clear()
    keep.update(cut=(shapes["cut"], datas["cut"], dshapes["cut"],
                     geoms["cut"], cut_part))
    t_phase = time.perf_counter() - t_phase
    log(f"[dserve] launches (ranks and graph replays included): "
        f"{launches}; partition {t_part:.2f} s, ranks {t_ranks:.1f} s; "
        f"phase took {t_phase:.1f} s")
    return dict(episodes=out, launches=launches, partition_s=t_part,
                phase_s=t_phase)


# ---------------------------------------------------------------------------
# tserve phase: the threaded front-end on distributed keys
# ---------------------------------------------------------------------------

TSERVE_SUBMITTERS = 4
TSERVE_QUEUE = 8
# More requests than the panel and the queue hold together: while the
# first panel solves (seconds) the queue fills and the next submission is
# refused, whenever the worker's first boundary admits.  At 16 the worker
# could admit a full panel first and the queue take the rest.
TSERVE_REQUESTS = {"halo-plan": 24,
                   "allgather": DSERVE_PANEL + TSERVE_QUEUE + 1}
TSERVE_MODES = ("halo-plan", "allgather")
TSERVE_RESTART = 250            # a request's iterations in 1 dispatch
TSERVE_JOIN_S = 300


def _tserve_rhs(n: int):
    import numpy as np
    rng = np.random.default_rng(SERVE_SEED)
    return rng.standard_normal((max(TSERVE_REQUESTS.values()), n)).astype(
        np.float32)


def _tserve_rank_work(rank: int, shard, on_card: bool, shape, dshape,
                      geom) -> dict:
    """One rank of ``[tserve]``: a ``ThreadedSolverService`` per key over
    a process group of its own (made on every rank before the worker
    starts; the main thread keeps the world group).  Rank 0 is the front
    end: 4 submitter threads send 24 right-hand sides (17 on the
    allgather key) into a queue of 8, backing off on ``QueueFull``; every
    rank closes its service.  Returns per key the metrics, the boundaries,
    the header broadcast's and the rows' scatter's bytes, whether the
    worker ended, and on rank 0 the answers and the latencies; and the
    rank's launches."""
    import threading

    import torch
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    from repro_torch.kernels import ops
    from repro_torch.serving import (OperatorCache, OperatorKey, QueueFull,
                                     SolverService, ThreadedSolverService)
    from repro_torch.solvers import krylov

    torch.backends.cuda.matmul.allow_tf32 = False
    krylov.set_guards_enabled(False)          # as [serve] and [dserve]
    group = dist.new_group(list(range(dist.get_world_size())))
    comm = Comm(group)
    ops.reset_launch_counts()
    dev = shard.u_leaf.device
    rhs = _tserve_rhs(shape.n) if rank == 0 else None
    out = {}
    for mode in TSERVE_MODES:
        comm.reset_counts()
        svc = SolverService(OperatorCache(max_bytes=1 << 34),
                            panel_width=DSERVE_PANEL,
                            restart_every=TSERVE_RESTART,
                            max_segments=SERVE_MAX_SEGMENTS,
                            queue_capacity=TSERVE_QUEUE, tol=SERVE_TOL,
                            device=dev, backend="cuda", comm=comm)
        key = OperatorKey(geometry=geom, kernel=("exponential", 0.1),
                          tol=SERVE_COMPRESS_TOL, comm=mode)
        dist.barrier()
        t0 = time.perf_counter()
        tsvc = ThreadedSolverService(svc, key, lambda: (
            shape, shard, {"dshape": dshape}))
        ep = {}
        if rank == 0:
            rid_of, fulls, lock = {}, [0], threading.Lock()
            go = threading.Barrier(TSERVE_SUBMITTERS)

            def submitter(w):
                go.wait()
                for i in range(w, TSERVE_REQUESTS[mode], TSERVE_SUBMITTERS):
                    while True:
                        try:
                            rid = tsvc.submit(rhs[i])
                            break
                        except QueueFull:
                            with lock:
                                fulls[0] += 1
                            time.sleep(0.02)
                    with lock:
                        rid_of[rid] = i
            threads = [threading.Thread(target=submitter, args=(w,))
                       for w in range(TSERVE_SUBMITTERS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TSERVE_JOIN_S)
            done = {rid: tsvc.result(rid, timeout=TSERVE_JOIN_S)
                    for rid in sorted(rid_of)}
            ep.update(
                rids=sorted(rid_of), fulls=fulls[0],
                status={rid_of[r]: c.status for r, c in done.items()},
                x={rid_of[r]: c.x.cpu() for r, c in done.items()},
                latency=sorted(c.latency for c in done.values()),
                iters=sorted(c.iters for c in done.values()))
        tsvc.close(TSERVE_JOIN_S)
        ep.update(wall_s=time.perf_counter() - t0,
                  closed=not tsvc._thread.is_alive(),
                  metrics=dict(tsvc.metrics), boundaries=tsvc.boundaries,
                  bcast_bytes=comm.recv_by_kind.get("broadcast", 0),
                  scatter_bytes=comm.recv_by_kind.get("scatter", 0),
                  recv=dict(comm.recv_by_kind))
        out[mode] = ep
    out["launches"] = ops.launch_counts()
    krylov.set_guards_enabled(True)
    return out


def tserve_phase(torch, keep: dict, device: str = "cuda") -> dict:
    """``ThreadedSolverService`` on distributed keys (``halo-plan`` and
    ``allgather``): the ``[dserve]`` operator cut to N = 2^14, partitioned
    over ``DIST_P`` gloo ranks, one threaded service per rank in lockstep,
    rank 0 the front end (4 submitter threads, 24 requests, 17 on the
    allgather key, a queue of 8: ``QueueFull`` exercised).  Requires every
    rid completed exactly once, no duplicate, every answer ``ok`` and
    within 10 x tol recomputed on one device with the plain HGEMV, the
    metrics equal on every rank, each rank's received right-hand-side
    bytes equal to its own rows and ``close()`` returned on every rank."""
    import numpy as np
    import types

    from repro_torch.core.dist import local_shard

    t_phase = time.perf_counter()
    shape, data, dshape, geom, ddata = keep["cut"]
    ranks = run_ranks(torch, _tserve_rank_work, (shape, dshape, geom),
                      [local_shard(dshape, ddata, r) for r in range(DIST_P)],
                      device)
    if device == "cuda":
        torch.cuda.ipc_collect()
    rhs = _tserve_rhs(shape.n)
    out = {}
    for mode in TSERVE_MODES:
        ep0 = ranks[0][mode]
        m = ep0["metrics"]
        for r, res in enumerate(ranks):
            require(res[mode]["closed"],
                    f"[tserve] {mode}: rank {r}'s worker did not end at "
                    f"close()")
            require(res[mode]["metrics"] == m,
                    f"[tserve] {mode}: rank {r}'s metrics "
                    f"{res[mode]['metrics']} differ from rank 0's {m}")
        n_req = TSERVE_REQUESTS[mode]
        require(len(set(ep0["rids"])) == n_req and
                m["submitted"] == m["completed"] == n_req and
                m["duplicates"] == 0 and m["timeouts"] == 0,
                f"[tserve] {mode}: not every rid completed exactly once: {m}")
        require(set(ep0["status"].values()) == {"ok"},
                f"[tserve] {mode}: statuses {set(ep0['status'].values())}")
        require(ep0["fulls"] > 0, f"[tserve] {mode}: the queue of "
                f"{TSERVE_QUEUE} never refused a submission")
        done = {i: types.SimpleNamespace(x=x.to(device))
                for i, x in ep0["x"].items()}
        rel = _serve_recompute(torch, shape, data,
                               {i: rhs[i] for i in done}, done)
        worst = max(rel.values())
        require(worst <= SERVE_RECOMPUTE_TOL,
                f"[tserve] {mode}: recomputed residual {worst:.3e}")
        # each rank receives its own rows of each admitted request, no more
        own_rows = n_req * (shape.n // DIST_P) * 4
        for r, res in enumerate(ranks[1:], 1):
            require(res[mode]["scatter_bytes"] == own_rows,
                    f"[tserve] {mode}: rank {r} received "
                    f"{res[mode]['scatter_bytes']} bytes of right-hand "
                    f"sides, its rows are {own_rows}")
        lat = np.asarray(ep0["latency"])
        per_boundary = ranks[1][mode]["bcast_bytes"] / max(
            ranks[1][mode]["boundaries"], 1)
        log(f"[tserve] {mode}: {DIST_P} ranks, {n_req} requests from "
            f"{TSERVE_SUBMITTERS} submitters into a queue of "
            f"{TSERVE_QUEUE} (QueueFull {ep0['fulls']} times): metrics {m} "
            f"equal on every rank; iterations {ep0['iters'][0]}-"
            f"{ep0['iters'][-1]}; wall latency p50 "
            f"{np.percentile(lat, 50):.3f} s, p99 {np.percentile(lat, 99):.3f}"
            f" s; {ranks[1][mode]['boundaries']} boundaries, the decision "
            f"header {per_boundary:.0f} bytes per boundary on rank 1, the "
            f"admitted rows {own_rows} bytes in all (= {n_req} x n/p x 4) "
            f"(received by kind {ranks[1][mode]['recv']}); recomputed "
            f"||b - (x + A x)|| / ||b|| max {worst:.3e} (tol "
            f"{SERVE_RECOMPUTE_TOL:g}); close() returned on every rank; wall "
            f"{ep0['wall_s']:.1f} s")
        out[mode] = dict(metrics=m, fulls=ep0["fulls"],
                         p50_s=float(np.percentile(lat, 50)),
                         p99_s=float(np.percentile(lat, 99)),
                         boundaries=ranks[1][mode]["boundaries"],
                         bcast_bytes_per_boundary=per_boundary,
                         scatter_bytes=own_rows,
                         recomputed_max=worst, wall_s=ep0["wall_s"])
    launches = {k: sum(res["launches"][k] for res in ranks)
                for k in ranks[0]["launches"]}
    # the distributed HGEMV's products run as plain torch (ROADMAP Queue 2
    # item 6b): its kernel is the exchange's pack
    require(launches["halo_pack"] > 0,
            "halo_pack was not launched on the threaded serve path")
    t_phase = time.perf_counter() - t_phase
    log(f"[tserve] launches (every rank): {launches}; phase took "
        f"{t_phase:.1f} s")
    return dict(keys=out, launches=launches, phase_s=t_phase)


# ---------------------------------------------------------------------------
# dryrun phase: the H^2 dry run at the paper's per-device load
# ---------------------------------------------------------------------------

DRY_ROWS_LOG2 = 19
DRY_DEPTH_PROBE = 9


def dryrun_phase(torch, device: str = "cuda") -> dict:
    """``launch.dryrun_h2`` on the production layouts: ``matvec1`` (all
    three comm modes), ``matvec64``, ``compress`` and ``pcg`` in 2D on the
    single pod (p = 16), ``matvec1`` on the multi-pod layout (p = 32),
    2^19 rows per rank, one rank's program walked on meta tensors.
    Requires the collective bytes = ``matvec_comm_bytes`` (the Krylov
    model plus the prologue for ``pcg``) exactly, no kernel launch and no
    memory allocated on the card."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun_h2 as dry
    from repro_torch.launch.mesh import production_layout

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    on_card = device == "cuda"
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    stats = dry.measured_structure_stats(2, DRY_DEPTH_PROBE)
    t_stats = time.perf_counter() - t0
    cells = [(False, c, mode) for c in ("matvec1", "matvec64")
             for mode in dry.MATVEC_MODES] + \
        [(False, "compress", "halo-plan"), (False, "pcg", "halo-plan"),
         (True, "matvec1", "halo-plan")]
    out = []
    for multi_pod, cell, mode in cells:
        kind, nv = dry.CELLS[cell]
        r = dry.dry_cell(kind, 2, nv, production_layout(multi_pod=multi_pod),
                         DRY_ROWS_LOG2, mode=mode, stats=stats)
        coll = sum(r["collectives"].values())
        if "model_comm_bytes" in r:
            require(coll == r["model_comm_bytes"],
                    f"[dryrun] {r['cell']} {mode} p={r['p']}: collective "
                    f"bytes {coll} != model {r['model_comm_bytes']}")
        log(f"[dryrun] {r['cell']} {mode if kind != 'compress' else ''} "
            f"p={r['p']} depth {r['depth']} (2^{DRY_ROWS_LOG2} rows a rank): "
            f"flops {r['flops']:.4e} (matmul {r['matmul_flops']:.4e}), "
            f"bytes {r['bytes']:.4e}, collective bytes {coll} by kind "
            f"{r['collectives']} (model {r.get('model_comm_bytes')}), "
            f"resident {r['resident_bytes']} bytes, walk {r['walk_s']:.3f} s")
        out.append(r)
    launches = ops.launch_counts()
    require(not any(launches.values()),
            f"[dryrun] the walk launched kernels: {launches}")
    require(not on_card or torch.cuda.memory_allocated() == mem0,
            "[dryrun] the walk allocated memory on the card")
    t_phase = time.perf_counter() - t_phase
    log(f"[dryrun] probe stats (depth {DRY_DEPTH_PROBE}) {t_stats:.2f} s, "
        f"C_sp {stats['Csp']}; no launch, no allocation on the card; phase "
        f"took {t_phase:.1f} s")
    return dict(cells=[{k: r[k] for k in ("cell", "comm", "p", "depth",
                                          "flops", "matmul_flops", "bytes",
                                          "collectives", "resident_bytes",
                                          "walk_s")} for r in out],
                phase_s=t_phase)


# ---------------------------------------------------------------------------
# lm phase: qwen3-0.6b at full width and depth, the H^2 mixer, int8 cache
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
LM_SEED = 0
LM_REQUESTS = 8
LM_PROMPT = 128
LM_MAX_LEN = 256
LM_NEW = 32
LM_CONSIST_TOL = 1e-3           # prefill + 1 decode vs extended, float32
LM_KVQ_TOL = 3e-2               # int8 cache attention vs full precision
MIXER_S = 4096
MIXER_D = 1024
MIXER_PLAIN_TOL = 1e-5          # backend="cuda" vs backend="torch"
MIXER_COMPRESS_TOL = 1e-3       # operator of the kernels' vs plain compress
MIXER_DENSE_TOL = 2e-2          # 64 rows vs the dense mix (the reference's)
MIXER_ROWS = 64


def _lm_consistency(torch, cfg, params, toks) -> float:
    """Prefill + 1 decode step against a prefill of the extended sequence:
    relative difference of the logits."""
    from repro_torch.models import api
    s = toks.shape[1]
    with torch.no_grad():
        l1, cache = api.prefill(cfg, params, {"tokens": toks},
                                cache_len=s + 4)
        nxt = l1.argmax(-1)[:, None]
        l2, _ = api.decode_step(cfg, params, {"tokens": nxt}, cache,
                                torch.tensor(s, device=toks.device))
        full, _ = api.prefill(cfg, params,
                              {"tokens": torch.cat([toks, nxt], dim=1)})
    return float((l2.double() - full.double()).norm() / full.double().norm())


def lm_phase(torch, timer, device: str = "cuda", reduced: bool = False,
             mixer_s: int = MIXER_S, mixer_d: int = MIXER_D) -> dict:
    """The LM serving path: ``BatchedServer`` serves ``qwen3-0.6b`` at full
    width and depth in bfloat16 (weights from the port's seeded init): 8
    prompts of 128 tokens, ``max_len`` 256, 32 new tokens; prefill + 1
    decode against a prefill of the extended sequence (float32 at full
    width: 1e-3; bfloat16 printed); the int8 cache's attention on the
    served run's layer-0 cache (3e-2); the H^2 token mixer at S = 4096,
    B = 1, D = 1024 with its structure compressed on the kernels, the
    mixed output on the kernels against the plain backend (1e-5), the
    kernels' compressed operator against the plain compress's, 64 rows
    against the dense kernel mix in float64, and its time beside the
    dense ``torch.matmul`` mix.  ``reduced``, ``mixer_s`` and ``mixer_d``
    shrink it for a rehearsal on the CPU."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import BatchedServer, make_requests
    from repro_torch.models import api
    from repro_torch.models.h2mixer import (h2mixer_apply, h2mixer_params,
                                            h2mixer_structure)
    from repro_torch.models.layers import decode_attention, rms_norm
    from repro_torch.models.transformer import tree_map
    from repro_torch.serving import kv_quant

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = get_config(LM_ARCH)
    if reduced:
        cfg = cfg.reduced()
    else:
        require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                 cfg.hd, cfg.d_ff, cfg.vocab, cfg.param_dtype) ==
                (28, 1024, 16, 8, 128, 3072, 151936, "bfloat16"),
                f"[lm] {LM_ARCH} is not the full config: {cfg}")
    t0 = time.perf_counter()
    params = api.init_params(cfg, LM_SEED, device)
    sync()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    server = BatchedServer(cfg, params, batch_size=LM_REQUESTS,
                           max_len=LM_MAX_LEN, device=device)
    reqs = make_requests(cfg, LM_REQUESTS, LM_PROMPT, LM_NEW, LM_SEED)
    server.serve(make_requests(cfg, LM_REQUESTS, LM_PROMPT, 2, LM_SEED))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    out = server.serve(reqs)
    sync()
    t_serve = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    batch, s = server._batchify(reqs)
    with torch.no_grad():
        prefill_ms = timer.ms(lambda: server.prefill(batch), reps=3,
                              warmup=1) if on_card else float("nan")
        _, cache = server.prefill(batch)
    decode_ms = (t_serve * 1e3 - prefill_ms) / LM_NEW
    idle = None
    if on_card:                     # where one decode step's time goes
        tok0 = torch.zeros((LM_REQUESTS, 1), dtype=torch.long,
                           device=device)
        pos0 = torch.tensor(s, device=device)
        with torch.no_grad():
            idle = device_idle_share(
                torch, lambda: server.decode({"tokens": tok0}, cache, pos0),
                OBS_DIR / "lm_decode_trace.json", reps=5)
    toks = sum(len(v) for v in out.values())
    require(sorted(out) == list(range(LM_REQUESTS)) and
            all(len(v) == LM_NEW for v in out.values()) and
            all(0 <= t < cfg.vocab for v in out.values() for t in v),
            "[lm] the server did not return 32 tokens per request")
    log(f"[lm] {LM_ARCH} {'reduced' if reduced else 'full width and depth'} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bfloat16, {n_params} "
        f"parameters, seeded init {t_init:.2f} s): {LM_REQUESTS} requests x "
        f"{LM_PROMPT}-token prompts, max_len {LM_MAX_LEN}, {LM_NEW} new "
        f"tokens: {toks} tokens in {t_serve:.3f} s ({toks / t_serve:.1f} "
        f"tokens/s); prefill {prefill_ms:.3f} ms (CUDA events, L2 flushed), "
        f"decode {decode_ms:.3f} ms a token (serve wall less prefill); peak "
        f"memory {peak} bytes; request 0's first tokens {out[0][:8]}")
    if idle is not None:
        log(f"[lm] one decode step traced: {idle['device_ops']} device "
            f"operations, busy {idle['busy_us']:.0f} us of the untraced "
            f"{idle['untraced_us']:.0f} us: idle share "
            f"{idle['idle_share_untraced']:.3f} (traced window "
            f"{idle['window_us']:.0f} us, {idle['idle_share']:.3f}); trace "
            f"{idle['trace']}")

    # prefill + 1 decode vs the extended prefill
    head = torch.from_numpy(np.stack([r.prompt for r in reqs[:2]])).to(
        device).long()
    bf16_gap = _lm_consistency(torch, cfg, params, head)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    f32_gap = _lm_consistency(torch, cfg32, p32, head)
    del p32
    log(f"[lm] prefill + 1 decode vs a prefill of the extended sequence "
        f"(2 x {LM_PROMPT} tokens, logits): float32 {f32_gap:.3e} (tol "
        f"{LM_CONSIST_TOL:g}), bfloat16 {bf16_gap:.3e}")
    require(f32_gap <= LM_CONSIST_TOL,
            f"[lm] float32 prefill/decode gap {f32_gap:.3e}")

    # the int8 cache on the served run's layer-0 cache
    k0, v0 = cache["k"][0].float(), cache["v"][0].float()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    q = torch.randn((LM_REQUESTS, 1, cfg.n_heads, cfg.hd), generator=gen,
                    device=device)
    mask = (torch.arange(LM_MAX_LEN, device=device) < s)[None].expand(
        LM_REQUESTS, LM_MAX_LEN)
    ref = decode_attention(q, k0, v0, mask)
    got = kv_quant.decode_attention_q(q, kv_quant.quantize(k0),
                                      kv_quant.quantize(v0), mask)
    kvq_err = float((got - ref).double().norm() / ref.double().norm())
    full_b, quant_b = kv_quant.cache_bytes(
        (LM_REQUESTS, LM_MAX_LEN, cfg.n_kv_heads, cfg.hd))
    per_model = 2 * cfg.n_layers
    log(f"[lm] int8 cache: decode_attention_q vs decode_attention on the "
        f"served layer-0 cache [{LM_REQUESTS}, {LM_MAX_LEN}, "
        f"{cfg.n_kv_heads}, {cfg.hd}] ({s} positions valid): {kvq_err:.3e} "
        f"(tol {LM_KVQ_TOL:g}); cache_bytes bfloat16 {full_b * per_model} "
        f"vs int8 + scales {quant_b * per_model} bytes (K and V, "
        f"{cfg.n_layers} layers)")
    require(kvq_err <= LM_KVQ_TOL, f"[lm] int8 cache attention {kvq_err}")
    del server, params, cache, k0, v0

    # the H^2 token mixer at S = 4096, B = 1, D = 1024 (nv = 1,024)
    start = tally_start()
    t0 = time.perf_counter()
    shape, data = h2mixer_structure(mixer_s, device=device,
                                    backend="cuda" if on_card else "torch")
    sync()
    t_struct = time.perf_counter() - t0
    mcfg = dataclasses.replace(cfg, param_dtype="float32",
                               act_dtype="float32")
    mcfg = dataclasses.replace(mcfg, d_model=mixer_d)
    mp = h2mixer_params(mcfg, gen, torch.float32)
    mp["gate"] = torch.rand(mixer_d, generator=gen, device=device) + 0.5
    x = torch.randn((1, mixer_s, mixer_d), generator=gen, device=device)
    with torch.no_grad():
        y = h2mixer_apply(mcfg, mp, x, shape, data, backend="cuda")
        sync()
    launches, routes, _ = launches_that_ran(start)
    y_plain = h2mixer_apply(mcfg, mp, x, shape, data, backend="torch")
    mix_err = float(((y - x) - (y_plain - x)).double().norm() /
                    (y_plain - x).double().norm())
    require(mix_err <= MIXER_PLAIN_TOL,
            f"[lm] mixer on the kernels vs the plain backend {mix_err:.3e}")
    # the structure's compress on the kernels vs on the plain backend
    pshape, pdata = h2mixer_structure(mixer_s, device=device,
                                      backend="torch")
    from repro_torch.core.matvec import h2_matvec
    probe = torch.randn((mixer_s, 16), generator=gen, device=device)
    ya = h2_matvec(shape, data, probe, backend="torch")
    yb = h2_matvec(pshape, pdata, probe, backend="torch")
    comp_err = float((ya - yb).double().norm() / yb.double().norm())
    require(comp_err <= MIXER_COMPRESS_TOL,
            f"[lm] mixer compress on the kernels vs plain {comp_err:.3e} "
            f"(ranks {shape.ranks} vs {pshape.ranks})")
    del pdata
    # 64 rows against the dense kernel mix, float64
    h = (rms_norm(x, mp["norm"], mcfg.norm_eps) @ mp["w_in"])[0].double()
    rows = torch.randperm(mixer_s, generator=gen, device=device)[:MIXER_ROWS]
    pos = torch.arange(mixer_s, device=device, dtype=torch.float64) / mixer_s
    a_rows = torch.exp(-(pos[rows][:, None] - pos[None]).abs() / 0.05)
    want = a_rows @ h
    hv = h.float()
    mixed = h2_matvec(shape, data, hv, backend="cuda")
    dense_err = float((mixed[rows].double() - want).norm() / want.norm())
    require(dense_err <= MIXER_DENSE_TOL,
            f"[lm] mixer rows vs the dense kernel mix {dense_err:.3e}")
    mixer_ms = timer.ms(lambda: h2mixer_apply(mcfg, mp, x, shape, data,
                                              backend="cuda"), reps=5) \
        if on_card else float("nan")
    a_dense = torch.exp(-(pos[:, None] - pos[None]).abs() / 0.05).float()
    dense_ms = timer.ms(lambda: torch.matmul(a_dense, hv), reps=5) \
        if on_card else float("nan")
    del a_dense
    log(f"[lm] H^2 mixer S={mixer_s} B=1 D={mixer_d} (nv {mixer_d}): "
        f"structure (cheb_p 4, leaf 32, compress 1e-4 on the kernels) "
        f"{t_struct:.2f} s, ranks {shape.ranks} (plain compress "
        f"{pshape.ranks}); kernels vs plain backend {mix_err:.3e} (tol "
        f"{MIXER_PLAIN_TOL:g}); compressed operator vs the plain "
        f"compress's {comp_err:.3e} (tol {MIXER_COMPRESS_TOL:g}); "
        f"{MIXER_ROWS} rows vs the dense kernel mix (float64) "
        f"{dense_err:.3e} (tol {MIXER_DENSE_TOL:g}, the H^2 error at "
        f"cheb_p 4); mixer {mixer_ms:.3f} ms vs dense torch.matmul mix "
        f"{dense_ms:.3f} ms (library yardstick, CUDA events, L2 flushed); "
        f"launches {launches}, by route {routes}")
    for name in ("batched_gemm", "coupling_mv", "batched_qr",
                 "batched_svd"):
        require(launches[name] > 0,
                f"{name} was not launched on the LM mixer path")
    t_phase = time.perf_counter() - t_phase
    log(f"[lm] phase took {t_phase:.1f} s")
    return dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                decode_idle=idle,
                tokens_per_s=toks / t_serve, peak_bytes=peak,
                consistency_f32=f32_gap, consistency_bf16=bf16_gap,
                kvq_err=kvq_err, cache_bytes=[full_b * per_model,
                                              quant_b * per_model],
                mixer_ms=mixer_ms, dense_mix_ms=dense_ms, mixer_err=mix_err,
                mixer_dense_err=dense_err, mixer_compress_err=comp_err,
                launches=launches, phase_s=t_phase)


# ---------------------------------------------------------------------------
# lmfam phase: the other LM families at full width, depth cut
# ---------------------------------------------------------------------------

# layers run at full width: each keeps every kind of block of its family
LMFAM_DEPTH = {
    "qwen3-moe-30b-a3b": 4,         # of 48: 128 experts top-8, untied head
    "rwkv6-7b": 8,                  # of 32
    "zamba2-7b": 15,                # of 81: 2 groups of 6 + a tail of 3
    "llama-3.2-vision-11b": 10,     # of 40: 2 cross-attention layers
    "whisper-tiny": 4,              # of 4 (whole; 4 encoder layers)
}
# the CPU rehearsal's depths (reduced widths): a zamba2 tail, 2 cross layers
LMFAM_REDUCED_DEPTH = {"zamba2-7b": 5, "llama-3.2-vision-11b": 4}
# prefill of s tokens + k decode steps vs a prefill of s + k: (s, k)
LMFAM_CONSIST = {
    "qwen3-moe-30b-a3b": (128, 1),
    "rwkv6-7b": (128, 16),          # both multiples of the wkv chunk of 16
    "zamba2-7b": (128, 64),         # both multiples of the SSD chunk of 64
    "llama-3.2-vision-11b": (128, 1),
    "whisper-tiny": (128, 1),
}
LMFAM_CONSIST_TOL = 1e-3            # float32 at full width, as [lm]
LMFAM_CONSIST_BATCH = 2


def _lmfam_stubs(torch, cfg, b: int, gen, dtype) -> dict:
    """Seeded nonzero ``img_embed`` / ``frames`` (zeros would make the
    cross-attention vanish and hide a fault)."""
    out = {}
    for key, n, fam in (("img_embed", cfg.n_img_tokens, "vlm"),
                        ("frames", cfg.n_frames, "audio")):
        if cfg.family == fam:
            out[key] = torch.randn((b, n, cfg.d_model), generator=gen,
                                   device=gen.device).to(dtype)
    return out


def _lmfam_consistency(torch, cfg, params, toks, stubs, k: int) -> float:
    """Prefill of ``toks[:, :-k]`` + k decode steps fed the known next
    tokens against a prefill of all of ``toks``: relative L2 of the last
    logits."""
    from repro_torch.models import api
    s = toks.shape[1] - k
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, {"tokens": toks[:, :s], **stubs},
                               cache_len=s + k)
        for j in range(k):
            logits, cache = api.decode_step(
                cfg, params, {"tokens": toks[:, s + j:s + j + 1], **stubs},
                cache, torch.tensor(s + j, device=toks.device))
        full, _ = api.prefill(cfg, params, {"tokens": toks, **stubs})
    return float((logits.double() - full.double()).norm() /
                 full.double().norm())


class _MoeDrops:
    """Counts the (token, expert) choices that capacity dispatch drops, by
    wrapping ``models.moe.moe_ffn`` while active (the router and capacity
    rules of ``moe._moe_shard`` recomputed on each layer's input)."""

    def __init__(self, torch):
        self.torch = torch
        self.dropped = 0
        self.choices = 0

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe.moe_ffn

        def counted(cfg, p, x, rules=None, mesh=None):
            torch = self.torch
            t = x.shape[0] * x.shape[1]
            probs = torch.softmax((x.reshape(t, -1) @ p["router"]).float(),
                                  -1)
            _, eid = moe.top_k(probs, cfg.top_k)
            counts = torch.bincount(eid.reshape(-1),
                                    minlength=cfg.n_experts)
            cap = moe._capacity(cfg, t)
            self.dropped += int((counts - cap).clamp(min=0).sum())
            self.choices += t * cfg.top_k
            return self._orig(cfg, p, x, rules, mesh=mesh)

        moe.moe_ffn = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_ffn = self._orig
        return False


def lmfam_phase(torch, timer, device: str = "cuda", reduced: bool = False,
                card: str = "") -> dict:
    """The serving path of the other LM families through ``models/api`` and
    ``BatchedServer``: qwen3-moe-30b-a3b, rwkv6-7b, zamba2-7b,
    llama-3.2-vision-11b and whisper-tiny at their full published width in
    bfloat16 (the port's seeded init), depth cut to ``LMFAM_DEPTH``.  Per
    family: 8 prompts of 128 tokens, ``max_len`` 256, 32 new tokens after
    a 2-token warm serve (the reference's zero stubs), every request
    returning 32 in-vocab tokens; init seconds, prefill ms (CUDA events),
    decode ms a token (serve wall less prefill), tokens/s, peak memory, the
    idle share of one traced decode step; prefill + k decode steps against
    a prefill of s + k tokens in float32 (1e-3; bfloat16 printed) with
    seeded nonzero stubs, MoE at a capacity that drops nothing; the MoE's
    dropped choices at the default capacity factor.  ``reduced`` runs it
    on the reduced configs for a rehearsal on the CPU."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import BatchedServer, make_requests
    from repro_torch.models import api
    from repro_torch.models.transformer import tree_map

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    start = tally_start()
    fams = {}
    for arch, depth in LMFAM_DEPTH.items():
        t_fam = time.perf_counter()
        full = get_config(arch)
        if reduced:
            cfg = full.reduced(n_layers=LMFAM_REDUCED_DEPTH.get(
                arch, full.reduced().n_layers))
        else:
            cfg = dataclasses.replace(full, n_layers=depth)
        cut = f"{cfg.n_layers} of {full.n_layers} layers"
        if cfg.family == "hybrid":
            per = cfg.attn_every
            cut += (f" ({cfg.n_layers // per} groups of {per} + a tail of "
                    f"{cfg.n_layers % per}, {cfg.n_layers // per} shared-"
                    f"block applications)")
        elif cfg.family == "vlm":
            cut += f" ({cfg.n_layers // cfg.cross_every} cross-attention)"
        elif cfg.family == "audio":
            cut += f" + {cfg.enc_layers} encoder layers"
        t0 = time.perf_counter()
        params = api.init_params(cfg, LM_SEED, device)
        sync()
        t_init = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        server = BatchedServer(cfg, params, batch_size=LM_REQUESTS,
                               max_len=LM_MAX_LEN, device=device)
        reqs = make_requests(cfg, LM_REQUESTS, LM_PROMPT, LM_NEW, LM_SEED)
        server.serve(make_requests(cfg, LM_REQUESTS, LM_PROMPT, 2, LM_SEED))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out = server.serve(reqs)
        sync()
        t_serve = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        require(sorted(out) == list(range(LM_REQUESTS)) and
                all(len(v) == LM_NEW for v in out.values()) and
                all(0 <= t < cfg.vocab for v in out.values() for t in v),
                f"[lmfam] {arch}: the server did not return {LM_NEW} "
                f"in-vocab tokens per request")
        batch, s = server._batchify(reqs)
        with torch.no_grad():
            prefill_ms = timer.ms(lambda: server.prefill(batch), reps=3,
                                  warmup=1) if on_card else float("nan")
            drops = {}
            if cfg.moe:
                with _MoeDrops(torch) as dp:
                    _, cache = server.prefill(batch)
                drops["prefill"] = (dp.dropped, dp.choices)
                tok0 = torch.zeros((LM_REQUESTS, 1), dtype=torch.long,
                                   device=device)
                with _MoeDrops(torch) as dd:
                    server.decode({**batch, "tokens": tok0}, cache,
                                  torch.tensor(s, device=device))
                drops["decode"] = (dd.dropped, dd.choices)
            else:
                _, cache = server.prefill(batch)
        decode_ms = (t_serve * 1e3 - prefill_ms) / LM_NEW
        toks = sum(len(v) for v in out.values())
        idle = None
        if on_card:                 # where one decode step's time goes
            tok0 = torch.zeros((LM_REQUESTS, 1), dtype=torch.long,
                               device=device)
            pos0 = torch.tensor(s, device=device)
            with torch.no_grad():
                idle = device_idle_share(
                    torch, lambda: server.decode({**batch, "tokens": tok0},
                                                 cache, pos0),
                    OBS_DIR / f"lmfam_{cfg.name}_decode_trace.json",
                    reps=5)
        del server, cache, batch
        log(f"[lmfam] {arch} {'reduced' if reduced else 'full width'}, depth cut to {cut} (d "
            f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.param_dtype}, "
            f"{n_params} parameters, seeded init {t_init:.2f} s): "
            f"{LM_REQUESTS} requests x {LM_PROMPT}-token prompts, max_len "
            f"{LM_MAX_LEN}, {LM_NEW} new tokens: {toks} tokens in "
            f"{t_serve:.3f} s ({toks / t_serve:.1f} tokens/s); prefill "
            f"{prefill_ms:.3f} ms (CUDA events, L2 flushed), decode "
            f"{decode_ms:.3f} ms a token (serve wall less prefill); peak "
            f"memory {peak} bytes; request 0's first tokens {out[0][:8]}; "
            f"{card}")
        if idle is not None:
            log(f"[lmfam] {arch} one decode step traced: "
                f"{idle['device_ops']} device operations, busy "
                f"{idle['busy_us']:.0f} us of the untraced "
                f"{idle['untraced_us']:.0f} us: idle share "
                f"{idle['idle_share_untraced']:.3f} (traced window "
                f"{idle['window_us']:.0f} us, {idle['idle_share']:.3f}); "
                f"trace {idle['trace']}")
        if drops:
            log(f"[lmfam] {arch} capacity dispatch at capacity_factor "
                f"{cfg.capacity_factor}: dropped (token, expert) choices "
                f"{drops['prefill'][0]} of {drops['prefill'][1]} in the "
                f"served prefill (T = {LM_REQUESTS * s}), "
                f"{drops['decode'][0]} of {drops['decode'][1]} in one decode "
                f"step (T = {LM_REQUESTS})")

        # prefill + k decode steps vs a prefill of s + k tokens
        cs, ck = LMFAM_CONSIST[arch]
        if reduced:
            cs, ck = 16, min(ck, 16)
        rng = np.random.default_rng(LM_SEED)
        ctoks = torch.from_numpy(rng.integers(
            0, cfg.vocab, (LMFAM_CONSIST_BATCH, cs + ck))).to(device)
        gen = torch.Generator(device=device).manual_seed(LM_SEED)
        stubs = _lmfam_stubs(torch, cfg, LMFAM_CONSIST_BATCH, gen,
                             getattr(torch, cfg.act_dtype))
        cfg_c = (dataclasses.replace(cfg, capacity_factor=float(
            cfg.n_experts)) if cfg.moe else cfg)
        bf16_gap = _lmfam_consistency(torch, cfg_c, params, ctoks, stubs, ck)
        cfg32 = dataclasses.replace(cfg_c, param_dtype="float32",
                                    act_dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        del params
        f32_gap = _lmfam_consistency(torch, cfg32, p32, ctoks,
                                     {k: v.float() for k, v in
                                      stubs.items()}, ck)
        del p32
        if on_card:
            torch.cuda.empty_cache()
        t_fam = time.perf_counter() - t_fam
        log(f"[lmfam] {arch} prefill {cs} + {ck} decode steps vs a prefill "
            f"of {cs + ck} ({LMFAM_CONSIST_BATCH} sequences, seeded nonzero "
            f"stubs{', capacity_factor ' + str(cfg_c.capacity_factor) if cfg.moe else ''}"
            f", logits): float32 {f32_gap:.3e} (tol {LMFAM_CONSIST_TOL:g}), "
            f"bfloat16 {bf16_gap:.3e}; family took {t_fam:.1f} s")
        require(f32_gap <= LMFAM_CONSIST_TOL,
                f"[lmfam] {arch} float32 prefill/decode gap {f32_gap:.3e}")
        fams[arch] = dict(
            layers=cfg.n_layers, layers_of=full.n_layers, params=n_params,
            init_s=t_init, prefill_ms=prefill_ms, decode_ms=decode_ms,
            tokens_per_s=toks / t_serve, peak_bytes=peak, decode_idle=idle,
            consistency_f32=f32_gap, consistency_bf16=bf16_gap,
            consistency_sk=[cs, ck],
            moe_dropped={k: list(v) for k, v in drops.items()}, wall_s=t_fam)
    launches, _, _ = launches_that_ran(start)
    t_phase = time.perf_counter() - t_phase
    log(f"[lmfam] launches of the five kernels over the phase: {launches} "
        f"(the families' scans, dispatch and attention are plain PyTorch, "
        f"as the reference's are plain jnp)")
    log(f"[lmfam] phase took {t_phase:.1f} s; {card}")
    return dict(families=fams, phase_s=t_phase, launches=launches)


# ---------------------------------------------------------------------------
# train phase: qwen3-0.6b trained at full width and depth
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEED = 0
TRAIN_SEQ = 4096                # the reference's train_4k sequence length
TRAIN_BATCH = 4                 # micro-batch: 16,384 tokens a step
TRAIN_STEPS = 4                 # cut from 6 for the script's time limit
TRAIN_FLASH = (1, 4096, 16, 8, 128)     # B, S, H, Hkv, hd: qwen3's heads
TRAIN_FLASH_TOL = 2e-4          # of each gradient's largest entry
TRAIN_GRAD_TOL = 1e-4           # reduced configs: the card vs the CPU
TRAIN_GRAD_SEQ = 128            # 8 RWKV chunks, 2 SSD chunks, 4 KV blocks
TRAIN_RESTART = dict(steps=6, global_batch=4, seq_len=64, use_psgd=True)
TRAIN_CKPT_EVERY = 2
TRAIN_FAIL_AT = 3


def _loss_grads(torch, cfg, params, batch) -> tuple:
    """``train_loss`` and the gradient of every parameter leaf."""
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = api.train_loss(cfg, tree_unflatten(params, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _train_flash_check(torch, device: str, shape: tuple, cfg) -> dict:
    """``flash_attention``'s backward (causal, the config's blocks) against
    plain autograd through naive softmax attention, float32, at ``shape``
    (B, S, H, Hkv, hd); both timed (host clock, synchronised)."""
    from repro_torch.models import layers
    b, s, h, hkv, hd = shape
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)

    def draw(*sh):
        return torch.randn(sh, generator=gen, device=device)
    q, k, v = draw(b, s, h, hd), draw(b, s, hkv, hd), draw(b, s, hkv, hd)
    dout = draw(b, s, h, hd)

    def flash(q_, k_, v_):
        return layers.flash_attention(q_, k_, v_, causal=True,
                                      block_q=cfg.flash_block_q,
                                      block_kv=cfg.flash_block_kv)

    def naive(q_, k_, v_):
        g = h // hkv
        sc = torch.einsum("bshgd,bthd->bhgst", q_.reshape(b, s, hkv, g, hd),
                          k_) / math.sqrt(hd)
        mask = torch.ones((s, s), dtype=torch.bool, device=device).tril()
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        return torch.einsum("bhgst,bthd->bshgd", p, v_).reshape(b, s, h, hd)

    out = {}
    for name, fn in (("flash", flash), ("naive", naive)):
        for rep in range(2):            # the second call is timed
            ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            sync()
            t0 = time.perf_counter()
            grads = torch.autograd.grad(fn(*ins), ins, dout)
            sync()
            out[name + "_ms"] = (time.perf_counter() - t0) * 1e3
        out[name] = grads
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(out["flash"], out["naive"])]
    return dict(errs=errs, flash_ms=out["flash_ms"],
                naive_ms=out["naive_ms"])


def _train_config_checks(torch, device: str) -> dict:
    """Every config at ``reduced(float32)``: loss and gradients on
    ``device`` against the port on the CPU (relative L2 per leaf)."""
    import numpy as np

    from repro_torch.configs.base import ARCHS, get_config
    from repro_torch.models import api
    from repro_torch.models.transformer import tree_map
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced(param_dtype="float32",
                                       act_dtype="float32")
        params = api.init_params(cfg, TRAIN_SEED, "cpu")
        rng = np.random.default_rng(TRAIN_SEED)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, TRAIN_GRAD_SEQ + 1)))}
        for key, n, fam in (("img_embed", cfg.n_img_tokens, "vlm"),
                            ("frames", cfg.n_frames, "audio")):
            if cfg.family == fam:
                batch[key] = torch.from_numpy(rng.standard_normal(
                    (2, n, cfg.d_model)).astype(np.float32))
        loss_c, grads_c = _loss_grads(torch, cfg, params, batch)
        loss_d, grads_d = _loss_grads(
            torch, cfg, tree_map(lambda t: t.to(device), params),
            {k: v.to(device) for k, v in batch.items()})
        loss_err = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
        grad_err = max(float((g.cpu() - w).norm() / w.norm())
                       for g, w in zip(grads_d, grads_c))
        out[arch] = dict(loss=float(loss_c), loss_err=loss_err,
                         grad_err=grad_err, leaves=len(grads_c))
    return out


def _train_restart_check(torch, device: str) -> dict:
    """A reduced ``train()`` with checkpoints under ``build/`` and a
    ``FailureInjector`` against the uninterrupted run."""
    import shutil

    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import train
    from repro_torch.runtime.fault import FailureInjector
    cfg = get_config(TRAIN_ARCH).reduced(param_dtype="float32",
                                         act_dtype="float32")
    kw = dict(TRAIN_RESTART, device=device, log_every=100)
    plain = train(cfg, **kw)
    ckpt = OBS_DIR / "train_restart_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    hurt = train(cfg, ckpt_dir=str(ckpt), ckpt_every=TRAIN_CKPT_EVERY,
                 injector=FailureInjector({TRAIN_FAIL_AT: "device lost"}),
                 **kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    resume = (TRAIN_FAIL_AT // TRAIN_CKPT_EVERY) * TRAIN_CKPT_EVERY
    want = plain["loss"][:TRAIN_FAIL_AT] + plain["loss"][resume:]
    return dict(restarts=hurt["restarts"], plain=plain["loss"],
                hurt=hurt["loss"], same=hurt["loss"] == want)


def _train_breakdown(torch, timer, cfg, params, device: str) -> dict:
    """The step's parts at its shapes, by CUDA events: one layer's
    attention forward and backward ([B, S] of the step, bfloat16 in and
    out, float32 tiles), the chunked CE forward + backward, and PowerSGD
    + AdamW over the whole state (random gradients)."""
    from repro_torch.launch.train import OPT_CFG, PSGD_CFG
    from repro_torch.models import layers
    from repro_torch.models.transformer import _head, chunked_ce_loss
    from repro_torch.optim import adamw, grad_compress
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)
    b, s, dt = TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16

    def draw(*sh):
        return torch.randn(sh, generator=gen, device=device).to(dt)
    q = draw(b, s, cfg.n_heads, cfg.hd).requires_grad_(True)
    k = draw(b, s, cfg.n_kv_heads, cfg.hd).requires_grad_(True)
    v = draw(b, s, cfg.n_kv_heads, cfg.hd).requires_grad_(True)

    def attn():
        return layers.flash_attention(q, k, v, causal=True,
                                      block_q=cfg.flash_block_q,
                                      block_kv=cfg.flash_block_kv)
    with torch.no_grad():
        fwd_ms = timer.ms(attn, reps=2, warmup=1)
    out = attn()
    dout = torch.ones_like(out)
    bwd_ms = timer.ms(lambda: torch.autograd.grad(out, (q, k, v), dout,
                                                  retain_graph=True),
                      reps=2, warmup=1)
    del out
    hid = draw(b, s, cfg.d_model).requires_grad_(True)
    head = _head(params)
    tgt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=device)

    def ce():
        loss = chunked_ce_loss(cfg, hid, head, tgt)
        torch.autograd.grad(loss, (hid,))
    ce_ms = timer.ms(ce, reps=2, warmup=1)
    grads = adamw.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=device).to(p.dtype) * 1e-3, params)
    opt = adamw.init_state(OPT_CFG, params)
    psgd = grad_compress.init_state(PSGD_CFG, params, TRAIN_SEED)

    def update():
        g, _ = grad_compress.compress_and_reduce(PSGD_CFG, grads, psgd)
        adamw.apply_updates(OPT_CFG, params, g, opt, 0.5)
    with torch.no_grad():
        opt_ms = timer.ms(update, reps=2, warmup=1)
    del grads, opt, psgd
    return dict(attn_fwd_ms=fwd_ms, attn_bwd_ms=bwd_ms, ce_ms=ce_ms,
                opt_ms=opt_ms,
                attn_step_ms=cfg.n_layers * (2 * fwd_ms + bwd_ms))


def train_phase(torch, timer, device: str = "cuda", reduced: bool = False,
                card: str = "") -> dict:
    """The training path (``launch/train.py``): ``train()`` runs
    ``qwen3-0.6b`` at full width and depth (28 layers, d 1,024, 16/8 heads
    of 128, vocab 151,936, tied embedding, bfloat16, float32 AdamW
    moments) for 4 steps of 4 x 4,096 tokens (``SyntheticLM`` seed 0, the
    reference's train_4k length; its global batch of 256 is the 512-chip
    mesh's), PowerSGD rank 4 on, no checkpoints: ms a step (median of steps
    2-4), tokens/s, peak memory, every step's loss and gradient norm
    (finite), the launches of the five kernels (none); the step's parts
    by CUDA events and the device's idle share over one traced step.
    Card checks: ``flash_attention``'s backward against plain autograd
    through naive attention at qwen3's head shapes (B 1, S 4,096, float32,
    2e-4 of each gradient's max); every config at ``reduced(float32)``,
    loss and gradients on the card within 1e-4 of the CPU's; a reduced
    ``train()`` with checkpoints under ``build/`` and a failure at step 3
    (1 restart, the loss history of the uninterrupted run); the full
    parameter tree saved by ``CheckpointManager`` and restored bitwise.
    ``reduced`` rehearses it on the CPU at the reduced config."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import (OPT_CFG, PSGD_CFG,
                                          build_train_step,
                                          init_train_state,
                                          make_train_batch, train)
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = get_config(TRAIN_ARCH)
    seq, batch, flash_shape = TRAIN_SEQ, TRAIN_BATCH, TRAIN_FLASH
    if reduced:
        cfg = cfg.reduced()
        seq, flash_shape = 64, (1, 256, 4, 2, 32)
    else:
        require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                 cfg.hd, cfg.d_ff, cfg.vocab, cfg.tie_embed,
                 cfg.param_dtype) ==
                (28, 1024, 16, 8, 128, 3072, 151936, True, "bfloat16"),
                f"[train] {TRAIN_ARCH} is not the full config: {cfg}")

    # card checks
    t0 = time.perf_counter()
    fl = _train_flash_check(torch, device, flash_shape, cfg)
    log(f"[train] flash_attention backward vs plain autograd through naive "
        f"softmax attention (B, S, H, Hkv, hd = {flash_shape}, causal, "
        f"blocks {cfg.flash_block_q}/{cfg.flash_block_kv}, float32): dq, "
        f"dk, dv max error / max |grad| {fl['errs'][0]:.3e}, "
        f"{fl['errs'][1]:.3e}, {fl['errs'][2]:.3e} (tol "
        f"{TRAIN_FLASH_TOL:g}); forward + backward {fl['flash_ms']:.1f} ms "
        f"against naive {fl['naive_ms']:.1f} ms (host clock, synchronised)")
    require(max(fl["errs"]) <= TRAIN_FLASH_TOL,
            f"[train] flash backward error {fl['errs']}")
    checks = _train_config_checks(torch, device)
    for arch, r in checks.items():
        log(f"[train] {arch} reduced float32, S {TRAIN_GRAD_SEQ}: loss "
            f"{r['loss']:.6f}, {device} vs the CPU: loss {r['loss_err']:.3e}"
            f", worst of {r['leaves']} gradient leaves {r['grad_err']:.3e} "
            f"(tol {TRAIN_GRAD_TOL:g})")
        require(r["loss_err"] <= TRAIN_GRAD_TOL and
                r["grad_err"] <= TRAIN_GRAD_TOL,
                f"[train] {arch} gradients on {device} vs the CPU: {r}")
    rs = _train_restart_check(torch, device)
    log(f"[train] reduced train() with checkpoints every "
        f"{TRAIN_CKPT_EVERY} steps and a failure at step {TRAIN_FAIL_AT}: "
        f"restarts {rs['restarts']}, losses {rs['hurt']} against the "
        f"uninterrupted {rs['plain']}: replayed history equal "
        f"{rs['same']}")
    require(rs["restarts"] == 1 and rs["same"],
            f"[train] restart drill: {rs}")
    t_checks = time.perf_counter() - t0

    # the slice at full width
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    start = tally_start()
    sync()
    t0 = time.perf_counter()
    hist = train(cfg, steps=TRAIN_STEPS, global_batch=batch, seq_len=seq,
                 seed=TRAIN_SEED, use_psgd=True, device=device, log_every=1)
    sync()
    t_train = time.perf_counter() - t0
    launches, _, _ = launches_that_ran(start)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    step_ms = statistics.median(hist["step_s"][1:]) * 1e3
    tokens = batch * seq
    what = "reduced" if reduced else "full width and depth"
    log(f"[train] {TRAIN_ARCH} {what} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, vocab {cfg.vocab}, "
        f"{cfg.param_dtype}, remat {cfg.remat}), PowerSGD rank "
        f"{PSGD_CFG.rank}, {TRAIN_STEPS} steps of {batch} x {seq} tokens: "
        f"{step_ms:.1f} ms a step (median of steps 2-{TRAIN_STEPS}; first "
        f"{hist['step_s'][0] * 1e3:.1f} ms), {tokens / step_ms * 1e3:.0f} "
        f"tokens/s, peak memory {peak} bytes, train() {t_train:.1f} s; "
        f"{card}")
    for i, (loss, gn, dt) in enumerate(zip(hist["loss"], hist["grad_norm"],
                                           hist["step_s"])):
        log(f"[train] step {i}: loss {loss:.6f}, grad norm {gn:.6f}, "
            f"{dt * 1e3:.1f} ms")
    require(len(hist["loss"]) == TRAIN_STEPS and hist["restarts"] == 0 and
            all(math.isfinite(x) for x in hist["loss"] + hist["grad_norm"]),
            f"[train] the run did not give {TRAIN_STEPS} finite steps: "
            f"{hist}")
    log(f"[train] launches of the five kernels over train(): {launches} "
        f"(the training path is plain PyTorch, as the reference's is "
        f"plain jnp)")
    require(all(n == 0 for n in launches.values()),
            f"[train] a kernel launched on the training path: {launches}")

    # where the step's time goes, and the full tree's checkpoint
    state = init_train_state(cfg, OPT_CFG, TRAIN_SEED, device,
                             psgd_cfg=PSGD_CFG)
    parts, idle = None, None
    if on_card:
        parts = _train_breakdown(torch, timer, cfg, state.params, device)
        log(f"[train] the step's parts (CUDA events, L2 flushed): one "
            f"layer's attention forward {parts['attn_fwd_ms']:.1f} ms, "
            f"backward {parts['attn_bwd_ms']:.1f} ms, so {cfg.n_layers} x "
            f"(2 forwards with remat + 1 backward) = "
            f"{parts['attn_step_ms']:.1f} ms of the {step_ms:.1f} ms step; "
            f"chunked CE forward + backward {parts['ce_ms']:.1f} ms; "
            f"PowerSGD + AdamW {parts['opt_ms']:.1f} ms")
        step_fn = build_train_step(cfg, OPT_CFG, total_steps=TRAIN_STEPS,
                                   psgd_cfg=PSGD_CFG)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=TRAIN_SEED)
        b1 = make_train_batch(cfg, data.batch(1), device)
        idle = device_idle_share(torch, lambda: step_fn(state, b1),
                                 OBS_DIR / "train_step_trace.json", reps=1)
        log(f"[train] one step traced: {idle['device_ops']} device "
            f"operations, busy {idle['busy_us']:.0f} us of the untraced "
            f"{idle['untraced_us']:.0f} us: idle share "
            f"{idle['idle_share_untraced']:.3f} (traced window "
            f"{idle['window_us']:.0f} us, {idle['idle_share']:.3f}); trace "
            f"{idle['trace']}")
    ckpt = OBS_DIR / "train_full_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt), keep=1)
    sync()
    t0 = time.perf_counter()
    mgr.save(0, state.params)
    t_save = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    back, _ = mgr.restore(state.params)
    sync()
    t_restore = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(tree_leaves(state.params), tree_leaves(back)))
    shutil.rmtree(ckpt, ignore_errors=True)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    log(f"[train] the {n_params}-parameter tree ({cfg.param_dtype}) saved "
        f"by CheckpointManager in {t_save:.2f} s ({nbytes} bytes on disk) "
        f"and restored in {t_restore:.2f} s: bitwise equal {same}")
    require(same, "[train] the restored parameters differ")
    del state, back
    if on_card:
        torch.cuda.empty_cache()
    t_phase = time.perf_counter() - t_phase
    log(f"[train] phase took {t_phase:.1f} s (checks {t_checks:.1f} s); "
        f"{card}")
    return dict(step_ms=step_ms, first_step_ms=hist["step_s"][0] * 1e3,
                tokens_per_s=tokens / step_ms * 1e3, peak_bytes=peak,
                loss=hist["loss"], grad_norm=hist["grad_norm"],
                step_s=hist["step_s"], train_s=t_train, parts=parts,
                idle=idle, flash=dict(errs=fl["errs"], ms=fl["flash_ms"],
                                      naive_ms=fl["naive_ms"]),
                configs=checks, restart=rs, ckpt=dict(
                    bytes=nbytes, save_s=t_save, restore_s=t_restore),
                n_params=n_params, launches=launches, phase_s=t_phase)


# ---------------------------------------------------------------------------
# lmdry phase: the LM dry run on meta tensors, held to the card
# ---------------------------------------------------------------------------

LMDRY_ARCH = "qwen3-0.6b"
LMDRY_RECURRENT_PREFILL = 512    # of prefill_32k's 32,768: the chunk loops
LMDRY_WALK_LAYERS = 2            # the meta walk vs the card's walk: depth
LMDRY_WALK_SHAPE = (1, 4096)     # B, S of that train step
LMDRY_CACHE = (8, 128, 256)      # [lm]'s requests, prompt and max_len
# one config of each other family (MoE, RWKV, hybrid, VLM, audio)
LMDRY_FAMILIES = ("qwen3-moe-30b-a3b", "rwkv6-7b", "zamba2-7b",
                  "llama-3.2-vision-11b", "whisper-tiny")
# rank 0's sharded program walked (arch, shape, multi-pod), at 2 layers
LMDRY_RANK_CELLS = (("qwen3-0.6b", "train_4k", False),
                    ("qwen3-0.6b", "train_4k", True),
                    ("qwen3-moe-30b-a3b", "decode_32k", False))
LMDRY_RANK_LAYERS = 2


def _flat_sig(tree, path=""):
    """path -> (shape, dtype) of a nested dict/tuple tree of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_sig(v, f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_sig(v, f"{path}/{i}"))
        return out
    return {path: (tuple(tree.shape), tree.dtype)}


def _lmdry_real_cache(torch, cfg, device: str, gen):
    """A real prefill of ``LMDRY_CACHE``'s prompts on ``device`` (seeded
    weights, zero stub inputs): its cache."""
    from repro_torch.models import api
    b, s, max_len = LMDRY_CACHE
    params = api.init_params(cfg, LM_SEED, device)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=device, dtype=torch.int32)}
    dt = getattr(torch, cfg.act_dtype)
    if cfg.family == "vlm":
        batch["img_embed"] = torch.zeros((b, cfg.n_img_tokens, cfg.d_model),
                                         dtype=dt, device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((b, cfg.n_frames, cfg.d_model),
                                      dtype=dt, device=device)
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, batch, cache_len=max_len)
    return cache


def lmdry_phase(torch, lm: dict, trained: dict, device: str = "cuda",
                card: str = "", cells=None, reduced: bool = False) -> dict:
    """The LM dry run (``launch.dryrun``, ``launch.shapes``,
    ``parallel.sharding``, ``models.api.abstract_params``): the parameter
    specs of all 10 configs at both production layouts (leaves, per-device
    parameter and float32 moment bytes); dry cells walked on ``meta``
    (qwen3-0.6b train_4k, prefill_32k and decode_32k on the single pod and
    train_4k on the multi-pod layout, decode_32k for one config of each
    other family (``LMDRY_FAMILIES``),
    long_500k for RWKV6 and Zamba2, their prefill cut to
    ``LMDRY_RECURRENT_PREFILL`` tokens): per-device flops, matmul flops,
    bytes, argument bytes and walk seconds; rank 0's sharded program of
    ``LMDRY_RANK_CELLS`` at 2 layers walked over ``DryComm``s: its
    collectives by kind, flops and memory; with no launch and no memory
    allocated on the card.  Then the card holds the abstractions: the
    abstract qwen3-0.6b tree equals ``init_params``' on the card leaf by
    leaf and in bytes; the abstract cache equals a real prefill's (8 x
    128 prompts, ``cache_len`` 256) for qwen3-0.6b at full width and one
    reduced config of each other family; the ``meta`` walk of a train step
    (qwen3-0.6b at full width, 2 layers, B 1, S 4,096) equals
    ``op_cost.count_ops`` of the same step on the card operator by
    operator (calls, flops, bytes; a difference is named and the matrix
    products must still agree).  Last, the walked flops of ``[train]``'s
    step (4 x 4,096, full depth, PowerSGD and AdamW) and of ``[lm]``'s
    prefill and one decode step, each beside the rate that phase's
    measured time implies.  ``cells`` replaces the dry cells and
    ``reduced`` runs the card's checks and the steps' walks at qwen3-0.6b's
    reduced config (a CPU rehearsal)."""
    from repro_torch.configs.base import ARCHS, SHAPES, ShapeCfg, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dry
    from repro_torch.launch.mesh import production_layout
    from repro_torch.launch.shapes import abstract_cache, input_specs
    from repro_torch.launch.train import OPT_CFG, PSGD_CFG, build_train_step
    from repro_torch.models import api
    from repro_torch.parallel.sharding import make_param_shardings
    from repro_torch.perf import op_cost

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    ops.reset_launch_counts()
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    layouts = {"1pod": production_layout(), "2pod": production_layout(
        multi_pod=True)}

    # the parameter specs of every config at both layouts
    t0 = time.perf_counter()
    specs = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        params = api.abstract_params(cfg)
        n_leaves = len(_flat_sig(params))
        for name, lay in layouts.items():
            rules = dry.cell_rules(cfg, SHAPES["train_4k"], lay)
            psh = make_param_shardings(params, rules, lay)
            pb = dry.sharded_bytes(params, psh, lay)
            mb = 2 * dry.sharded_bytes(params, psh, lay, torch.float32)
            specs[f"{arch}/{name}"] = dict(leaves=n_leaves, param_bytes=pb,
                                           moment_bytes=mb)
            log(f"[lmdry] specs {arch} {name} ({lay.size} devices, attn_tp "
                f"{rules.attn_tp}): {n_leaves} leaves, per device params "
                f"{pb} bytes, float32 moments {mb} bytes")
    t_specs = time.perf_counter() - t0

    # the dry cells
    if cells is None:
        cells = [(LMDRY_ARCH, s, False, None) for s in
                 ("train_4k", "prefill_32k", "decode_32k")]
        cells.append((LMDRY_ARCH, "train_4k", True, None))
        cells += [(a, "decode_32k", False, None) for a in LMDRY_FAMILIES]
        cells += [(a, s, False, LMDRY_RECURRENT_PREFILL
                   if s == "prefill_32k" else None)
                  for a in ("rwkv6-7b", "zamba2-7b")
                  for s in ("long_500k", "prefill_32k")]
    walks, rows = {}, []
    t0 = time.perf_counter()
    for arch, shape, multi_pod, seq in cells:
        r = dry.dry_cell(arch, shape, layout=layouts["2pod" if multi_pod
                                                      else "1pod"],
                         seq_len=seq, walks=walks, rank=None)
        cut = f", cut {r['cut']}" if r["cut"] else ""
        parts = {k: v for k, v in r["argument_bytes"].items()
                 if k != "total"}
        log(f"[lmdry] cell {arch} x {shape} x "
            f"{'2pod' if multi_pod else '1pod'}{cut}: per device flops "
            f"{r['flops_per_device']:.4e}, matmul flops "
            f"{r['matmul_flops_per_device']:.4e}, bytes "
            f"{r['bytes_per_device']:.4e}, argument bytes "
            f"{r['argument_bytes']['total']} "
            f"({parts}), "
            f"{r['dispatches']} dispatches, walk {r['walk_s']:.2f} s"
            f"{' (shared with the single pod)' if r['walk_reused'] else ''}")
        rows.append({k: r[k] for k in (
            "arch", "shape", "mesh", "cut", "flops_per_device",
            "matmul_flops_per_device", "bytes_per_device", "argument_bytes",
            "dispatches", "walk_s")})
    t_cells = time.perf_counter() - t0

    # one rank's sharded program of three production cells
    t0 = time.perf_counter()
    rank_rows = []
    for arch, shape, multi_pod in LMDRY_RANK_CELLS:
        r = dry.dry_cell(arch, shape, layout=layouts["2pod" if multi_pod
                                                      else "1pod"],
                         n_layers=LMDRY_RANK_LAYERS, rank=0)
        require("rank_skipped" not in r, f"[lmdry] rank walk of {arch} x "
                f"{shape}: {r.get('rank_skipped')}")
        log(f"[lmdry] rank 0 of {arch} x {shape} x "
            f"{'2pod' if multi_pod else '1pod'} ({LMDRY_RANK_LAYERS} "
            f"layers, coords {r['rank_coords']}) walked on meta over "
            f"DryComms: collectives (output bytes) {r['collectives']}, "
            f"received {r['recv_bytes_by_kind']}, rank flops "
            f"{r['rank_flops']:.4e}, matmul flops "
            f"{r['rank_matmul_flops']:.4e} (global / devices "
            f"{r['matmul_flops_per_device']:.4e}), memory {r['memory']}, "
            f"{r['rank_dispatches']} dispatches, walk "
            f"{r['rank_walk_s']:.2f} s")
        rank_rows.append({k: r[k] for k in (
            "arch", "shape", "mesh", "rank_coords", "collectives",
            "recv_bytes_by_kind", "rank_flops", "rank_matmul_flops",
            "matmul_flops_per_device", "memory", "rank_walk_s")})
    t_rank = time.perf_counter() - t0
    launches = ops.launch_counts()
    require(not any(launches.values()),
            f"[lmdry] the walks launched kernels: {launches}")
    mem1 = torch.cuda.memory_allocated() if on_card else 0
    require(mem1 == mem0, f"[lmdry] the walks allocated {mem1 - mem0} "
                          f"bytes on the card")
    log(f"[lmdry] specs of 10 configs x 2 layouts {t_specs:.1f} s, "
        f"{len(cells)} dry cells {t_cells:.1f} s, {len(rank_rows)} rank "
        f"walks {t_rank:.1f} s: no launch, no allocation on the card "
        f"({mem1} bytes before and after)")

    # the abstract tree is the real tree
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    cfg = get_config(LMDRY_ARCH)
    cfg = cfg.reduced() if reduced else cfg
    real = api.init_params(cfg, LM_SEED, device)
    got, want = _flat_sig(real), _flat_sig(api.abstract_params(cfg))
    real_bytes = sum(t.numel() * t.element_size() for t in _leaves(real))
    abs_bytes = sum(math.prod(s) * d.itemsize for s, d in want.values())
    log(f"[lmdry] {LMDRY_ARCH} init_params on {device}: {len(got)} leaves, "
        f"{real_bytes} bytes; abstract_params: {len(want)} leaves, "
        f"{abs_bytes} bytes; equal leaf by leaf {got == want}")
    require(got == want and real_bytes == abs_bytes,
            "[lmdry] abstract_params differs from the card's parameters")
    del real

    # the abstract cache is the real cache
    b, s, max_len = LMDRY_CACHE
    dshape = ShapeCfg("decode", max_len, b, "decode")
    for arch in (LMDRY_ARCH,) + LMDRY_FAMILIES:
        c = get_config(arch)
        c = c.reduced() if reduced or arch != LMDRY_ARCH else c
        got = _flat_sig(_lmdry_real_cache(torch, c, device, gen))
        want = _flat_sig(abstract_cache(c, dshape))
        log(f"[lmdry] cache of {arch} "
            f"{'reduced' if c.d_model == 128 else 'full width'}: real "
            f"prefill ({b} x {s}, cache_len {max_len}) {len(got)} leaves "
            f"{sorted((k, v[0]) for k, v in got.items())[:3]}...; equal to "
            f"abstract_cache {got == want}")
        require(got == want, f"[lmdry] {arch}: abstract cache {want} != "
                             f"real {got}")
    if on_card:
        torch.cuda.empty_cache()

    # the meta walk is the card's walk
    wcfg = dataclasses.replace(cfg, n_layers=LMDRY_WALK_LAYERS)
    wb, ws = (1, 256) if reduced else LMDRY_WALK_SHAPE
    wshape = ShapeCfg("train", ws, wb, "train")
    wparams = api.init_params(wcfg, LM_SEED, device)
    wbatch = {"tokens": torch.randint(0, cfg.vocab, (wb, ws + 1),
                                      generator=gen, device=device,
                                      dtype=torch.int32)}
    card_ops = op_cost.count_ops(dry._program(wcfg, wshape, None, wparams,
                                              wbatch, None))
    meta_ops = dry.walk(wcfg, wshape)["per_op"]
    diff = {k: (card_ops.get(k), meta_ops.get(k))
            for k in sorted(set(card_ops) | set(meta_ops))
            if card_ops.get(k) != meta_ops.get(k)}
    mm_card = op_cost.matmul_flops(card_ops)
    mm_meta = op_cost.matmul_flops(meta_ops)
    tot = {w: [sum(r[f] for r in o.values()) for f in ("calls", "flops",
                                                         "bytes")]
           for w, o in (("card", card_ops), ("meta", meta_ops))}
    log(f"[lmdry] train step of {LMDRY_ARCH} (d {wcfg.d_model}), "
        f"{LMDRY_WALK_LAYERS} layers, B {wb}, S {ws} on {device}: "
        f"{len(card_ops)} operators, calls/flops/bytes {tot['card']}; on "
        f"meta {len(meta_ops)} operators, {tot['meta']}; matmul flops "
        f"{mm_card:.6e} vs {mm_meta:.6e}; operators that differ "
        f"{len(diff)}: {diff}")
    require(mm_card == mm_meta, f"[lmdry] matmul flops card {mm_card} vs "
                                f"meta {mm_meta}")
    del wparams, wbatch
    if on_card:
        torch.cuda.empty_cache()

    # the work of the card's own steps
    tstate = dry.abstract_train_state(cfg, OPT_CFG, PSGD_CFG)
    tstep = build_train_step(cfg, OPT_CFG, total_steps=TRAIN_STEPS,
                             psgd_cfg=PSGD_CFG)
    tbatch = input_specs(cfg, ShapeCfg("train", 64 if reduced else
                                       TRAIN_SEQ, TRAIN_BATCH, "train"))
    t0 = time.perf_counter()
    t_ops = op_cost.count_ops(tstep, tstate, tbatch)
    t_walk = time.perf_counter() - t0
    mparams = api.abstract_params(cfg)
    pre = input_specs(cfg, ShapeCfg("prefill", s, b, "prefill"))
    p_ops = op_cost.count_ops(lambda: api.prefill(cfg, mparams, pre,
                                                  cache_len=max_len))
    cache = abstract_cache(cfg, dshape, mparams)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    tok = input_specs(cfg, dshape)
    d_ops = op_cost.count_ops(lambda: api.decode_step(cfg, mparams, tok,
                                                      cache, pos))
    work = {}
    for name, per_op, ms in (("train step", t_ops, trained["step_ms"]),
                             ("lm prefill", p_ops, lm["prefill_ms"]),
                             ("lm decode step", d_ops, lm["decode_ms"])):
        fl = sum(r["flops"] for r in per_op.values())
        mm = op_cost.matmul_flops(per_op)
        work[name] = dict(flops=fl, matmul_flops=mm, ms=ms,
                          tflops=fl / ms / 1e9, matmul_tflops=mm / ms / 1e9)
        log(f"[lmdry] work of {name}: {fl:.4e} flops ({mm:.4e} matmul) "
            f"walked on meta; at the {ms:.3f} ms measured in this run that "
            f"is {fl / ms / 1e9:.2f} TFLOP/s ({mm / ms / 1e9:.2f} matmul); "
            f"{card}")
    log(f"[lmdry] the train step's walk (PowerSGD + AdamW included) "
        f"{t_walk:.1f} s")
    launches = ops.launch_counts()
    t_phase = time.perf_counter() - t_phase
    log(f"[lmdry] phase took {t_phase:.1f} s; launches {launches}")
    return dict(specs=specs, cells=rows, rank_cells=rank_rows,
                walk_diff=list(diff),
                walk_matmul=[mm_card, mm_meta], walk_totals=tot, work=work,
                launches=launches, phase_s=t_phase)


# ---------------------------------------------------------------------------
# lmmesh phase: the LMs under the sharding rules over a 2 x 2 mesh
# ---------------------------------------------------------------------------

LMMESH_DENSE = ("qwen3-0.6b", 4)          # arch, depth (of 28)
LMMESH_MOE = ("qwen3-moe-30b-a3b", 2)     # arch, depth (of 48)
LMMESH_SEED = 0
LMMESH_SERVE = (4, 256, 8)                # B, prompt, greedy decode steps
LMMESH_TRAIN = (4, 512, 2)                # B, S, steps (PowerSGD on)
LMMESH_START = 25                         # AdamW step the training starts at
LMMESH_LOGIT_TOL = 1e-4                   # of the oracle's max |logit|
LMMESH_LOSS_TOL = 1e-5                    # relative
# each leaf relative in norm, as tests/test_torch_train.py holds steps (the
# max |dp| / max |p| is logged: AdamW's first steps from zero moments move
# a parameter whose gradient is near eps by a rate that rounding shifts)
LMMESH_PARAM_TOL = 1e-5


def _lmmesh_cfg(arch: str, depth: int, reduced: bool):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if reduced:
        return cfg.reduced(param_dtype="float32", act_dtype="float32")
    return dataclasses.replace(cfg, n_layers=depth, param_dtype="float32",
                               act_dtype="float32")


class _ShardDrops:
    """Counts, per call of ``moe._moe_shard`` (one MoE layer on one data
    shard's tokens), the (token, expert) choices its capacity drops."""

    def __init__(self, torch):
        self.torch = torch
        self.calls: list = []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe._moe_shard

        def counted(cfg, p, x, virt_offset=0):
            torch = self.torch
            probs = torch.softmax((x @ p["router"]).float(), -1)
            _, eid = moe.top_k(probs, cfg.top_k)
            counts = torch.bincount(eid.reshape(-1),
                                    minlength=cfg.n_experts)
            cap = moe._capacity(cfg, x.shape[0])
            self.calls.append(int((counts - cap).clamp(min=0).sum()))
            return self._orig(cfg, p, x, virt_offset)

        moe._moe_shard = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._moe_shard = self._orig
        return False


def _lmmesh_serve(torch, cfg, params, toks, steps: int, sync,
                  rules=None, mesh=None) -> dict:
    """Prefill ``toks`` and ``steps`` greedy decode steps, on one device
    or (``mesh``) this rank's part: the global logits of every step
    [steps + 1, B, V], the tokens [B, steps], the times and, on a mesh,
    this rank's received bytes by collective kind for the prefill and the
    first decode step."""
    from repro_torch.launch.mesh import mesh_comms
    from repro_torch.models import api
    from repro_torch.models.transformer import logits_spec
    from repro_torch.parallel.sharding import assemble
    mc = mesh_comms(mesh)
    rows = (lambda t: t) if mc is None else (
        lambda t: t[mc.coord("data") * t.shape[0] // 2:
                    (mc.coord("data") + 1) * t.shape[0] // 2])
    spec = None if mc is None else logits_spec(
        cfg, rules, api.shard_ctx(cfg, rules, 1, mesh))

    def whole(lg):
        return lg if mc is None else assemble(lg, spec, mesh)

    def counts():
        return None if mc is None else mc.bytes_by_kind()

    s = toks.shape[1]
    if mc is not None:
        mc.reset_counts()
    sync()
    t0 = time.perf_counter()
    lg, cache = api.prefill(cfg, params, {"tokens": rows(toks)}, rules,
                            mesh=mesh, cache_len=s + steps)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    bytes_prefill = counts()
    logits = [whole(lg)]
    tokens, decode_ms, bytes_decode = [], [], None
    for i in range(steps):
        tok = logits[-1].argmax(-1)[:, None]
        tokens.append(tok)
        if mc is not None:
            mc.reset_counts()
        sync()
        t0 = time.perf_counter()
        lg, cache = api.decode_step(
            cfg, params, {"tokens": rows(tok)}, cache,
            torch.tensor(s + i, device=toks.device), rules, mesh=mesh)
        sync()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            bytes_decode = counts()
        logits.append(whole(lg))
    return dict(logits=torch.stack(logits), tokens=torch.cat(tokens, 1),
                prefill_ms=prefill_ms, decode_ms=decode_ms,
                bytes_prefill=bytes_prefill, bytes_decode=bytes_decode)


def _lmmesh_train(torch, cfg, device: str, sync, rules=None,
                  mesh=None) -> dict:
    """``LMMESH_TRAIN``'s steps of ``build_train_step`` (AdamW from step
    ``LMMESH_START``, PowerSGD on) from the seeded state, on one device
    or this rank's part of a mesh (its data shard's rows of each global
    batch): losses, step times, the state, this rank's bytes by kind of
    the last step."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import mesh_comms
    from repro_torch.launch.train import (OPT_CFG, PSGD_CFG, TrainState,
                                          build_train_step,
                                          init_train_state, make_train_batch)
    mc = mesh_comms(mesh)
    b, s, steps = LMMESH_TRAIN if cfg.d_model > 128 else (4, 32, 2)
    state = init_train_state(cfg, OPT_CFG, LMMESH_SEED, device, mesh, rules,
                             PSGD_CFG)
    state = TrainState(state.params, state.opt._replace(step=torch.tensor(
        LMMESH_START, dtype=torch.int32, device=device)), state.psgd)
    step_fn = build_train_step(cfg, OPT_CFG, rules, mesh, 100, PSGD_CFG)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=s, global_batch=b,
                       seed=LMMESH_SEED)
    losses, ms, nbytes = [], [], None
    for i in range(steps):
        toks = data.batch(i) if mc is None else data.rows(
            i, mc.coord("data"), mc.layout.axis_size("data"))
        batch = make_train_batch(cfg, toks, device)
        if mc is not None:
            mc.reset_counts()
        sync()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        losses.append(float(met["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        nbytes = None if mc is None else mc.bytes_by_kind()
    return dict(losses=losses, ms=ms, state=state, bytes=nbytes,
                tokens=b * s)


def _lmmesh_rank_work(rank: int, oracle, on_card: bool, reduced: bool
                      ) -> dict:
    """One rank of ``[lmmesh]``: qwen3's serving under ``serve-nofsdp``
    rules with the KV heads over ``model`` and context parallel, its
    training under FSDP both ways, the MoE's serving; each held to the
    one-device ``oracle`` the parent passed (CUDA IPC; the served
    parameters are views of its global trees).  Returns numbers only."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh, mesh_comms
    from repro_torch.models import api
    from repro_torch.optim.adamw import spec_leaves, tree_leaves
    from repro_torch.parallel.sharding import Rules, local_block

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda" if on_card else "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh = make_test_mesh(2, 2)
    ops.reset_launch_counts()
    toks = oracle["toks"]
    steps = oracle["dense"]["tokens"].shape[1]
    out: dict = {}

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else 0

    def serve(key, cfg, rules):
        want = oracle[key]
        # this rank's blocks: views of the parent's seeded global tree
        params = api.shard_params(cfg, want["params"], rules, mesh)
        _lmmesh_serve(torch, cfg, params, toks[:, :7], 1, sync, rules,
                      mesh)                          # warm, untimed
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with _ShardDrops(torch) as drops:
            got = _lmmesh_serve(torch, cfg, params, toks, steps, sync,
                                rules, mesh)
        scale = float(want["logits"].abs().max())
        err = [float((a - b).abs().max()) / scale
               for a, b in zip(got["logits"], want["logits"])]
        return dict(logit_err=err, tokens_equal=bool(torch.equal(
            got["tokens"], want["tokens"])), prefill_ms=got["prefill_ms"],
            decode_ms=got["decode_ms"], bytes_prefill=got["bytes_prefill"],
            bytes_decode=got["bytes_decode"], peak_bytes=peak(),
            drops=drops.calls)

    dense = _lmmesh_cfg(*LMMESH_DENSE, reduced)
    moe = _lmmesh_cfg(*LMMESH_MOE, reduced)
    for attn_tp in (True, False):
        out[f"serve/attn_tp={attn_tp}"] = serve(
            "dense", dense, Rules(fsdp=False, attn_tp=attn_tp))
    specs_of = {}
    for attn_tp in (True, False):
        rules = Rules(attn_tp=attn_tp)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        got = _lmmesh_train(torch, dense, device, sync, rules, mesh)
        want = oracle["train"]
        specs_of[attn_tp] = spec_leaves(api.param_specs(
            dense, rules, mesh_comms(mesh).layout))
        worst = worst_rel = 0.0
        world = mesh_comms(mesh).world
        for p, w, sp in zip(tree_leaves(got["state"].params),
                            want["params"], specs_of[attn_tp]):
            diff = p.double() - local_block(w, sp, mesh).double()
            worst = max(worst, float(diff.abs().max()) /
                        max(float(w.abs().max()), 1e-30))
            # every rank's block (a replicated one as often in both sums)
            sq = world.psum(torch.stack([
                (diff * diff).sum(), (local_block(w, sp, mesh).double()
                                      ** 2).sum()]))
            worst_rel = max(worst_rel, float(sq[0].sqrt() /
                                             sq[1].sqrt().clamp(min=1e-30)))
        out[f"train/attn_tp={attn_tp}"] = dict(
            losses=got["losses"], loss_err=max(
                abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"])),
            param_err=worst, param_rel=worst_rel, ms=got["ms"],
            bytes=got["bytes"], peak_bytes=peak(), tokens=got["tokens"])
        del got
        if on_card:
            torch.cuda.empty_cache()
    out["serve/moe"] = serve("moe", moe, Rules(fsdp=False))
    out["launches"] = ops.launch_counts()
    return out


def _lmmesh_walks(torch, dense, moe, b: int, s: int, steps: int,
                  tb: int, ts: int) -> dict:
    """Rank 0's program of each step ``[lmmesh]`` measures, walked on
    ``meta`` over ``launch.mesh.dry_mesh_comms`` (``DryComm``s) at the
    phase's configs and rules: its received bytes by collective kind
    (``Comm``'s measure), its output bytes and matrix-product flops, per
    step -- the prefill (``cache_len`` s + steps) and one decode step of
    each served layout, one FSDP train step with PowerSGD each way."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun as dry
    from repro_torch.launch.mesh import MeshLayout, dry_mesh_comms, \
        sum_by_kind
    from repro_torch.launch.train import (OPT_CFG, PSGD_CFG,
                                          build_train_step, state_local)
    from repro_torch.models import api
    from repro_torch.parallel.sharding import Rules
    from repro_torch.perf import op_cost
    lay = MeshLayout((2, 2), ("data", "model"))
    out: dict = {}

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    def counted(mc, fn):
        mc.reset_counts()
        got = []
        t0 = time.perf_counter()
        with torch.no_grad():
            per_op = op_cost.count_ops(lambda: got.append(fn()))
        return got[0], dict(recv=sum_by_kind(mc.bytes_by_kind()),
                            out=sum_by_kind(mc.bytes_by_kind(out=True)),
                            matmul=op_cost.matmul_flops(per_op),
                            walk_s=time.perf_counter() - t0)

    for key, cfg, rules in (
            ("serve/attn_tp=True", dense, Rules(fsdp=False, attn_tp=True)),
            ("serve/attn_tp=False", dense, Rules(fsdp=False,
                                                 attn_tp=False)),
            ("serve/moe", moe, Rules(fsdp=False))):
        mc = dry_mesh_comms(lay, 0)
        args = dry.rank_arguments(cfg, ShapeCfg("prefill", s, b, "prefill"),
                                  rules, mc, api.abstract_params(cfg),
                                  {"tokens": meta(b, s)})
        params = args["params"]
        (_, cache), pre = counted(mc, lambda: api.prefill(
            cfg, params, args["batch"], rules, mesh=mc,
            cache_len=s + steps))
        _, dec = counted(mc, lambda: api.decode_step(
            cfg, params, {"tokens": meta(b // 2, 1)}, cache, meta(), rules,
            mesh=mc))
        out[key] = dict(prefill=pre, decode=dec)
    for attn_tp in (True, False):
        rules = Rules(attn_tp=attn_tp)
        mc = dry_mesh_comms(lay, 0)
        state = state_local(dense, dry.abstract_train_state(
            dense, OPT_CFG, PSGD_CFG), rules, mc)
        step_fn = build_train_step(dense, OPT_CFG, rules, mc, 100, PSGD_CFG)
        _, out[f"train/attn_tp={attn_tp}"] = counted(mc, lambda: step_fn(
            state, {"tokens": meta(tb // 2, ts + 1)}))
    return out


def lmmesh_phase(torch, device: str = "cuda", reduced: bool = False,
                 card: str = "") -> dict:
    """The LMs under ``parallel/sharding.py``'s rules over 4 spawned gloo
    ranks on the one card as a 2 x 2 ``("data", "model")`` mesh
    (correctness only: one card holds no two NCCL ranks, so no scaling is
    claimed).  qwen3-0.6b at full width (depth cut to 4 of 28, float32):
    ``prefill`` of 4 x 256 tokens and 8 greedy ``decode_step``s under the
    ``serve-nofsdp`` rules, with the KV heads over ``model`` and context
    parallel (``attn_tp`` off: the full config's layout at ``model`` 16);
    2 ``build_train_step`` steps of 4 x 512 tokens with PowerSGD under
    FSDP, both ways.  qwen3-moe-30b-a3b at full width (2 of 48 layers, 64
    experts a model rank): prefill 4 x 256 and 8 greedy decode steps.
    The oracle is the one-device port on the card, run on each data
    shard's rows (2 each) and concatenated: logits within 1e-4 of its
    max |logit| at every step, the greedy tokens equal, the losses within
    1e-5 relative, the parameters after the steps within 1e-5 of each
    leaf's max |p|, the MoE's dropped choices equal per data shard and
    layer.  Logs per-step wall times, each rank's received bytes by
    collective kind for one prefill, one decode step and one train step,
    and each rank's peak memory.  Then the parent walks rank 0's program
    of each of those steps on ``meta`` over ``DryComm``s
    (``_lmmesh_walks``: the LM dry run's per-rank walk) and requires its
    received bytes to equal rank 0's measured ones, kind by kind.
    ``reduced`` rehearses it on the CPU at the reduced configs."""
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    start = tally_start()
    dense = _lmmesh_cfg(*LMMESH_DENSE, reduced)
    moe = _lmmesh_cfg(*LMMESH_MOE, reduced)
    b, s, steps = LMMESH_SERVE if not reduced else (4, 32, 4)
    gen = torch.Generator().manual_seed(LMMESH_SEED)
    toks = torch.randint(0, dense.vocab, (b, s), generator=gen).to(device)
    oracle: dict = {"toks": toks}
    for key, cfg in (("dense", dense), ("moe", moe)):
        params = api.init_params(cfg, LMMESH_SEED, device)
        parts, drops = [], []
        _lmmesh_serve(torch, cfg, params, toks[:2, :7], 1, sync)   # warm
        for r in range(2):
            with _ShardDrops(torch) as dr:
                parts.append(_lmmesh_serve(torch, cfg, params,
                                           toks[r * b // 2:(r + 1) * b // 2],
                                           steps, sync))
            drops.append(dr.calls)
        oracle[key] = dict(
            params=params, logits=torch.cat([p["logits"] for p in parts], 1),
            tokens=torch.cat([p["tokens"] for p in parts], 0), drops=drops,
            prefill_ms=[p["prefill_ms"] for p in parts],
            decode_ms=[statistics.median(p["decode_ms"]) for p in parts])
    one = _lmmesh_train(torch, dense, device, sync)
    oracle["train"] = dict(losses=one["losses"], ms=one["ms"], params=[
        p.detach() for p in tree_leaves(one["state"].params)])
    del one
    t_oracle = time.perf_counter() - t_phase
    ranks = run_ranks(torch, _lmmesh_rank_work, (reduced,), [oracle] * 4,
                      device)
    launches, _, _ = launches_that_ran(start)
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v

    from repro_torch.launch.mesh import sum_by_kind as kinds
    what = {"serve/attn_tp=True": f"{LMMESH_DENSE[0]} heads over model",
            "serve/attn_tp=False": f"{LMMESH_DENSE[0]} context parallel",
            "serve/moe": f"{LMMESH_MOE[0]} (64 experts a model rank)"}
    for key, label in what.items():
        key_o = "moe" if key == "serve/moe" else "dense"
        for rank, r in enumerate(ranks):
            v = r[key]
            log(f"[lmmesh] {label} rank {rank}: prefill {b} x {s} "
                f"{v['prefill_ms']:.1f} ms, decode steps "
                f"{[round(x, 1) for x in v['decode_ms']]} ms, logits err / "
                f"max |logit| {max(v['logit_err']):.2e}, tokens equal "
                f"{v['tokens_equal']}, peak {v['peak_bytes']} bytes")
            log(f"[lmmesh] {label} rank {rank} bytes received by kind: "
                f"prefill {kinds(v['bytes_prefill'])}, one decode step "
                f"{kinds(v['bytes_decode'])}")
            require(max(v["logit_err"]) <= LMMESH_LOGIT_TOL,
                    f"[lmmesh] {label} rank {rank}: logits off by "
                    f"{max(v['logit_err']):.2e} of max |logit|")
            require(v["tokens_equal"], f"[lmmesh] {label} rank {rank}: the "
                    f"greedy tokens differ from the oracle's")
        log(f"[lmmesh] {label} one-device oracle per data shard: prefill "
            f"{[round(x, 1) for x in oracle[key_o]['prefill_ms']]} ms, "
            f"decode step {[round(x, 1) for x in oracle[key_o]['decode_ms']]}"
            f" ms")
    want_drops = oracle["moe"]["drops"]
    for rank, r in enumerate(ranks):
        d = (rank // 2)
        got = r["serve/moe"]["drops"]
        log(f"[lmmesh] MoE rank {rank} (data shard {d}): dropped choices "
            f"per layer call {got}, oracle {want_drops[d]}")
        require(got == want_drops[d], f"[lmmesh] MoE rank {rank}: dropped "
                f"choices {got} != the oracle's {want_drops[d]}")
    t0 = time.perf_counter()
    tb, ts, _ = LMMESH_TRAIN if not reduced else (4, 32, 2)
    walks = _lmmesh_walks(torch, dense, moe, b, s, steps, tb, ts)
    t_walks = time.perf_counter() - t0
    measured = {f"{key}/{part}": kinds(ranks[0][key][f"bytes_{part}"])
                for key in what for part in ("prefill", "decode")}
    measured.update({key: kinds(ranks[0][key]["bytes"]) for key in (
        "train/attn_tp=True", "train/attn_tp=False")})
    for name, got in measured.items():
        w = walks[name.rsplit("/", 1)[0]][name.rsplit("/", 1)[1]] \
            if name.startswith("serve") else walks[name]
        log(f"[lmmesh] meta walk of rank 0's {name} over DryComms: "
            f"received {w['recv']} (rank 0 measured {got}), output "
            f"bytes {w['out']}, matmul flops {w['matmul']:.6e}, walk "
            f"{w['walk_s']:.2f} s")
        require(w["recv"] == got, f"[lmmesh] {name}: the meta walk's bytes "
                f"{w['recv']} != rank 0's measured {got}")
    log(f"[lmmesh] rank 0's walks on meta took {t_walks:.1f} s")
    for attn_tp in (True, False):
        key = f"train/attn_tp={attn_tp}"
        for rank, r in enumerate(ranks):
            v = r[key]
            log(f"[lmmesh] train FSDP attn_tp={attn_tp} rank {rank}: steps "
                f"{[round(x, 1) for x in v['ms']]} ms ({v['tokens']} tokens "
                f"a step), losses {v['losses']} (err {v['loss_err']:.2e}), "
                f"params: worst leaf ||dp|| / ||p|| {v['param_rel']:.2e}, "
                f"max |dp| / max |p| {v['param_err']:.2e}, peak "
                f"{v['peak_bytes']} bytes, bytes received by kind in one "
                f"step {kinds(v['bytes'])}")
            require(v["loss_err"] <= LMMESH_LOSS_TOL,
                    f"[lmmesh] {key} rank {rank}: loss off by "
                    f"{v['loss_err']:.2e}")
            require(v["param_rel"] <= LMMESH_PARAM_TOL,
                    f"[lmmesh] {key} rank {rank}: a parameter leaf off by "
                    f"{v['param_rel']:.2e} relative")
    log(f"[lmmesh] one-device oracle train steps "
        f"{[round(x, 1) for x in oracle['train']['ms']]} ms, losses "
        f"{oracle['train']['losses']}")
    log(f"[lmmesh] launches of the five kernels over the phase (parent and "
        f"ranks): {launches}")
    train_ms = oracle["train"]["ms"]
    del oracle
    if on_card:
        torch.cuda.empty_cache()
    t_phase = time.perf_counter() - t_phase
    log(f"[lmmesh] phase took {t_phase:.1f} s (oracle {t_oracle:.1f} s); "
        f"{card}")
    return dict(ranks=[{k: {kk: vv for kk, vv in v.items()}
                        if isinstance(v, dict) else v
                        for k, v in r.items()} for r in ranks],
                oracle_train_ms=train_ms, phase_s=t_phase,
                walks=walks, walks_s=t_walks, launches=launches)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=20,
                    help="points = 2^log2n on a square grid (even)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {entry}: {line.strip()}")

    timer = Timer(torch)
    results: dict = {}
    kernel_phase(torch, timer, results)
    torch.cuda.reset_peak_memory_stats()
    main, state = main_path(torch, args.log2n)
    for name, n in main["launches"].items():
        log(f"[kernels] {name}: {n} launches on the main path")
    for name, rr in main["routes"].items():
        log(f"[kernels] {name} by route on the main path: {rr}")
    for name, route in (("batched_qr", "warp"), ("batched_qr", "tall"),
                        ("batched_svd", "warp"), ("batched_svd", "warp_t")):
        require(main["routes"][name][route] > 0,
                f"{name} route {route} was not launched on the main path")
    cm = main["routes"]["coupling_mv"]
    require(cm["general"] == 0 and
            sum(cm.values()) == main["launches"]["coupling_mv"],
            f"a main-path coupling_mv launch took the general route: {cm}")
    shape_rows = compress_shape_timings(
        torch, timer, state["shape"], state["data"],
        {("qr", (16384, 64, 36)): (results["batched_qr"]["plain_ms"],
                                   results["batched_qr"]["library_ms"]),
         ("svd_u", (16384, 36, 36)): (results["batched_svd"]["plain_ms"],
                                      results["batched_svd"]["library_ms"])})
    coupling_rows = {
        what: coupling_level_timings(torch, timer, state[s_], state[d_],
                                     state["x"], what)
        for what, s_, d_ in (("uncompressed", "shape", "data"),
                             ("compressed", "cshape", "cdata"))}
    for name in ("batched_gemm", "coupling_mv", "batched_qr", "batched_svd"):
        require(main["launches"][name] > 0,
                f"{name} was not launched on the main path")
    guard_ops = guard_operator_phase(torch, state)
    del state["cshape"], state["cdata"]
    for name, n in guard_ops["launches"].items():
        log(f"[kernels] {name}: {n} launches on the guard path (operator "
            f"checks)")
    for name in ("batched_gemm", "coupling_mv"):
        require(guard_ops["launches"][name] > 0,
                f"{name} was not launched by the operator checks")
    log(f"[memory] max_memory_allocated {torch.cuda.max_memory_allocated()}"
        f" bytes")
    obs_a = obs_hgemv_phase(torch, state)
    dist = dist_phase(torch, timer, state, results)
    del state
    for name, n in dist["launches"].items():
        log(f"[kernels] {name}: {n} launches on the distributed path")
    for name in ("halo_pack", "batched_qr", "batched_svd"):
        require(dist["launches"][name] > 0,
                f"{name} was not launched on the distributed path")
    solve, keep = solve_phase(torch, timer)
    for name, n in solve["launches"].items():
        log(f"[kernels] {name}: {n} launches on the solve path")
    for name in ("batched_gemm", "coupling_mv", "batched_qr", "batched_svd"):
        require(solve["launches"][name] > 0,
                f"{name} was not launched on the solve path")
    cm = solve["routes"]["coupling_mv"]
    require(cm["general"] == 0,
            f"a solve-path coupling_mv launch took the general route: {cm}")
    dsolve = dsolve_phase(torch, keep)
    for name, n in dsolve["launches"].items():
        log(f"[kernels] {name}: {n} launches on the distributed solve path")
    obs_b = obs_phase(torch, keep)
    obs_launches = {k: obs_a["launches"][k] + obs_b["launches"][k]
                    for k in KERNELS}
    for name, n in obs_launches.items():
        log(f"[kernels] {name}: {n} launches on the obs path")
    for name in ("batched_gemm", "coupling_mv", "halo_pack"):
        require(obs_launches[name] > 0,
                f"{name} was not launched on the obs path")
    chaos = chaos_phase(torch, keep)
    for name, n in chaos["launches"].items():
        log(f"[kernels] {name}: {n} launches on the chaos path")
    for name in ("dsolve_history", "dsolve_u", "dsolve_relres"):
        del keep[name]
    sketch = sketch_phase(torch, timer, keep)
    solve_iters = keep["iters"]
    del keep
    for name, n in sketch["launches"].items():
        log(f"[kernels] {name}: {n} launches on the sketch path")
    for name in ("batched_gemm", "coupling_mv", "batched_qr", "batched_svd"):
        require(sketch["launches"][name] > 0,
                f"{name} was not launched on the sketch path")
    guard = guard_phase(torch, solve_iters)
    guard_launches = {k: guard_ops["launches"][k] + guard["launches"][k]
                      for k in KERNELS}
    for name, n in guard_launches.items():
        log(f"[kernels] {name}: {n} launches on the guard path")
    for name in ("batched_gemm", "coupling_mv", "batched_qr", "batched_svd"):
        require(guard["launches"][name] > 0,
                f"{name} was not launched by the certified constructions and "
                f"guarded solves")
    served = {}
    serve = serve_phase(torch, keep=served)
    for name, n in serve["launches"].items():
        log(f"[kernels] {name}: {n} launches on the serve path")
    dserve = dserve_phase(torch, served)
    for name, n in dserve["launches"].items():
        log(f"[kernels] {name}: {n} launches on the distributed serve path")
    for name in ("batched_gemm", "coupling_mv", "halo_pack"):
        require(dserve["launches"][name] > 0,
                f"{name} was not launched on the distributed serve path")
    tserve = tserve_phase(torch, served)
    del served
    for name, n in tserve["launches"].items():
        log(f"[kernels] {name}: {n} launches on the threaded distributed "
            f"serve path")
    dry = dryrun_phase(torch)
    lm = lm_phase(torch, timer)
    for name, n in lm["launches"].items():
        log(f"[kernels] {name}: {n} launches on the LM path (the H^2 "
            f"mixer)")
    lmfam = lmfam_phase(torch, timer, card=smi)
    for name, n in lmfam["launches"].items():
        log(f"[kernels] {name}: {n} launches on the LM families path")
    trained = train_phase(torch, timer, card=smi)
    for name, n in trained["launches"].items():
        log(f"[kernels] {name}: {n} launches on the training path")
    lmdry = lmdry_phase(torch, lm, trained, card=smi)
    for name, n in lmdry["launches"].items():
        log(f"[kernels] {name}: {n} launches on the LM dry run path")
    lmmesh = lmmesh_phase(torch, card=smi)
    for name in KERNELS:
        log(f"[kernels] {name}: {lmmesh['launches'].get(name, 0)} launches "
            f"on the sharded LM path")
    kernels = []
    for name in KERNELS:
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{name}.cu",
            replaces=REPLACES[name],
            launches=(main["launches"][name] + dist["launches"][name] +
                      solve["launches"][name] + dsolve["launches"][name] +
                      sketch["launches"][name] + guard_launches[name] +
                      chaos["launches"][name] + serve["launches"][name] +
                      obs_launches[name] + dserve["launches"][name] +
                      tserve["launches"][name] + lm["launches"][name] +
                      trained["launches"][name] +
                      lmdry["launches"][name] +
                      lmmesh["launches"].get(name, 0)),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    summary = {k: v for k, v in main.items() if k != "launches"}
    dsummary = {k: v for k, v in dist.items() if k != "launches"}
    detail_qr_svd = {"compress_shapes": shape_rows, **{
        name: {k: results[name][k] for k in ("general_ms", "with_vt_ms")
               if k in results[name]}
        for name in ("batched_qr", "batched_svd")}}
    detail = {"batched_gemm": {k: results["batched_gemm"][k]
                               for k in ("shapes", "host")},
              "halo_pack": {k: v for k, v in results["halo_pack"].items()
                            if k not in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "max_abs_err")},
              "coupling_mv": {"general_ms": results["coupling_mv"][
                  "general_ms"], "levels": coupling_rows},
              **detail_qr_svd}
    ssummary = {k: v for k, v in solve.items() if k != "launches"}
    ksummary = {k: v for k, v in sketch.items() if k != "launches"}
    gsummary = {"operator_checks": {k: v for k, v in guard_ops.items()
                                    if k != "launches"},
                "validate_dist_s": dist["validate_dist_s"],
                **{k: v for k, v in guard.items() if k != "launches"},
                "launches": guard_launches}
    log(json.dumps({"main_path": summary, "distributed": dsummary,
                    "solve": ssummary, "distributed_solve": dsolve,
                    "sketch": ksummary, "guard": gsummary,
                    "chaos": {k: v for k, v in chaos.items()
                              if k != "launches"},
                    "serve": {k: v for k, v in serve.items()
                              if k != "launches"},
                    "obs": {**{k: v for k, v in obs_a.items()
                               if k != "launches"},
                            **{k: v for k, v in obs_b.items()
                               if k != "launches"}},
                    "dserve": {k: v for k, v in dserve.items()
                               if k != "launches"},
                    "tserve": {k: v for k, v in tserve.items()
                               if k != "launches"},
                    "dryrun": dry,
                    "lm": {k: v for k, v in lm.items() if k != "launches"},
                    "lmfam": {k: v for k, v in lmfam.items()
                              if k != "launches"},
                    "train": {k: v for k, v in trained.items()
                              if k != "launches"},
                    "lmdry": {k: v for k, v in lmdry.items()
                              if k != "launches"},
                    "lmmesh": {k: v for k, v in lmmesh.items()
                               if k != "launches"},
                    "kernel_detail": detail, "card": smi}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
