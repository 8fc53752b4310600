"""PyTorch port: the distributed §6.4 solve against the JAX reference, in
spawned gloo groups of p = 2, 4 and 8 ranks on the CPU.

Host only: the transposition plan (``build_transpose_plan``) equals the
reference's bit for bit; ``build_grid_mg(p)``'s arrays, the deep-halo
strips ``hc`` included, equal the reference's; the comm models
(``mg_halo_bytes``, ``solver_hide_flops``, ``krylov_comm_bytes``,
``dist_solve_comm_bytes``) equal the reference's, each package computing
them from its own ``build_dist_problem`` of the reference's operator.

In the groups (p = 8 runs the V-cycle checks only; the bounds of ``fractional_checks``,
``fused_solver_checks``, ``solver_checks`` and ``mg_gathered_check`` in
``tests/dist_worker.py``): ``solve_distributed(16, h2_tol=1e-7,
tol=1e-10)`` and ``make_dist_solve`` in every comm mode, fused and
two-step, take the reference's single-device iterations with ``u`` within
1e-5 of its ``u`` and within 2e-2 of the dense direct solve; the bf16
modes take iterations within 5 and ``u`` within 1e-3 (``halo-plan-bf16``,
the reference's bound) or 2e-2 (``ppermute-bf16``, which rounds whole
levels; the port's bf16 matvec bound, ``test_torch_dist.py``).  Every
rank reports the same iterations, status, relres and history.  The
sharded V-cycle is within 1e-6 of p = 1 on a random residual, fused and
unfused bitwise equal; the gathered fallback (n = 8, p = 8) too.
``make_dist_krylov`` on ``I + A`` (``test_torch_dist.py``'s operators)
against the reference's single-device solvers: uniform iterations within
1 (``KRYLOV``) and ``x`` within 1e-4, graded iterations within 2 and ``x``
within 5e-3;
``make_dist_krylov_segment`` takes the monolithic solve's iterations.
Each rank's counted bytes of one PCG iteration equal the model; ``psum``
gives every rank the same bits.

JAX is imported inside the fixtures only: the spawned ranks import this
module to find their entry point.  Each group uses a ``file://``
rendezvous in ``tmp_path``, one thread per rank, and is joined with a
deadline, so a hung rank fails its test.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.apps import fractional as pf
from repro_torch.core import dist as td
from repro_torch.core import halo as th
from repro_torch.core import structure as ts
from repro_torch.solvers import distributed as psd
from repro_torch.solvers import krylov as pk
from repro_torch.solvers import mg as pmg

torch.set_num_threads(2)

N = 16
SOLVE = dict(h2_tol=1e-7, tol=1e-10)
RANK_TIMEOUT_S = 300
P_FULL = (2, 4)                  # every check
P_ALL = (2, 4, 8)                # the V-cycle and psum
# (mode, fused, schedule) of make_dist_solve: the reference's parity
# matrix (fused_solver_checks) plus the comm modes it leaves out
FP32 = [("halo-plan", False, "auto"), ("halo-plan", True, "overlap"),
        ("allgather", False, "auto"), ("allgather", True, "auto"),
        ("allgather", True, "overlap"), ("ppermute", False, "auto")]
BF16 = [("halo-plan-bf16", True, "auto"), ("halo-plan-bf16", False, "auto"),
        ("ppermute-bf16", False, "auto")]
# uniform: the reference's worker holds its counts equal ("the residual
# crosses tol decisively"); with this right-hand side the reference's pcg
# residual crosses at 0.91 tol (iteration 36), and the rank-order sums of
# p = 4 cross one iteration later, so the count is held within 1
KRYLOV = {"uniform2d": dict(tol=1e-6, slack=1, xerr=1e-4),
          "graded1d": dict(tol=1e-4, slack=2, xerr=5e-3)}
NV = 3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _mg_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    kappa = (1.0 + 0.5 * rng.random((n, n))).astype(np.float32)
    dd = (1.0 + rng.random((n, n))).astype(np.float32)
    r = rng.standard_normal(n * n).astype(np.float32)
    return kappa, dd, r


def _wire_model(dshape, mg, mode: str, tcaps, fused: bool) -> int:
    """``dist_solve_comm_bytes``, with the matvec's payload rows at bf16
    width where the mode ships them so but the reference's model counts
    them at 4 bytes (``dist.matvec_comm_bytes``: "-bf16 modes halve
    bytes_per_el at the call site"; the branch-root gather stays fp32)."""
    model = pf.dist_solve_comm_bytes(dshape, mg, mode, tcaps=tcaps,
                                     fused=fused)
    if mode.endswith("-bf16") and not (fused and
                                       mode.startswith("halo-plan")):
        root = (dshape.p - 1) * dshape.ranks[dshape.lc]
        model += (td.matvec_comm_bytes(dshape, 1, mode, 2) + 2 * root
                  - td.matvec_comm_bytes(dshape, 1, mode, 4))
    return model


# ---------------------------------------------------------------------------
# one rank of a spawned group
# ---------------------------------------------------------------------------

def _solve_record(parts, res, comm, b, mode, fused) -> dict:
    """A solve's result plus the bytes this rank received in one PCG
    iteration (``_pcg_step``) beside the model."""
    st = pk.pcg_init(parts["apply_a"], b, parts["precond"], comm=comm)
    comm.reset_counts()
    pk._pcg_step(parts["apply_a"], parts["precond"], st.x, st.r, st.p,
                 st.rz, comm=comm)
    return dict(iters=int(res.iters), status=int(res.status),
                relres=float(res.relres), x=res.x.numpy(),
                hist=res.res_history.numpy(), bytes=comm.recv_bytes,
                model=_wire_model(parts["dshape"], parts["mg"], mode,
                                  parts["tcaps"], fused))


def _rank_main(rank: int, p: int, init: str, out: str, work: dict) -> None:
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    comm = Comm()
    res = {}
    full = p in P_FULL

    if full:
        r = pf.solve_distributed(N, comm, device="cpu", **SOLVE)
        res["solve_distributed"] = dict(
            iters=r["iters"], status=r["status"], relres=r["relres"],
            x=r["u"].numpy(), hist=r["history"].numpy(),
            fused=r["parts"]["fused"], recv_bytes=r["recv_bytes"])
        prob = r["prob"]
        b = torch.ones(N * N // p) * prob["h"] ** 2
    for mode, fused, sched in (FP32 + BF16 if full else []):
        parts = pf.make_dist_solve(prob, comm, mode=mode, tol=SOLVE["tol"],
                                   schedule=sched, fused=fused,
                                   device="cpu")
        res[(mode, fused, sched)] = _solve_record(parts, parts["fn"](b),
                                                  comm, b, mode, fused)

    # the sharded V-cycle alone, fused and unfused, on the rank's strip
    kappa, dd, rr = work["mg"]
    n_mg = kappa.shape[0]
    mg, arrs = pmg.build_grid_mg(kappa, dd, 2.0, 2.0 / n_mg, n_mg, p=p,
                                 device="cpu")
    loc = pmg.mg_local_shard(mg, arrs, rank)
    strip = torch.as_tensor(rr).reshape(p, -1)[rank]
    for fused in (False, True):
        res[("precond", fused)] = pmg.mg_precond_local(
            mg, loc, strip, comm, fused=fused).numpy()
    if p == 8:
        kappa, dd, rr = work["gathered"]
        mg, arrs = pmg.build_grid_mg(kappa, dd, 2.0, 0.25, 8, p=p,
                                     device="cpu")
        res["gathered_n_sharded"] = mg.n_sharded
        res["gathered"] = pmg.mg_precond_local(
            mg, pmg.mg_local_shard(mg, arrs, rank),
            torch.as_tensor(rr).reshape(p, -1)[rank], comm).numpy()

    gen = torch.Generator().manual_seed(100 + rank)
    part = torch.randn(5, generator=gen, dtype=torch.float32) * 10.0 ** rank
    res["psum"] = comm.psum(part).numpy()

    for geom, w in (work["krylov"].items() if full else ()):
        cfg = KRYLOV[geom]
        shape = ts.H2Shape(**w["shape"])
        data = ts.data_from_numpy(w["data"], device="cpu")
        dshape, ddata = td.partition_h2(shape, data, p, device="cpu")
        d = td.local_shard(dshape, ddata, rank)
        nloc = dshape.n_local()
        bk = torch.as_tensor(w["b"][rank * nloc:(rank + 1) * nloc])
        kw = dict(shift=1.0, tol=cfg["tol"], backend="cuda")
        for method, bb, extra in (("pcg", bk[:, 0], dict(maxiter=250)),
                                  ("gmres", bk[:, 0],
                                   dict(maxiter=100, restart=20)),
                                  ("block_cg", bk, dict(maxiter=250))):
            sol = psd.make_dist_krylov(dshape, comm, method, **kw,
                                       **extra)(d, bb)
            res[(geom, method)] = dict(
                iters=sol.iters.numpy(), x=sol.x.numpy(),
                converged=bool(sol.converged), status=sol.status.numpy())
        seg = psd.make_dist_krylov_segment(dshape, comm, shift=1.0,
                                           tol=cfg["tol"], steps=7,
                                           maxiter=250, backend="cuda")
        state = seg["init"](d, bk[:, 0])
        while True:                  # until a segment makes no progress
            k = int(state.k)
            state = seg["segment"](d, bk[:, 0], state)
            if int(state.k) == k:
                break
        true, rec = seg["residual"](d, bk[:, 0], state)
        res[(geom, "segment")] = dict(k=int(state.k), x=state.x.numpy(),
                                      true=float(true), rec=float(rec))
        # one CG iteration's bytes on I + A against krylov_comm_bytes
        apply_a = psd._operator(dshape, comm, "halo-plan", 1.0, "auto",
                                "cuda", 0)(d)
        st = pk.pcg_init(apply_a, bk[:, 0], comm=comm)
        comm.reset_counts()
        pk._pcg_step(apply_a, pk._identity, st.x, st.r, st.p, st.rz,
                     comm=comm)
        res[(geom, "bytes")] = (comm.recv_bytes,
                                psd.krylov_comm_bytes(dshape, 1))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _run_groups(ps, work: dict, tmp) -> dict:
    """Spawn a group of ``p`` ranks for every ``p`` in ``ps``, all at once
    (each with its own rendezvous), join each rank within the timeout, and
    return the gathered results ``{p: {key: [per-rank value]}}``."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = {}
    for p in ps:
        (tmp / f"p{p}").mkdir()
        init = f"file://{tmp / f'p{p}' / 'rendezvous'}"
        procs[p] = [ctx.Process(target=_rank_main, args=(
            r, p, init, str(tmp / f"p{p}"), work)) for r in range(p)]
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
        ranks = [torch.load(tmp / f"p{p}" / f"rank{r}.pt",
                            weights_only=False) for r in range(p)]
        out[p] = {k: [r[k] for r in ranks] for k in ranks[0]}
    return out


# ---------------------------------------------------------------------------
# fixtures: the reference's problem, solves and operators; the groups
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_prob():
    """The reference's n = 16 problem and its partitions at p = 2, 4, 8
    (``build_dist_problem`` needs no mesh)."""
    pytest.importorskip("jax")
    from repro.apps import fractional as rf
    prob = rf.FractionalProblem(N, h2_tol=SOLVE["h2_tol"]).build()
    return prob, {p: rf.build_dist_problem(prob, p) for p in P_ALL}


@pytest.fixture(scope="module")
def port_prob(ref_prob):
    """The reference's problem carried to the port bitwise."""
    from test_torch_structure import jax_data_to_numpy
    prob, _ = ref_prob
    return dict(
        shape=ts.H2Shape(**dataclasses.asdict(prob["shape"])),
        data=ts.data_from_numpy(jax_data_to_numpy(prob["data"]),
                                device="cpu"),
        perm=np.asarray(prob["perm"]), unperm=np.asarray(prob["unperm"]),
        d_diag=torch.as_tensor(np.asarray(prob["d_diag"])),
        kappa=torch.as_tensor(np.asarray(prob["kappa"])),
        gamma=prob["gamma"], h=prob["h"], n=prob["n"])


@pytest.fixture(scope="module")
def ref_solve():
    pytest.importorskip("jax")
    from repro.apps import fractional as rf
    return rf.solve(N, **SOLVE), pf.dense_reference_solution(N)


@pytest.fixture(scope="module")
def krylov_ref():
    """``test_torch_dist.py``'s two operators (N = 1024) and the
    reference's single-device pcg, gmres and block_cg on ``I + A``."""
    import jax
    import jax.numpy as jnp
    from repro.core.clustering import regular_grid_points
    from repro.core.construction import construct_h2
    from repro.core.kernels_fn import exponential_kernel
    from repro.core.matvec import h2_matvec
    from repro.solvers import block_cg, gmres, pcg
    from test_torch_structure import jax_data_to_numpy

    n1 = 1024
    built = {
        "uniform2d": construct_h2(regular_grid_points(32, 2),
                                  exponential_kernel(0.1), leaf_size=16,
                                  cheb_p=4, eta=0.9),
        "graded1d": construct_h2((((np.arange(n1) + 0.5) / n1) ** 8)[:, None],
                                 exponential_kernel(0.2), leaf_size=8,
                                 cheb_p=6, eta=0.9)}
    rng = np.random.default_rng(1)
    out = {}
    for geom, (shape, data, _, _) in built.items():
        tol = KRYLOV[geom]["tol"]
        b = rng.standard_normal((shape.n, NV)).astype(np.float32)

        def apply_ref(x, shape=shape, data=data):
            xm = x if x.ndim == 2 else x[:, None]
            y = h2_matvec(shape, data, xm)
            return x + (y if x.ndim == 2 else y[:, 0])

        b1 = jnp.asarray(b[:, 0])
        ref = {
            "pcg": jax.jit(lambda r: pcg(apply_ref, r, tol=tol,
                                         maxiter=250))(b1),
            "gmres": jax.jit(lambda r: gmres(apply_ref, r, m=20, tol=tol,
                                             maxiter=100))(b1),
            "block_cg": jax.jit(lambda r: block_cg(
                apply_ref, r, tol=tol, maxiter=250))(jnp.asarray(b))}
        out[geom] = dict(shape=dataclasses.asdict(shape),
                         data=jax_data_to_numpy(data), b=b,
                         ref={k: (np.asarray(v.iters), np.asarray(v.x),
                                  bool(v.converged))
                              for k, v in ref.items()})
    return out


@pytest.fixture(scope="module")
def groups(krylov_ref, tmp_path_factory):
    """Results of the spawned groups, ``{p: {key: [per rank]}}``."""
    work = {"mg": _mg_inputs(N, 7), "gathered": _mg_inputs(8, 8),
            "krylov": {g: {k: v for k, v in w.items() if k != "ref"}
                       for g, w in krylov_ref.items()}}
    return _run_groups(P_ALL, work, tmp_path_factory.mktemp("gloo"))


def _port_build(port_prob, p):
    return pf.build_dist_problem(port_prob, p, device="cpu")


# ---------------------------------------------------------------------------
# host plans and the comm models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["perm", "unperm", "random"])
@pytest.mark.parametrize("p", P_ALL)
def test_transpose_plan_matches_reference(ref_prob, p, which):
    """``(cap, send_idx, take_idx)`` equal bitwise (a random gather with
    repeated rows too)."""
    from repro.core.halo import build_transpose_plan as ref_plan
    prob, _ = ref_prob
    g = np.random.default_rng(p).integers(0, N * N, N * N) \
        if which == "random" else np.asarray(prob[which])
    cap, send, take = th.build_transpose_plan(g, p)
    rcap, rsend, rtake = ref_plan(g, p)
    assert cap == rcap
    for got, want in ((send, rsend), (take, rtake)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    # the plan realizes the gather: every rank's landed buffer, taken
    x = np.random.default_rng(0).standard_normal(N * N)
    nloc = N * N // p
    lanes = np.stack([x[s * nloc:(s + 1) * nloc][send[s * p + r]]
                      for r in range(p) for s in range(p)])
    for r in range(p):
        landed = lanes[r * p:(r + 1) * p].reshape(-1)
        assert np.array_equal(landed[take[r * nloc:(r + 1) * nloc]],
                              x[g[r * nloc:(r + 1) * nloc]])


@pytest.mark.parametrize("p", (1,) + P_ALL)
def test_build_grid_mg_matches_reference(ref_prob, p):
    """GridMG equal; every level array and the deep-halo strips ``hc``
    equal bitwise."""
    from repro.solvers.mg import build_grid_mg as ref_build
    prob, _ = ref_prob
    args = (prob["kappa"], np.asarray(prob["d_diag"]).reshape(N, N),
            prob["gamma"], prob["h"], N)
    rmg, rarr = ref_build(*args, p=p)
    mg, arr = pmg.build_grid_mg(*args, p=p, device="cpu")
    assert dataclasses.asdict(mg) == dataclasses.asdict(rmg)
    for field in pmg.FIELDS + ("hc",):
        got, want = getattr(arr, field), getattr(rarr, field)
        assert len(got) == len(want), field
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), field
    assert len(arr.hc) == (mg.n_sharded if p > 1 else 0)


@pytest.mark.parametrize("p", P_ALL)
def test_comm_models_match_reference(ref_prob, port_prob, p):
    """Every byte and flop model equal to the reference's, each package on
    its own ``build_dist_problem`` of the same operator."""
    from repro.apps import fractional as rf
    from repro.core import dist as rdist
    from repro.solvers import mg as rmgm
    from repro.solvers.distributed import krylov_comm_bytes as ref_kcb
    rshape, rmg, rargs, _ = ref_prob[1][p]
    dshape, mg, args = _port_build(port_prob, p)
    assert dataclasses.asdict(dshape) == dataclasses.asdict(rshape)
    assert dataclasses.asdict(mg) == dataclasses.asdict(rmg)
    tcaps = (args[1]["tin_send"].shape[1], args[1]["tout_send"].shape[1])
    assert tcaps == (rargs[1]["tin_send"].shape[1],
                     rargs[1]["tout_send"].shape[1])
    for key in ("perm", "unperm", "tin_send", "tin_take", "tout_send",
                "tout_take"):
        assert np.array_equal(args[1][key].numpy(),
                              np.asarray(rargs[1][key])), key
    for fused, bf16 in ((False, False), (True, False), (True, True)):
        assert pmg.mg_halo_bytes(mg, fused=fused, bf16=bf16) == \
            rmgm.mg_halo_bytes(rmg, fused=fused, bf16=bf16)
    for nv in (1, 4):
        assert pmg.solver_hide_flops(mg, nv) == \
            rmgm.solver_hide_flops(rmg, nv)
    assert pmg.solver_hide_flops(None) == 0
    for mode in td.COMMS:
        for nv in (1, 4):
            assert psd.krylov_comm_bytes(dshape, nv, mode) == \
                ref_kcb(rshape, nv, mode)
        for fused in (None, False, True):
            for caps in (None, tcaps):
                assert pf.dist_solve_comm_bytes(
                    dshape, mg, mode, tcaps=caps, fused=fused) == \
                    rf.dist_solve_comm_bytes(rshape, rmg, mode, tcaps=caps,
                                             fused=fused), (mode, fused)
    assert rdist.matvec_comm_bytes(rshape, 1) == td.matvec_comm_bytes(
        dshape, 1)


def test_mg_local_shard_views(port_prob):
    dshape, mg, (_, aux, mga) = _port_build(port_prob, 4)
    _, laux, loc = pf.local_args(dshape, mg, (_, aux, mga), 2)
    rows = N // 4
    assert loc.ke[0].shape == (rows, N)
    assert loc.ke[0].data_ptr() == mga.ke[0][2 * rows].data_ptr()
    assert loc.hc[0].shape == (rows + 2 * mg.nu, 6, N)
    tail = len(mg.levels) - 1
    assert not mg.sharded(tail) and loc.ke[tail] is mga.ke[tail]
    assert laux["tin_send"].shape == (4, aux["tin_send"].shape[1])


def test_graph_with_collectives_raises():
    """A segment with collectives is never captured: ``graph=True``
    raises instead of running eagerly."""
    class OneRank:
        p, rank = 1, 0

        def psum(self, t):
            return t

    a = torch.eye(4) * 2.0
    b = torch.ones(4)
    with pytest.raises(ValueError, match="collectives"):
        pk.pcg(lambda x: a @ x, b, graph=True, comm=OneRank())
    res = pk.pcg(lambda x: a @ x, b, comm=OneRank())
    assert bool(res.converged) and torch.allclose(res.x, b / 2)


# ---------------------------------------------------------------------------
# the spawned groups
# ---------------------------------------------------------------------------

def _gathered(res, key, p) -> np.ndarray:
    return np.concatenate([res[key][r]["x"].reshape(-1)
                           for r in range(p)]).reshape(N, N)


def _agree(res, key, p) -> dict:
    """The rank-replicated results: equal bits on every rank."""
    recs = res[key]
    for rec in recs[1:]:
        for f in ("iters", "status", "relres"):
            assert rec[f] == recs[0][f], (key, f)
        assert np.array_equal(rec["hist"], recs[0]["hist"], equal_nan=True)
    return recs[0]


@pytest.mark.parametrize("p", P_FULL)
def test_solve_distributed_matches_reference(groups, ref_solve, p):
    ref, dense = ref_solve
    res = groups[p]
    rec = _agree(res, "solve_distributed", p)
    assert rec["fused"] and rec["status"] == 0
    assert rec["iters"] == ref["iters"], (rec["iters"], ref["iters"])
    u = _gathered(res, "solve_distributed", p)
    assert _rel(u, ref["u"]) < 1e-5
    assert _rel(u, dense) < 2e-2


@pytest.mark.parametrize("cfg", FP32, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
@pytest.mark.parametrize("p", P_FULL)
def test_dist_solve_modes_match_reference(groups, ref_solve, p, cfg):
    ref, dense = ref_solve
    res = groups[p]
    rec = _agree(res, cfg, p)
    assert rec["status"] == 0
    assert rec["iters"] == ref["iters"], (rec["iters"], ref["iters"])
    u = _gathered(res, cfg, p)
    assert _rel(u, ref["u"]) < 1e-5
    assert _rel(u, dense) < 2e-2


@pytest.mark.parametrize("cfg", BF16, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
@pytest.mark.parametrize("p", P_FULL)
def test_dist_solve_bf16(groups, ref_solve, p, cfg):
    ref, _ = ref_solve
    rec = _agree(groups[p], cfg, p)
    assert rec["status"] == 0
    assert abs(rec["iters"] - ref["iters"]) <= 5
    tol = 1e-3 if cfg[0].startswith("halo-plan") else 2e-2
    assert _rel(_gathered(groups[p], cfg, p), ref["u"]) < tol


@pytest.mark.parametrize("cfg", FP32 + BF16,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
@pytest.mark.parametrize("p", P_FULL)
def test_counted_bytes_per_iteration(groups, p, cfg):
    """Each rank's bytes received in one PCG iteration, as ``Comm``
    counted them, equal the model."""
    for rec in groups[p][cfg]:
        assert rec["bytes"] == rec["model"], (rec["bytes"], rec["model"])


@pytest.mark.parametrize("p", P_ALL)
def test_sharded_precond(groups, p):
    """Fused (deep-halo) and unfused V-cycles bitwise equal, both within
    1e-6 of the p = 1 V-cycle."""
    kappa, dd, r = _mg_inputs(N, 7)
    mg1, a1 = pmg.build_grid_mg(kappa, dd, 2.0, 2.0 / N, N, device="cpu")
    want = pmg.mg_precond_local(mg1, a1, torch.as_tensor(r)).numpy()
    res = groups[p]
    unfused = np.concatenate(res[("precond", False)])
    fused = np.concatenate(res[("precond", True)])
    assert np.array_equal(fused, unfused)
    assert _rel(unfused, want) < 1e-6


def test_gathered_precond(groups):
    """n = 8 over p = 8 ranks: too coarse to shard, so the V-cycle runs
    gathered on every rank; within 1e-6 of p = 1."""
    kappa, dd, r = _mg_inputs(8, 8)
    mg1, a1 = pmg.build_grid_mg(kappa, dd, 2.0, 0.25, 8, device="cpu")
    want = pmg.mg_precond_local(mg1, a1, torch.as_tensor(r)).numpy()
    res = groups[8]
    assert res["gathered_n_sharded"] == [0] * 8
    assert _rel(np.concatenate(res["gathered"]), want) < 1e-6


@pytest.mark.parametrize("p", P_ALL)
def test_psum_bitwise_on_every_rank(groups, p):
    """Every rank holds the same bits: the partials summed in rank
    order."""
    parts = [torch.randn(5, generator=torch.Generator().manual_seed(100 + r))
             * 10.0 ** r for r in range(p)]
    want = parts[0]
    for part in parts[1:]:
        want = want + part
    for g in groups[p]["psum"]:
        assert np.array_equal(g, want.numpy())


@pytest.mark.parametrize("method", ["pcg", "gmres", "block_cg"])
@pytest.mark.parametrize("geom", sorted(KRYLOV))
@pytest.mark.parametrize("p", P_FULL)
def test_dist_krylov_matches_reference(groups, krylov_ref, p, geom, method):
    cfg = KRYLOV[geom]
    iters_ref, x_ref, conv_ref = krylov_ref[geom]["ref"][method]
    assert conv_ref
    recs = groups[p][(geom, method)]
    for rec in recs:
        assert rec["converged"] and (rec["status"] == 0).all()
        assert np.array_equal(rec["iters"], recs[0]["iters"])
    slack = cfg["slack"]
    assert np.abs(recs[0]["iters"] - iters_ref).max() <= slack, \
        (recs[0]["iters"], iters_ref)
    x = np.concatenate([rec["x"] for rec in recs])
    assert _rel(x, x_ref) < cfg["xerr"]


@pytest.mark.parametrize("geom", sorted(KRYLOV))
@pytest.mark.parametrize("p", P_FULL)
def test_dist_krylov_segment_matches_monolithic(groups, p, geom):
    """Segments of 7 iterations take the monolithic pcg's iterations and
    land on its iterate; the residual tripwire agrees with the
    recurrence."""
    res = groups[p]
    mono = res[(geom, "pcg")]
    for seg, whole in zip(res[(geom, "segment")], mono):
        assert seg["k"] == int(whole["iters"])
        assert np.array_equal(seg["x"], whole["x"])
        assert seg["rec"] <= KRYLOV[geom]["tol"]
        assert seg["true"] <= 10 * KRYLOV[geom]["tol"]


@pytest.mark.parametrize("geom", sorted(KRYLOV))
@pytest.mark.parametrize("p", P_FULL)
def test_krylov_bytes_per_iteration(groups, p, geom):
    for got, model in groups[p][(geom, "bytes")]:
        assert got == model


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 64])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_cuda_transpose_pack_matches_index_select(cuda, p, extra):
    """Every rank's transposition lanes (and the stencil-halo lanes)
    packed by ``halo_pack`` in one launch equal the ``index_select``
    route bitwise."""
    from repro_torch.kernels import halo_pack as khp
    from repro_torch.kernels import ops
    n = 4096
    g = np.random.default_rng(p).permutation(n)
    _, send, _ = th.build_transpose_plan(g, p)
    nloc = n // p
    x = torch.randn(n, device=cuda)
    ex = torch.randn(p, extra, device=cuda) if extra else None
    for s in range(p):
        idx = torch.as_tensor(send[s * p:(s + 1) * p], device=cuda)
        pack = th.transpose_pack(idx, extra)
        srcs = [x[s * nloc:(s + 1) * nloc]] + ([ex] if extra else [])
        got = torch.full((p * (idx.shape[1] + extra),), float("nan"),
                         device=cuda)
        want = got.clone()
        before = khp.LAUNCHES
        ops.halo_pack_segments(pack, srcs, got, "cuda")
        assert khp.LAUNCHES == before + 1
        ops.halo_pack_segments(pack, srcs, want, "torch")
        torch.cuda.synchronize()
        assert torch.equal(got, want) and not got.isnan().any()
