"""PyTorch port: the observability layer and the cost models
(``repro_torch.obs``, ``repro_torch.perf``) against the reference's
``repro.obs``/``repro.perf``.

The load-bearing guarantee, the port's counterpart of the reference's
byte-equal jaxprs: ``obs.trace.phase`` is on by default on every hot path,
and with tracing on and off a function dispatches the same sequence of
ATen operations (recorded by a ``TorchDispatchMode``; the only difference
is ``record_function``'s ``profiler::`` marks, dispatched only while a
profiler records) and gives bitwise-equal results -- for the HGEMV, a PCG segment of ``solve``'s solver,
``compress`` and ``construct_h2`` here, for rank 0 of the distributed
solve in ``tests/test_torch_profile_solve.py``.  While disabled, ``phase``
records nothing.  The span totals count every phase entered, from every
thread, with its host seconds; ``construct_h2`` enters each
``construct/*`` stage once, and ``compress(tol=...)`` one
``compress/rank-pick`` per device-to-host read of its rank pick and one
``compress/remarshal`` per regathering. Also: the lazy ``obs`` attributes,
the timers' env threading (as ``tests/test_obs.py``), ``IterationTimer``,
``wire_bytes``, ``PhaseRecord`` and ``records_to_json`` equal to the
reference's on the same inputs, ``perf.op_cost``'s matrix-product flops
equal to the reference's ``dot_general`` flops for ``h2_matvec`` (nv 1 and
4) and the fixed-rank ``compress`` at N = 256 (totals within the stated
bounds), and ``phase_comm_model`` equal to the reference's key by key,
summing to ``dist_solve_comm_bytes``, for every comm mode at n = 16, p in
{2, 4, 8}.

JAX is imported inside fixtures and tests only.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.core import structure as ts
from repro_torch.obs import trace
from repro_torch.obs.timers import (IterationTimer, Stage, interleaved_times,
                                    median_ratio, run_stages, time_fn,
                                    time_stages)

torch.set_num_threads(2)

N_DIST = 16
P_ALL = (2, 4, 8)


@pytest.fixture(autouse=True)
def _tracing_restored():
    yield
    trace.set_enabled(True)


@pytest.fixture(scope="module")
def small_h2():
    """The reference's N = 256 operator (leaf 16, Chebyshev 4) and the
    port's bitwise copy."""
    pytest.importorskip("jax")
    from repro.core.clustering import regular_grid_points
    from repro.core.construction import construct_h2
    from repro.core.kernels_fn import exponential_kernel
    from test_torch_structure import jax_data_to_numpy

    shape, data, _, _ = construct_h2(regular_grid_points(16, 2),
                                     exponential_kernel(0.1), leaf_size=16,
                                     cheb_p=4, eta=0.9)
    pshape = ts.H2Shape(**dataclasses.asdict(shape))
    pdata = ts.data_from_numpy(jax_data_to_numpy(data), device="cpu")
    return shape, data, pshape, pdata


class _Ops(TorchDispatchMode):
    """Every dispatched operation but the profiler's marks, in order."""

    def __init__(self):
        super().__init__()
        self.ops, self.marks = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "profiler":
            self.marks += 1
        else:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        return _flat([getattr(out, f.name) for f in dataclasses.fields(out)])
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return []


def _neutral(fn):
    """Run ``fn`` with tracing on and off under a profiler (which makes
    every phase open its range), and with tracing on and no profiler (no
    range, span totals only): the same ops, the same bits."""
    res = {}
    for flag, profiled in ((True, True), (False, True), (True, False)):
        trace.set_enabled(flag)
        trace.reset_span_totals()
        rec = _Ops()
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) if profiled
              else contextlib.nullcontext()), rec:
            out = fn()
        res[flag, profiled] = (rec, _flat(out), trace.span_totals())
    on, off, bare = res[True, True], res[False, True], res[True, False]
    assert on[0].ops == off[0].ops == bare[0].ops
    # phases were on (their ranges opened only under the profiler), then off
    assert on[0].marks > 0 and off[0].marks == 0 and bare[0].marks == 0
    assert on[2] and not off[2] and \
        {k: c for k, (c, _) in bare[2].items()} == \
        {k: c for k, (c, _) in on[2].items()}
    assert len(on[1]) == len(off[1]) == len(bare[1]) > 0
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(on[1], off[1], bare[1]))
    return on[0]


# ---------------------------------------------------------------------------
# the switches and the registry
# ---------------------------------------------------------------------------

def test_obs_exports_and_lazy_modules():
    for name in ("phase", "annotate", "enabled", "set_enabled",
                 "PHASES_SEEN", "span_totals", "reset_span_totals"):
        assert name in obs.__all__ and hasattr(obs, name)
    for name in ("timers", "metrics", "export", "profile_solve"):
        assert getattr(obs, name).__name__ == f"repro_torch.obs.{name}"
    with pytest.raises(AttributeError):
        obs.no_such_module


def test_env_switch_disables():
    code = ("from repro_torch.obs import trace; "
            "print(trace.enabled())")
    env = dict(os.environ)
    for value, want in (("1", "False"), ("0", "True")):
        env["REPRO_OBS_DISABLE"] = value
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == want


def test_disabled_phase_registers_nothing():
    trace.set_enabled(False)
    before = set(trace.PHASES_SEEN)
    totals = trace.span_totals()
    with trace.phase_times() as pt:
        with trace.phase("obs-test/never-on"):
            pass
    assert "obs-test/never-on" not in trace.PHASES_SEEN
    assert trace.PHASES_SEEN == before
    assert trace.span_totals() == totals
    assert dict(pt) == {}
    trace.set_enabled(True)
    with trace.phase_times() as pt:
        with trace.phase("obs-test/on"):
            pass
    assert "obs-test/on" in trace.PHASES_SEEN and "obs-test/on" in pt
    assert trace.span_totals()["obs-test/on"][0] == \
        totals.get("obs-test/on", (0, 0.0))[0] + 1


def test_span_totals_count_and_time_each_phase():
    """One count a phase entered and its host seconds, nested phases each
    in full; ``reset_span_totals`` clears the table and ``PHASES_SEEN``
    with it, and a phase open across a reset is dropped."""
    trace.reset_span_totals()
    assert trace.span_totals() == {} and not trace.PHASES_SEEN
    for _ in range(3):
        with trace.phase("obs-test/outer"):
            with trace.phase("obs-test/inner"):
                time.sleep(0.002)
    with pytest.raises(ValueError):
        with trace.phase("obs-test/raises"):
            raise ValueError("the span still closes")
    got = trace.span_totals()
    assert set(got) == set(trace.PHASES_SEEN) == {
        "obs-test/outer", "obs-test/inner", "obs-test/raises"}
    (n_out, s_out), (n_in, s_in) = got["obs-test/outer"], \
        got["obs-test/inner"]
    assert n_out == n_in == 3 and got["obs-test/raises"][0] == 1
    assert s_out >= s_in >= 3 * 0.002
    got["obs-test/outer"] = (0, 0.0)            # a copy, not the table
    assert trace.span_totals()["obs-test/outer"][0] == 3
    with trace.phase("obs-test/across-reset"):
        trace.reset_span_totals()
    assert trace.span_totals() == {} and not trace.PHASES_SEEN


def test_phase_range_opens_only_under_a_profiler():
    """A profiler's trace holds the phase's range; without a profiler the
    phase dispatches no mark and still counts in the span totals."""
    trace.reset_span_totals()
    rec = _Ops()
    with rec, trace.phase("obs-test/bare"):
        torch.ones(2).sum()
    assert rec.marks == 0 and rec.ops
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.phase("obs-test/profiled"):
            torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert "obs-test/profiled" in names and "obs-test/bare" not in names
    assert {k: c for k, (c, _) in trace.span_totals().items()} == {
        "obs-test/bare": 1, "obs-test/profiled": 1}


def test_span_totals_lose_no_count_across_threads():
    """16 threads entering phases at a short switch interval: every entry
    is counted."""
    trace.reset_span_totals()
    n_threads, n_each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with trace.phase("obs-test/threads"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert trace.span_totals()["obs-test/threads"][0] == n_threads * n_each


def test_annotate_wraps_every_call():
    calls = []

    @trace.annotate("obs-test/annotated")
    def f(x):
        calls.append(x)
        return 2 * x

    assert f(3) == 6 and f.__name__ == "f"
    assert "obs-test/annotated" in trace.PHASES_SEEN
    trace.set_enabled(False)
    trace.reset_span_totals()
    assert f(4) == 8 and calls == [3, 4]
    assert "obs-test/annotated" not in trace.PHASES_SEEN


def test_phases_registered(small_h2):
    from repro_torch.core.matvec import h2_matvec
    *_, pshape, pdata = small_h2
    trace.reset_span_totals()
    h2_matvec(pshape, pdata, torch.ones(pshape.n, 1), backend="torch")
    assert {"hgemv/upsweep", "hgemv/coupling-gemm", "hgemv/downsweep",
            "hgemv/dense"} <= trace.PHASES_SEEN


CONSTRUCT_SPANS = ("construct/cluster-tree", "construct/block-structure",
                   "construct/bases", "construct/coupling",
                   "construct/dense", "construct/marshal")


def _port_construct():
    """The port's own Chebyshev construction at N = 256 (leaf 16, p = 4)
    on the CPU."""
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    return construct_h2(regular_grid_points(16, 2), exponential_kernel(0.1),
                        leaf_size=16, cheb_p=4, eta=0.9, device="cpu")


def test_construct_enters_each_stage_once():
    trace.reset_span_totals()
    _port_construct()
    got = trace.span_totals()
    assert set(got) == set(CONSTRUCT_SPANS)
    for name in CONSTRUCT_SPANS:
        count, seconds = got[name]
        assert count == 1 and seconds > 0, name


def test_compress_spans_its_round_trips_and_regatherings(small_h2):
    """``compress(tol=1e-3)`` at depth 4: one ``compress/rank-pick`` per
    device-to-host read (the scale, then two counts at each of the 5
    levels) and one ``compress/remarshal`` after each of the
    orthogonalization and the truncation."""
    from repro_torch.core.compression import compress
    *_, pshape, pdata = small_h2
    assert pshape.depth == 4
    trace.reset_span_totals()
    compress(pshape, pdata, tol=1e-3)
    got = trace.span_totals()
    assert got["compress/rank-pick"][0] == 1 + 2 * (pshape.depth + 1)
    assert got["compress/remarshal"][0] == 2


# ---------------------------------------------------------------------------
# neutrality: the same ops and the same bits with tracing on and off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_neutral_matvec(small_h2, backend):
    from repro_torch.core.matvec import h2_matvec
    *_, pshape, pdata = small_h2
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (pshape.n, 4)).astype(np.float32))
    _neutral(lambda: h2_matvec(pshape, pdata, x, backend=backend))


def test_neutral_pcg_segment():
    """One PCG segment of ``solve``'s solver (the n = 16 fractional
    operator and its V-cycle), eager."""
    from repro_torch.apps import fractional as pf
    from repro_torch.solvers import krylov as pk
    prob = pf.FractionalProblem(16, device="cpu", backend="torch").build()
    apply_a = pf.make_operator(prob, backend="torch")
    pre = pf.make_preconditioner(prob, device="cpu")
    b = torch.ones(16 * 16) * prob["h"] ** 2
    st = pk.pcg_init(apply_a, b, pre)
    rec = _neutral(lambda: pk.pcg_segment(apply_a, b, st, pre, steps=5,
                                          graph=False))
    assert any("bmm" in op for op in rec.ops)


def test_neutral_compress(small_h2):
    from repro_torch.core.compression import compress
    *_, pshape, pdata = small_h2
    _neutral(lambda: compress(pshape, pdata, tol=1e-3, backend="torch")[1]
             .e)


def test_neutral_construct():
    _neutral(lambda: _port_construct()[1])


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

def test_time_fn_and_interleaved():
    x = torch.ones(128)
    assert time_fn(torch.sin, x, reps=3) > 0
    before = []
    acc = interleaved_times({"a": lambda: torch.sin(x),
                             "b": lambda: torch.cos(x)}, reps=4,
                            before=lambda: before.append(1))
    assert sorted(acc) == ["a", "b"] and len(before) == 8
    assert all(len(v) == 4 and min(v) > 0 for v in acc.values())
    assert median_ratio([2.0, 4.0, 8.0], [1.0, 2.0, 4.0]) == 2.0


def test_stage_pipeline_env_threading():
    stages = [
        Stage("double", lambda x: 2.0 * x, ("x",), ("y",)),
        Stage("split", lambda y: (y + 1.0, y - 1.0), ("y",), ("hi", "lo"),
              phase="split-phase"),
        Stage("sum", lambda a, b: a + b, ("hi", "lo"), ("z",)),
    ]
    env = run_stages(stages, {"x": torch.full((8,), 3.0)})
    assert torch.equal(env["z"], torch.full((8,), 12.0))
    assert set(env) == {"x", "y", "hi", "lo", "z"}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        secs = time_stages(stages, env, reps=3)
    assert sorted(secs) == ["double", "split", "sum"]
    assert all(v > 0 for v in secs.values())
    assert stages[1].phase == "split-phase"
    names = {e.name for e in prof.events()}
    assert {"obs.replay/double", "obs.replay/split",
            "obs.replay/sum"} <= names


def test_iteration_timer_stamps_every_call():
    timer = IterationTimer()
    fn = timer.wrap(lambda x: x * 2.0)
    for _ in range(5):
        fn(torch.ones(4))
    iv = timer.intervals()
    assert iv.shape == (4,) and (iv >= 0).all()
    timer.reset()
    assert timer.stamps == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA events and graphs have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_iteration_timer_events_and_capture(cuda):
    """On the card the stamps are CUDA events (one per call); inside a
    CUDA graph capture the timer raises."""
    timer = IterationTimer()
    fn = timer.wrap(lambda x: x * 2.0)
    x = torch.ones(1 << 20, device=cuda)
    for _ in range(3):
        fn(x)
    iv = timer.intervals()
    assert iv.shape == (2,) and (iv >= 0).all()
    assert all(isinstance(s, torch.cuda.Event) for s in timer.stamps)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(g):
            fn(x)


# ---------------------------------------------------------------------------
# metrics against the reference
# ---------------------------------------------------------------------------

BY_KIND = [{"all-gather": 800.0}, {"reduce-scatter": 800.0},
           {"all-reduce": 10.0}, {"collective-permute": 64.0},
           {"all-to-all": 96.0}, {"all-gather": 800.0,
                                  "collective-permute": 100.0},
           {"custom": 5.0}]


@pytest.mark.parametrize("p", [2, 4, 8])
def test_wire_bytes_match_reference(p):
    pytest.importorskip("jax")
    from repro.obs.metrics import wire_bytes as ref_wire
    from repro_torch.obs.metrics import _WIRE_FACTOR, wire_bytes
    from repro.obs.metrics import _WIRE_FACTOR as REF_FACTOR
    assert sorted(_WIRE_FACTOR) == sorted(REF_FACTOR)
    for by_kind in BY_KIND:
        assert wire_bytes(by_kind, p) == ref_wire(by_kind, p), by_kind


def test_phase_record_and_json_match_reference(tmp_path):
    pytest.importorskip("jax")
    from repro.obs import metrics as rm
    from repro_torch.obs import metrics as pm
    fields = dict(phase="test/gemm", us=12.5, model_flops=8192.0,
                  model_bytes=3584.0, model_comm_bytes=0,
                  measured_comm_bytes=64.0,
                  measured_comm_by_kind={"collective-permute": 64.0},
                  extra={"comm": "halo-plan", "us_loop_cum": 30.0})
    mine, ref = pm.PhaseRecord(**fields), rm.PhaseRecord(**fields)
    assert mine.to_dict() == ref.to_dict()
    assert pm.PhaseRecord("x").to_dict() == rm.PhaseRecord("x").to_dict()
    pm.records_to_json([mine], str(tmp_path / "port.json"), bench="unit")
    rm.records_to_json([ref], str(tmp_path / "ref.json"), bench="unit")
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()


def test_phase_record_joins_models():
    from repro_torch.obs.metrics import phase_record
    a, b = torch.ones(16, 32), torch.ones(32, 8)
    rec = phase_record("test/gemm", us=12.5, fn=lambda x, y: x @ y,
                       args=(a, b), model_comm_bytes=0, p=1, comm=None,
                       mode="none")
    assert rec.model_flops == 2 * 16 * 32 * 8
    assert rec.model_bytes == (16 * 32 + 32 * 8 + 16 * 8) * 4
    d = rec.to_dict()
    assert d["mode"] == "none" and "extra" not in d and d["us"] == 12.5


# ---------------------------------------------------------------------------
# op_cost against jaxpr_cost
# ---------------------------------------------------------------------------

def _ref_dot_flops(jaxpr) -> int:
    """The reference's ``dot_general`` flops, every sub-jaxpr included."""
    from repro.perf.jaxpr_cost import _dot_flops
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            total += _dot_flops(eqn)
        for prm in eqn.params.values():
            for sub in (prm if isinstance(prm, (tuple, list)) else [prm]):
                sub = getattr(sub, "jaxpr", None)
                if sub is not None:
                    total += _ref_dot_flops(getattr(sub, "jaxpr", sub))
    return total


# flops outside the products: the reference charges its reshapes and
# selects nothing and its QR/SVD one flop per output element, as the port
# does; they differ by the elementwise work each lowering adds (the
# reference's pair sums are adds of slices, the port's ``sum`` over a pair
# axis; the port's QR sign fix multiplies): within 5 % of the total
FLOPS_RTOL = 0.05
# bytes are unfused bounds that differ by design: the reference charges
# every reshape/broadcast/transpose its operand and result bytes, and the
# port's views cost nothing -- within a factor of 2
BYTES_FACTOR = 2.0


@pytest.mark.parametrize("nv", [1, 4])
def test_op_cost_matvec_matches_reference(small_h2, nv):
    import jax
    import jax.numpy as jnp
    from repro.core.matvec import h2_matvec as ref_mv
    from repro.perf.jaxpr_cost import count_jaxpr
    from repro_torch.core.matvec import h2_matvec
    from repro_torch.perf.op_cost import analyze, count_ops, matmul_flops
    shape, data, pshape, pdata = small_h2
    x = np.random.default_rng(nv).standard_normal(
        (shape.n, nv)).astype(np.float32)
    jp = jax.make_jaxpr(lambda d, xx: ref_mv(shape, d, xx))(
        data, jnp.asarray(x))
    xt = torch.as_tensor(x)
    fn = lambda v: h2_matvec(pshape, pdata, v, backend="torch")  # noqa
    assert matmul_flops(count_ops(fn, xt)) == _ref_dot_flops(jp.jaxpr)
    mine, ref = analyze(fn, xt), count_jaxpr(jp.jaxpr)
    assert abs(mine["flops"] - ref["flops"]) <= FLOPS_RTOL * ref["flops"]
    assert ref["bytes"] / BYTES_FACTOR <= mine["bytes"] <= \
        ref["bytes"] * BYTES_FACTOR


def test_op_cost_compress_matches_reference(small_h2):
    """The fixed-rank compress (orthogonalize, weights, truncate, project)
    on the symmetric operator.  The reference's program is traced with its
    concrete ``aliased`` flag, as ``compress`` computes it before its jit:
    under an outer trace the two basis trees would be distinct tracers and
    the program would factor both."""
    import jax
    from repro.core.compression import _compress_fixed
    from repro.perf.jaxpr_cost import count_jaxpr
    from repro_torch.core.compression import compress
    from repro_torch.perf.op_cost import analyze, count_ops, matmul_flops
    shape, data, pshape, pdata = small_h2
    target = tuple(max(1, r // 2) for r in shape.ranks)
    aliased = bool(shape.symmetric and data.v_leaf is data.u_leaf)
    jp = jax.make_jaxpr(lambda d: _compress_fixed(
        shape, d, target, "jnp", False, aliased))(data)
    fn = lambda: compress(pshape, pdata, target_ranks=target,  # noqa
                          backend="torch")
    assert matmul_flops(count_ops(fn)) == _ref_dot_flops(jp.jaxpr)
    mine, ref = analyze(fn), count_jaxpr(jp.jaxpr)
    assert abs(mine["flops"] - ref["flops"]) <= FLOPS_RTOL * ref["flops"]
    assert ref["bytes"] / BYTES_FACTOR <= mine["bytes"] <= \
        ref["bytes"] * BYTES_FACTOR


def test_op_cost_refuses_kernel_launches(monkeypatch):
    """A hand-written kernel's work never reaches the dispatcher: a walk
    during which the launch tally moves raises."""
    from repro_torch.kernels import ops
    from repro_torch.perf.op_cost import analyze
    counts = {"batched_gemm": 0}
    monkeypatch.setattr(ops, "launch_counts", lambda: dict(counts))

    def launches():
        counts["batched_gemm"] += 1
        return torch.ones(2) * 2

    with pytest.raises(RuntimeError, match="plain backend"):
        analyze(launches)


def test_op_cost_rules():
    from repro_torch.perf.op_cost import TRANSCENDENTAL_WEIGHT, count_ops
    a = torch.ones(4, 8)
    per = count_ops(lambda x: (torch.exp(x).sum(), torch.sort(x[0]),
                               x.reshape(-1).clone(),
                               torch.bmm(x[None], x.t()[None])), a)
    assert per["aten::exp"]["flops"] == TRANSCENDENTAL_WEIGHT * 32
    assert per["aten::sum"]["flops"] == 32
    assert per["aten::sort"]["flops"] == 4 * 8
    assert per["aten::clone"]["flops"] == 0
    assert per["aten::clone"]["bytes"] == 2 * 32 * 4
    assert per["aten::view"]["bytes"] == 0
    assert per["aten::bmm"]["flops"] == 2 * 4 * 4 * 8


# ---------------------------------------------------------------------------
# phase_comm_model against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_probs():
    """Both packages' ``build_dist_problem`` of the reference's n = 16
    problem at p = 2, 4, 8 (the port's from a bitwise copy)."""
    pytest.importorskip("jax")
    from repro.apps import fractional as rf
    from repro_torch.apps import fractional as pf
    from test_torch_structure import jax_data_to_numpy
    prob = rf.FractionalProblem(N_DIST).build()
    port = dict(
        shape=ts.H2Shape(**dataclasses.asdict(prob["shape"])),
        data=ts.data_from_numpy(jax_data_to_numpy(prob["data"]),
                                device="cpu"),
        perm=np.asarray(prob["perm"]), unperm=np.asarray(prob["unperm"]),
        d_diag=torch.as_tensor(np.asarray(prob["d_diag"])),
        kappa=torch.as_tensor(np.asarray(prob["kappa"])),
        gamma=prob["gamma"], h=prob["h"], n=prob["n"])
    return {p: (rf.build_dist_problem(prob, p),
                pf.build_dist_problem(port, p, device="cpu"))
            for p in P_ALL}


@pytest.mark.parametrize("p", P_ALL)
def test_phase_comm_model_matches_reference(dist_probs, p):
    from repro.obs.profile_solve import PHASE_ORDER as REF_ORDER
    from repro.obs.profile_solve import phase_comm_model as ref_model
    from repro_torch.apps.fractional import dist_solve_comm_bytes
    from repro_torch.core.dist import COMMS
    from repro_torch.obs.profile_solve import PHASE_ORDER, phase_comm_model
    assert PHASE_ORDER == REF_ORDER
    (rshape, rmg, _, _), (dshape, mg, args) = dist_probs[p]
    tcaps = (args[1]["tin_send"].shape[1], args[1]["tout_send"].shape[1])
    for mode in COMMS:
        for fused in (None, False, True):
            for caps in (None, tcaps):
                mine = phase_comm_model(dshape, mg, mode, tcaps=caps,
                                        fused=fused)
                assert mine == ref_model(rshape, rmg, mode, tcaps=caps,
                                         fused=fused), (mode, fused, caps)
                assert list(mine) == list(PHASE_ORDER)
                assert sum(mine.values()) == dist_solve_comm_bytes(
                    dshape, mg, mode, tcaps=caps, fused=fused)
                assert mine["hgemv/exchange"] > 0
