"""PyTorch port: the guard rails (``repro_torch.guard``) and
``solve_with_guards`` against the JAX reference (``repro.guard``) on the
CPU.

The reference's operators (the 16 x 16 grid of ``tests/test_guard.py``:
exponential kernel l = 0.1, leaf 16, Chebyshev 4, eta 0.9) are carried to
the port bitwise (``data_from_numpy``, ``dist_data_from_numpy``), and
both packages are held to each other:

- ``validate_h2``/``validate_dist_h2``: the same verdict and the same
  error strings on healthy and corrupted operators; the orthogonality the
  port computes by the Gram recurrence within 1e-10 (relative) of the
  explicit float64 bases of ``core.reconstruct.check_orthogonal`` and
  within 1e-6 (relative) of the reference's float32 value;
- ``certify_matvec``/``certify_h2``: with the reference's probe block
  injected, ``rel_err`` within 1e-5 relative; with the port's own (Philox)
  probes the same verdicts;
- ``run_with_guards``: the attempt lists and ``GUARD_COUNTERS`` of the
  reference's ladder cases;
- the drills: the reference's description and a failed certificate on
  ``backend="torch"``; a failed certificate on ``backend="cuda"`` (the
  kernels' plain versions on CPU tensors read ``s``, not ``s_mar``), and
  the trap a literal port would fall into: corrupting ``s_mar`` leaves
  that route's product bitwise unchanged;
- the certified sketch construction under the rank-starved drill: with
  the reference's Gaussians and probes injected the same rounds and
  ranks, with the port's own more than one round and a certificate;
- ``solve_with_guards(16)``: the same rung and attempts, the same
  convergence rate (iterations to 1e-6 and 1e-7 within 1), the final
  count within 1 of the port's own 2-thread count (17; the reference's 20
  sits on the float32 floor, see ``tests/test_torch_fractional.py``), u
  within 5e-7; a forced escalation walks the same rungs to the same end,
  the fp64 rung apart (the reference's raises on jax 0.9.0, the port's
  solves).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import guard as rg
from repro.core.clustering import regular_grid_points
from repro.core.construction import construct_h2 as ref_construct
from repro.core.kernels_fn import exponential_kernel as ref_exp
from repro_torch import guard as tg
from repro_torch.core import structure as ts
from repro_torch.core.kernels_fn import exponential_kernel
from repro_torch.core.matvec import h2_matvec
from repro_torch.solvers.krylov import gmres, pcg
from test_torch_structure import jax_data_to_numpy

torch.set_num_threads(2)

KERN = exponential_kernel(0.1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _spd(n, seed, lo=1.0, hi=10.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((q * rng.uniform(lo, hi, n)) @ q.T).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean_counters():
    rg.reset_guard_counters()
    tg.reset_guard_counters()
    yield
    rg.reset_guard_counters()
    tg.reset_guard_counters()


@pytest.fixture(scope="module")
def cheb():
    """The reference's operator of ``tests/test_guard.py`` and its points,
    tree and flat arrays (the port builds its copy per test)."""
    pts = regular_grid_points(16, 2)
    shape, data, tree, _ = ref_construct(pts, ref_exp(0.1), leaf_size=16,
                                         cheb_p=4, eta=0.9,
                                         dtype=jnp.float32)
    return dict(pts=pts, shape=shape, data=data, tree=tree,
                arrays=jax_data_to_numpy(data))


def _port(cheb):
    return (ts.H2Shape(**dataclasses.asdict(cheb["shape"])),
            ts.data_from_numpy(cheb["arrays"], device="cpu"))


def _ref_copy(data):
    """A shallow copy of the reference's operator whose lists the
    reference's drills may rebind."""
    return dataclasses.replace(data, s=list(data.s), s_mar=list(data.s_mar))


def _port_copy(data):
    return dataclasses.replace(data, s=list(data.s), s_mar=list(data.s_mar))


def _ref_probes(mp):
    """Inject the reference's probe block into the port's certificates."""
    from repro_torch.guard import certify as tcert

    def probes(n, k, seed=0, dtype=torch.float32, device="cpu"):
        return torch.as_tensor(np.array(rg.probe_block(n, k, seed)),
                               device=device).to(dtype)
    mp.setattr(tcert, "probe_block", probes)


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

def _corrupt(case, rdata, tdata):
    """Apply one named fault to a reference copy and a port copy alike."""
    if case in ("scale", "nan"):
        assert rg.drill_corrupt_operator(rdata, mode=case) == \
            tg.drill_corrupt_operator(tdata, mode=case, backend="torch")
    elif case == "stale-s":
        lvl = max(range(len(rdata.s)), key=lambda l: rdata.s[l].size)
        rdata.s[lvl] = rdata.s[lvl] * 2.0
        tdata.s[lvl] = tdata.s[lvl] * 2.0
    elif case == "unsorted-rows":
        dr = np.asarray(rdata.d_rows).copy()
        dr[[0, -1]] = dr[[-1, 0]]
        rdata.d_rows = jnp.asarray(dr)
        tdata.d_rows = torch.as_tensor(dr)


@pytest.mark.parametrize("case", ["healthy", "scale", "nan", "stale-s",
                                  "unsorted-rows"])
def test_validate_h2_matches_reference(cheb, case):
    tshape, tdata = _port(cheb)
    rdata, tdata = _ref_copy(cheb["data"]), _port_copy(tdata)
    _corrupt(case, rdata, tdata)
    kw = dict(check_marshal=False, check_orth=False) \
        if case == "unsorted-rows" else {}
    want = rg.validate_h2(cheb["shape"], rdata, **kw)
    got = tg.validate_h2(tshape, tdata, **kw)
    assert got.ok == want.ok
    assert got.errors == want.errors
    assert len(got.warnings) == len(want.warnings)
    if want.orthogonality is None:
        assert got.orthogonality is None
    else:
        assert abs(got.orthogonality - want.orthogonality) <= \
            1e-6 * max(1.0, want.orthogonality)
    if case != "healthy":
        assert not got.ok and "error" in got.summary()


def test_validate_require_orthogonal(cheb):
    tshape, tdata = _port(cheb)
    want = rg.validate_h2(cheb["shape"], cheb["data"],
                          require_orthogonal=True)
    got = tg.validate_h2(tshape, tdata, require_orthogonal=True)
    assert not got.ok and not want.ok
    assert [e.split(" ")[:3] for e in got.errors] == \
        [e.split(" ")[:3] for e in want.errors]


@pytest.mark.parametrize("orthogonalized", [False, True])
def test_gram_orthogonality_matches_explicit_bases(cheb, orthogonalized):
    from repro.core.orthogonalize import orthogonalize
    from repro.core.structure import shape_of
    from repro_torch.core.reconstruct import check_orthogonal as explicit
    rshape, rdata = cheb["shape"], cheb["data"]
    if orthogonalized:
        rdata = orthogonalize(rshape, rdata)
        rshape = shape_of(rdata, rshape.leaf_size)
    tdata = ts.data_from_numpy(jax_data_to_numpy(rdata), device="cpu")
    tshape = ts.H2Shape(**dataclasses.asdict(rshape))
    got = tg.check_orthogonal(tshape, tdata)
    scale = max(1.0, got)
    assert abs(got - explicit(tshape, tdata)) <= 1e-10 * scale
    assert abs(got - rg.check_orthogonal(rshape, rdata)) <= 1e-6 * scale
    assert (got < 1e-4) == orthogonalized


def test_gram_orthogonality_separate_v_tree(cheb):
    """An unaliased V tree is checked on its own (here a scaled copy)."""
    tshape, tdata = _port(cheb)
    lone = dataclasses.replace(tdata, v_leaf=2.0 * tdata.u_leaf,
                               f=[t.clone() for t in tdata.e])
    assert tg.check_orthogonal(tshape, lone) > \
        tg.check_orthogonal(tshape, tdata)


@pytest.mark.parametrize("p", [2, 4])
def test_validate_dist_h2_matches_reference(cheb, p):
    from repro.core import dist as rdist
    from test_torch_dist import _flat_dist
    rshape, rdd = rdist.partition_h2(cheb["shape"], cheb["data"], p)
    tdd = ts.dist_data_from_numpy(_flat_dist(rdd), device="cpu")
    want, got = rg.validate_dist_h2(rshape, rdd), \
        tg.validate_dist_h2(rshape, tdd)
    assert got.ok and want.ok and got.errors == want.errors == []
    # a poisoned slab and an out-of-range plan entry, in both
    s0 = np.asarray(rdd.s_br[-1]).copy()
    s0[0, 0, 0] = np.nan
    col = np.asarray(rdd.pb_col[0]).copy()
    col[0] = 1 << 20
    rbad = dataclasses.replace(rdd, s_br=[*rdd.s_br[:-1], jnp.asarray(s0)],
                               pb_col=[jnp.asarray(col), *rdd.pb_col[1:]])
    tbad = dataclasses.replace(
        tdd, s_br=[*tdd.s_br[:-1], torch.as_tensor(s0)],
        pb_col=[torch.as_tensor(col), *tdd.pb_col[1:]])
    want, got = rg.validate_dist_h2(rshape, rbad), \
        tg.validate_dist_h2(rshape, tbad)
    assert not got.ok and got.errors == want.errors
    assert len(got.errors) == 2


# ---------------------------------------------------------------------------
# certify
# ---------------------------------------------------------------------------

def test_probe_block_deterministic():
    a = tg.probe_block(64, 4, seed=3, device="cpu")
    assert a.shape == (64, 4) and a.dtype == torch.float32
    assert torch.equal(a, tg.probe_block(64, 4, seed=3, device="cpu"))
    assert not torch.equal(a, tg.probe_block(64, 4, seed=4, device="cpu"))


@pytest.mark.parametrize("probes", [4, 16])
def test_certify_matvec_matches_reference(monkeypatch, probes):
    a, e = _spd(48, 1), 1e-1 * _spd(48, 2)
    want = rg.certify_matvec(lambda x: jnp.asarray(a + e) @ x,
                             lambda x: jnp.asarray(a) @ x, 48,
                             probes=probes, tol=1.0)
    ta, te = torch.as_tensor(a), torch.as_tensor(e)
    own = tg.certify_matvec(lambda x: (ta + te) @ x, lambda x: ta @ x, 48,
                            probes=probes, tol=1.0, device="cpu")
    _ref_probes(monkeypatch)
    got = tg.certify_matvec(lambda x: (ta + te) @ x, lambda x: ta @ x, 48,
                            probes=probes, tol=1.0, device="cpu")
    assert abs(got.rel_err - want.rel_err) <= 1e-5 * want.rel_err
    assert got.ok == want.ok == own.ok
    true = float(np.linalg.norm(e) / np.linalg.norm(a))
    assert 0.1 * true < own.rel_err < 10 * true


def test_certify_nan_cannot_certify():
    a = torch.as_tensor(_spd(32, 0))
    bad = a.clone()
    bad[0, 0] = float("nan")
    cert = tg.certify_matvec(lambda x: bad @ x, lambda x: a @ x, 32,
                             probes=4, tol=1e3, device="cpu")
    assert not cert.ok and not np.isfinite(cert.rel_err)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_certify_h2_matches_reference(cheb, monkeypatch, backend):
    tshape, tdata = _port(cheb)
    perm = cheb["tree"].perm
    want = rg.certify_h2(cheb["shape"], cheb["data"],
                         rg.kernel_reference_apply(cheb["pts"], ref_exp(0.1),
                                                   perm, chunk=128),
                         probes=6, tol=1e-2)
    ref = tg.kernel_reference_apply(cheb["pts"], KERN, perm, chunk=128,
                                    device="cpu")
    own = tg.certify_h2(tshape, tdata, ref, probes=6, tol=1e-2,
                        backend=backend)
    _ref_probes(monkeypatch)
    got = tg.certify_h2(tshape, tdata, ref, probes=6, tol=1e-2,
                        backend=backend)
    assert abs(got.rel_err - want.rel_err) <= 1e-5 * want.rel_err
    assert got.ok and want.ok and own.ok


def test_kernel_reference_apply_matches_dense(cheb):
    from repro_torch.core.construction import dense_reference
    perm = cheb["tree"].perm
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (256, 3)).astype(np.float32))
    got = tg.kernel_reference_apply(cheb["pts"], KERN, perm, chunk=100,
                                    device="cpu")(x)
    want = dense_reference(cheb["pts"], KERN, perm).float() @ x
    assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# run_with_guards
# ---------------------------------------------------------------------------

def _raise():
    raise RuntimeError("rung failure")


def _ladders(pkg, solvers):
    """The reference's ladder cases (``tests/test_guard.py``), built on
    ``pkg``'s drills and ``solvers``' pcg/gmres."""
    rpcg, rgmres, arr = solvers
    a24, b24 = arr(_spd(24, 0)), arr(np.ones(24, np.float32))
    a16, b16 = arr(_spd(16, 0)), arr(np.ones(16, np.float32))
    an, bn = pkg.drill_near_singular(lam_min=-0.1, seed=0,
                                     **({"device": "cpu"}
                                        if pkg is tg else {}))
    return {
        "primary": [("primary", lambda: rpcg(lambda x: a24 @ x, b24,
                                             tol=1e-6, maxiter=100)),
                    ("never", _raise)],
        "indefinite": [("pcg", lambda: rpcg(lambda x: an @ x, bn, tol=1e-5,
                                            maxiter=200)),
                       ("gmres", lambda: rgmres(lambda x: an @ x, bn, m=32,
                                                tol=1e-5, maxiter=128))],
        "raising": [("bad", _raise),
                    ("good", lambda: rpcg(lambda x: a16 @ x, b16, tol=1e-6,
                                          maxiter=100))],
        "exhausted": [("pcg", lambda: rpcg(lambda x: an @ x, bn, tol=1e-6,
                                           maxiter=50))],
    }


@pytest.mark.parametrize("case", ["primary", "indefinite", "raising",
                                  "exhausted"])
def test_run_with_guards_matches_reference(case):
    from repro.solvers import gmres as rgmres, pcg as rpcg
    want = rg.run_with_guards(_ladders(rg, (rpcg, rgmres, jnp.asarray))[case])
    got = tg.run_with_guards(_ladders(tg, (pcg, gmres, torch.as_tensor))[case])
    assert (got.ok, got.rung, got.recovered, got.attempts) == \
        (want.ok, want.rung, want.recovered, want.attempts)
    assert dict(tg.GUARD_COUNTERS) == dict(rg.GUARD_COUNTERS)


def test_all_raising_reraises():
    with pytest.raises(RuntimeError, match="rung failure"):
        tg.run_with_guards([("a", _raise), ("b", _raise)])
    assert tg.GUARD_COUNTERS["exhausted"] == 1


def test_fp64_scalars_rung():
    """The fp64 rung: float64 scalars, float32 iterates (the reference's
    ``test_fp64_scalars_rung_traces``, red on jax 0.9.0)."""
    a = torch.as_tensor(_spd(24, 0))
    b = torch.ones(24)
    with tg.fp64_scalars() as sdt:
        assert sdt == torch.float64
        res = pcg(lambda x: a @ x, b, tol=1e-6, maxiter=100,
                  scalar_dtype=sdt)
    assert bool(res.converged) and res.x.dtype == torch.float32
    assert tg.default_accept(res)


def test_default_accept():
    a, b = tg.drill_near_singular(lam_min=-0.1, seed=0, device="cpu")
    assert not tg.default_accept(pcg(lambda x: a @ x, b, tol=1e-6,
                                     maxiter=50))
    assert tg.default_accept(object())


# ---------------------------------------------------------------------------
# drills
# ---------------------------------------------------------------------------

def test_drill_near_singular_matches_reference():
    for lam, seed in ((-0.1, 0), (1e-7, 1)):
        ra, rb = rg.drill_near_singular(lam_min=lam, seed=seed)
        ta, tb = tg.drill_near_singular(lam_min=lam, seed=seed, device="cpu")
        assert np.array_equal(ta.numpy(), np.asarray(ra))
        assert np.array_equal(tb.numpy(), np.asarray(rb))


@pytest.mark.guard
@pytest.mark.parametrize("mode", ["scale", "nan"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_drill_corrupt_operator(cheb, mode, backend):
    """Each backend's drill corrupts the buffer that backend's HGEMV reads:
    validate and certify both catch it there; the healthy operator the
    shallow copy came from is untouched."""
    tshape, healthy = _port(cheb)
    snap = [t.clone() for t in healthy.s] + [t.clone() for t in healthy.s_mar]
    ref = tg.kernel_reference_apply(cheb["pts"], KERN, cheb["tree"].perm,
                                    chunk=128, device="cpu")
    bad = _port_copy(healthy)
    desc = tg.drill_corrupt_operator(bad, mode=mode, backend=backend)
    if backend == "torch":
        want = rg.drill_corrupt_operator(_ref_copy(cheb["data"]), mode=mode)
        assert desc == want
    else:
        assert desc.startswith("s[")
    rep = tg.validate_h2(tshape, bad)
    assert not rep.ok
    assert any("incoherent" in e for e in rep.errors)
    if mode == "nan":
        assert any("non-finite" in e for e in rep.errors)
    cert = tg.certify_h2(tshape, bad, ref, probes=6, tol=1e-2,
                         backend=backend)
    assert not cert.ok
    if mode == "scale":
        assert cert.rel_err > 1.0
    assert all(torch.equal(a, b) for a, b in
               zip(snap, list(healthy.s) + list(healthy.s_mar)))
    assert tg.validate_h2(tshape, healthy).ok


def test_drill_trap_s_mar_is_not_read_by_the_kernels(cheb):
    """The reference's drill (rewrite ``s_mar``) leaves the kernels'
    route untouched: the ``cuda`` backend's product (plain versions on CPU
    tensors) is bitwise the healthy one, the ``torch`` backend's is not."""
    tshape, healthy = _port(cheb)
    x = tg.probe_block(tshape.n, 4, device="cpu")
    bad = _port_copy(healthy)
    tg.drill_corrupt_operator(bad, mode="scale", backend="torch")
    assert torch.equal(h2_matvec(tshape, bad, x, "cuda"),
                       h2_matvec(tshape, healthy, x, "cuda"))
    assert not torch.equal(h2_matvec(tshape, bad, x, "torch"),
                           h2_matvec(tshape, healthy, x, "torch"))


# ---------------------------------------------------------------------------
# the certified sketch construction under the rank-starved drill
# ---------------------------------------------------------------------------

@pytest.mark.guard
def test_rank_starved_matches_reference_on_its_draws(monkeypatch):
    from test_torch_sketch import _inject_reference_gaussians
    pts = regular_grid_points(16, 2)
    want = rg.construct_h2_certified(
        pts, ref_exp(0.1, xp=jnp), 16, 0.9, cert_tol=1e-2, probes=6,
        max_rounds=4, sketch_opts=rg.drill_rank_starved())
    want_counts = dict(rg.GUARD_COUNTERS)
    _inject_reference_gaussians(monkeypatch)
    _ref_probes(monkeypatch)
    got = tg.construct_h2_certified(
        pts, KERN, 16, 0.9, cert_tol=1e-2, probes=6, max_rounds=4,
        sketch_opts=tg.drill_rank_starved(), device="cpu")
    assert got[5] == want[5] > 1
    assert got[0].ranks == want[0].ranks
    assert got[4].ok and want[4].ok
    assert abs(got[4].rel_err - want[4].rel_err) <= 1e-3 * want[4].rel_err
    assert dict(tg.GUARD_COUNTERS) == want_counts


@pytest.mark.guard
def test_rank_starved_recovers_on_own_draws():
    pts = regular_grid_points(16, 2)
    shape, data, tree, bs, cert, rounds = tg.construct_h2_certified(
        pts, KERN, 16, 0.9, cert_tol=1e-2, probes=6, max_rounds=4,
        sketch_opts=tg.drill_rank_starved(), device="cpu")
    assert cert.ok and rounds > 1
    assert tg.GUARD_COUNTERS["construct/recovered"] == 1
    assert tg.GUARD_COUNTERS["construct/cert-failed"] == rounds - 1
    assert tg.validate_h2(shape, data, check_orth=False).ok


# ---------------------------------------------------------------------------
# solve_with_guards
# ---------------------------------------------------------------------------

def _to_reach(hist, level) -> int:
    h = np.asarray(hist, np.float64)
    return int(np.argmax(h <= level))


@pytest.fixture(scope="module")
def guarded16():
    from repro.apps import fractional as rf
    from repro_torch.apps import fractional as pf
    return {"ref": rf.solve_with_guards(16),
            "ref-forced": rf.solve_with_guards(16, maxiter=10),
            "port": pf.solve_with_guards(16, device="cpu"),
            "port-forced": pf.solve_with_guards(16, device="cpu",
                                                maxiter=10)}


@pytest.mark.guard
def test_solve_with_guards_matches_reference(guarded16):
    want, got = guarded16["ref"], guarded16["port"]
    assert (got["rung"], got["attempts"], got["recovered"],
            got["guard_ok"], got["status"], got["converged"]) == \
        (want["rung"], want["attempts"], want["recovered"],
         want["guard_ok"], want["status"], want["converged"]) == \
        ("primary", [("primary", "ok")], False, True, 0, True)
    for level in (1e-6, 1e-7):
        assert abs(_to_reach(got["history"].numpy(), level) -
                   _to_reach(want["history"], level)) <= 1
    assert abs(got["iters"] - 17) <= 1
    assert _rel(got["u"].numpy(), want["u"]) <= 5e-7
    assert set(want) <= set(got)
    assert list(got["rungs"]) == ["primary"]
    assert got["rungs"]["primary"]["iters"] == got["iters"]


@pytest.mark.guard
def test_solve_with_guards_forced_escalation(guarded16):
    """maxiter = 10 fails the primary rung: both ladders walk every rung
    and end exhausted on ``gmres-loose`` (one restart of 30 steps stops
    above 1e-6); the fp64 rung raises in the reference (jax 0.9.0) and
    runs unconverged in the port."""
    want, got = guarded16["ref-forced"], guarded16["port-forced"]
    assert [n for n, _ in got["attempts"]] == \
        [n for n, _ in want["attempts"]] == \
        ["primary", "fp64-scalars", "gmres-loose"]
    for i in (0, 2):
        assert got["attempts"][i] == want["attempts"][i]
    assert want["attempts"][1] == ("fp64-scalars", "raised:AttributeError")
    assert got["attempts"][1] == ("fp64-scalars", "ok")
    assert got["rung"] == want["rung"] == "gmres-loose"
    assert not (got["guard_ok"] or want["guard_ok"])
    assert not (got["recovered"] or want["recovered"])
    assert got["iters"] == want["iters"] == 30
    assert 1e-6 < got["relres"] < 1e-4 and 1e-6 < want["relres"] < 1e-4
