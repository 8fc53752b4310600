"""PyTorch port: the optimisers and the token pipeline against the JAX
reference on the same numpy inputs.

* ``optim.adamw``: ``apply_updates`` (float32 and bfloat16 parameters, the
  global-norm clip active and inactive, bias correction at step 4):
  parameters and moments within 1e-6 relative; ``global_norm`` within
  1e-5 (float32 sums in another order) and ``cosine_schedule`` (warmup,
  peak, decay, floor) within 1e-6.
* ``optim.grad_compress``: ``compress_and_reduce(comm=None)`` with the
  reference's Q factors and error feedback injected -- ``g_hat`` and the
  new Q within 1e-5 relative, the new error within 1e-5 of the compressed
  ``g + err`` (where the factors represent a leaf exactly, the error is
  rounding), over two rounds;
  ``compression_ratio`` exactly equal.  Over a gloo group of 2 CPU ranks
  (``comm=``): P and Q are linear in G for the shared Q, so each rank's
  ``g_hat`` equals the one-device compress of the ranks' mean ``g + err``
  within 1e-5.
* ``data.pipeline``: ``SyntheticLM`` and ``MemmapDataset`` batches equal
  to the reference's bit for bit over several (seed, step, shard,
  n_shards).

JAX is imported inside helpers only: the spawned ranks import this module.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tpsgd

torch.set_num_threads(2)

ADAM_RTOL = 1e-6        # parameters, moments
NORM_RTOL = 1e-5        # float32 sums of thousands of squares, another order
PSGD_RTOL = 1e-5
RANK_TIMEOUT_S = 120


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _tree(seed: int, scale: float = 1.0) -> dict:
    """A small parameter-shaped tree of float32 numpy arrays: stacked
    matrices, a matrix, vectors (compressible at PowerSGD's 4,096 and
    not)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"blocks": {"w1": a(3, 32, 48), "w2": a(3, 48, 32),
                       "norm": a(3, 32)},
            "embed": a(256, 32), "final_norm": a(32), "head": a(32, 100)}


def _to_torch(tree, dtype=torch.float32):
    return tadamw.tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_apply_updates_matches_reference(dtype, clip):
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as radamw
    params, grads = _tree(0), _tree(1, scale=0.05)
    m, v = _tree(2, 0.01), jax.tree.map(np.abs, _tree(3, 1e-4))
    gclip = 0.5 if clip == "active" else 1e6
    cfg_kw = dict(lr=1e-3, grad_clip=gclip)
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    rg = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), grads)
    rstate = radamw.AdamWState(jnp.int32(3), jax.tree.map(jnp.asarray, m),
                               jax.tree.map(jnp.asarray, v))
    rnew, rst, rmet = jax.jit(lambda p, g, s: radamw.apply_updates(
        radamw.AdamWConfig(**cfg_kw), p, g, s, 0.5))(rp, rg, rstate)

    tdt = getattr(torch, dtype)
    tp = tadamw.tree_map(lambda a: torch.from_numpy(
        np.asarray(a.astype(jnp.float32))).to(tdt), rp)
    tg = tadamw.tree_map(lambda a: torch.from_numpy(
        np.asarray(a.astype(jnp.float32))).to(tdt), rg)
    tstate = tadamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                               _to_torch(m), _to_torch(v))
    tnew, tst, tmet = tadamw.apply_updates(tadamw.AdamWConfig(**cfg_kw), tp,
                                           tg, tstate, 0.5)
    assert int(tst.step) == int(rst.step) == 4
    gn = float(rmet["grad_norm"])
    assert abs(float(tmet["grad_norm"]) - gn) <= NORM_RTOL * gn
    assert (gn > gclip) == (clip == "active")
    assert abs(float(tmet["lr"]) - float(rmet["lr"])) <= \
        ADAM_RTOL * float(rmet["lr"])
    for name, got, want in (("params", tnew, rnew), ("m", tst.m, rst.m),
                            ("v", tst.v, rst.v)):
        for g, w in zip(tadamw.tree_leaves(got), jax.tree.leaves(want)):
            if name == "params":
                assert g.dtype == tdt
            assert _rel(_np(g), np.asarray(w, np.float32)) <= ADAM_RTOL, \
                (name, _rel(_np(g), np.asarray(w, np.float32)))


def test_global_norm_and_schedule_match_reference():
    import jax.numpy as jnp
    from repro.optim import adamw as radamw
    tree = _tree(4)
    got = float(tadamw.global_norm(_to_torch(tree)))
    want = float(radamw.global_norm(tree))
    assert abs(got - want) <= NORM_RTOL * want
    for step in (0, 1, 10, 19, 20, 21, 50, 99, 100, 150):
        kw = dict(warmup=20, total=100)
        g = float(tadamw.cosine_schedule(
            torch.tensor(step, dtype=torch.int32), **kw))
        w = float(radamw.cosine_schedule(jnp.int32(step), **kw))
        assert abs(g - w) <= 1e-6, (step, g, w)
    # step 0: the warmup makes the first update a no-op
    assert float(tadamw.cosine_schedule(torch.tensor(0, dtype=torch.int32),
                                        warmup=20, total=100)) == 0.0


def test_init_state_is_zero_float32_on_the_params_device():
    params = _to_torch(_tree(5), torch.bfloat16)
    st = tadamw.init_state(tadamw.AdamWConfig(), params)
    assert st.step.dtype == torch.int32 and st.step.dim() == 0
    for m, v, p in zip(tadamw.tree_leaves(st.m), tadamw.tree_leaves(st.v),
                       tadamw.tree_leaves(params)):
        assert m.dtype == v.dtype == torch.float32
        assert m.shape == p.shape and not m.any() and not v.any()
        assert m.data_ptr() != v.data_ptr()


# ---------------------------------------------------------------------------
# PowerSGD
# ---------------------------------------------------------------------------

def _psgd_pair(cfg_kw, seed=0):
    """(port cfg, reference cfg, reference state as numpy lists)."""
    import jax
    from repro.optim import grad_compress as rpsgd
    rcfg = rpsgd.PowerSGDConfig(**cfg_kw)
    rst = rpsgd.init_state(rcfg, _tree(seed), jax.random.PRNGKey(seed))
    return tpsgd.PowerSGDConfig(**cfg_kw), rcfg, rst


def _port_state(rst) -> tpsgd.PowerSGDState:
    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))
    return tpsgd.PowerSGDState(q=[t(a) for a in rst.q],
                               err=[t(a) for a in rst.err])


@pytest.mark.parametrize("min_size", [4096, 1])
def test_compress_and_reduce_matches_reference(min_size):
    import jax
    from repro.optim import grad_compress as rpsgd
    cfg, rcfg, rst = _psgd_pair(dict(rank=4, min_compress_size=min_size))
    tst = _port_state(rst)
    assert [q is None for q in tst.q] == [
        p.ndim < 2 or p.size < min_size
        for p in jax.tree.leaves(_tree(0))]
    step = jax.jit(lambda g, s: rpsgd.compress_and_reduce(rcfg, g, s))
    for rnd in range(2):            # the second round: warm Q, error fed back
        grads = _tree(10 + rnd, scale=0.1)
        rhat, rst = step(grads, rst)
        that, tst = tpsgd.compress_and_reduce(cfg, _to_torch(grads), tst)
        for g, w in zip(tadamw.tree_leaves(that), jax.tree.leaves(rhat)):
            assert _rel(_np(g), w) <= PSGD_RTOL, (rnd, _rel(_np(g), w))
        for g, w in zip(tst.q, rst.q):
            assert (g is None) == (w is None)
            if g is not None:
                assert _rel(_np(g), w) <= PSGD_RTOL, (rnd, _rel(_np(g), w))
        for g, w, h in zip(tst.err, rst.err, jax.tree.leaves(rhat)):
            assert (g is None) == (w is None)
            if g is not None:           # relative to g + err = g_hat + err
                fb = np.linalg.norm(np.asarray(h) + np.asarray(w))
                assert np.linalg.norm(_np(g) - w) <= PSGD_RTOL * fb, rnd


def test_compression_ratio_equals_reference():
    from repro.optim import grad_compress as rpsgd
    tree = _tree(0)
    for kw in (dict(rank=4, min_compress_size=4096),
               dict(rank=2, min_compress_size=1), dict()):
        got = tpsgd.compression_ratio(tpsgd.PowerSGDConfig(**kw),
                                      _to_torch(tree))
        want = rpsgd.compression_ratio(rpsgd.PowerSGDConfig(**kw), tree)
        assert got == want, (kw, got, want)


def test_init_state_draws_from_the_seed():
    cfg = tpsgd.PowerSGDConfig(rank=3, min_compress_size=4096)
    params = _to_torch(_tree(0))
    a, b = tpsgd.init_state(cfg, params, 7), tpsgd.init_state(cfg, params, 7)
    c = tpsgd.init_state(cfg, params, 8)
    for qa, qb, qc, p in zip(a.q, b.q, c.q, tadamw.tree_leaves(params)):
        if qa is None:
            continue
        assert qa.shape == (p[0].numel(), 3) and qa.dtype == torch.float32
        assert torch.equal(qa, qb) and not torch.equal(qa, qc)


def _psgd_rank(rank: int, p: int, init: str, out: str, work: dict) -> None:
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    comm = Comm()
    cfg = tpsgd.PowerSGDConfig(**work["cfg"])
    st = tpsgd.PowerSGDState(
        q=[None if q is None else torch.from_numpy(q) for q in work["q"]],
        err=[None if e is None else torch.from_numpy(e[rank])
             for e in work["err"]])
    grads = _to_torch(work["grads"][rank])
    g_hat, new = tpsgd.compress_and_reduce(cfg, grads, st, comm=comm)
    torch.save({"g_hat": [t.numpy() for t in tadamw.tree_leaves(g_hat)],
                "q": [None if q is None else q.numpy() for q in new.q]},
               os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def test_compress_and_reduce_over_two_gloo_ranks(tmp_path):
    p = 2
    cfg_kw = dict(rank=4, min_compress_size=4096)
    cfg = tpsgd.PowerSGDConfig(**cfg_kw)
    st0 = tpsgd.init_state(cfg, _to_torch(_tree(0)), 3)
    rng = np.random.default_rng(9)
    err = [None if e is None else
           (0.01 * rng.standard_normal((p, *e.shape))).astype(np.float32)
           for e in st0.err]
    work = dict(cfg=cfg_kw, grads=[_tree(20 + r, 0.1) for r in range(p)],
                q=[None if q is None else q.numpy() for q in st0.q],
                err=err)
    ctx = torch.multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_psgd_rank,
                         args=(r, p, init, str(tmp_path), work))
             for r in range(p)]
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(RANK_TIMEOUT_S)
    finally:
        hung = [pr for pr in procs if pr.is_alive()]
        for pr in hung:
            pr.terminate()
            pr.join()
    assert not hung, f"{len(hung)} rank(s) did not finish"
    assert [pr.exitcode for pr in procs] == [0] * p
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(p)]

    # one device, on the ranks' mean g + err (the exactly averaged leaves:
    # the mean g)
    leaves = [tadamw.tree_leaves(_to_torch(work["grads"][r]))
              for r in range(p)]
    mean_g, mean_e = [], []
    for i, e in enumerate(err):
        fb = [leaves[r][i] + (0 if e is None else torch.from_numpy(e[r]))
              for r in range(p)]
        mean_g.append((fb[0] + fb[1]) / p)
        mean_e.append(None if e is None else torch.zeros_like(fb[0]))
    local = tpsgd.PowerSGDState(q=[None if q is None else torch.from_numpy(q)
                                   for q in work["q"]], err=mean_e)
    tree = tadamw.tree_unflatten(_tree(0), mean_g)
    want, wnew = tpsgd.compress_and_reduce(cfg, tree, local)
    for r in range(p):
        for g, w in zip(ranks[r]["g_hat"], tadamw.tree_leaves(want)):
            assert _rel(g, _np(w)) <= PSGD_RTOL, (r, _rel(g, _np(w)))
        for g, w in zip(ranks[r]["q"], wnew.q):
            if g is not None:
                assert _rel(g, _np(w)) <= PSGD_RTOL
    assert any(q is not None for q in ranks[0]["q"])


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,seq,gb", [(0, 512, 64, 8),
                                               (3, 151936, 33, 4),
                                               (11, 97, 16, 6)])
def test_synthetic_lm_batches_equal_reference(seed, vocab, seq, gb):
    from repro.data import pipeline as rpipe
    got = tpipe.SyntheticLM(vocab=vocab, seq_len=seq, global_batch=gb,
                            seed=seed)
    want = rpipe.SyntheticLM(vocab=vocab, seq_len=seq, global_batch=gb,
                             seed=seed)
    for step in (0, 1, 7):
        for n_shards in (1, 2):
            for shard in range(n_shards):
                g = got.batch(step, shard, n_shards)
                w = want.batch(step, shard, n_shards)
                assert g.dtype == w.dtype == np.int32
                assert g.shape == (gb // n_shards, seq + 1)
                assert np.array_equal(g, w), (step, shard, n_shards)
    with pytest.raises(ValueError):
        got.batch(0, 0, 5)


def test_memmap_dataset_batches_equal_reference(tmp_path):
    from repro.data import pipeline as rpipe
    toks = np.random.default_rng(0).integers(0, 1000, 5000)
    tpipe.write_token_file(str(tmp_path / "port.bin"), toks)
    rpipe.write_token_file(str(tmp_path / "ref.bin"), toks)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()
    got = tpipe.MemmapDataset(str(tmp_path / "port.bin"), seq_len=32,
                              global_batch=4, seed=5)
    want = rpipe.MemmapDataset(str(tmp_path / "ref.bin"), seq_len=32,
                               global_batch=4, seed=5)
    assert got.n_windows == want.n_windows
    for step in (0, 3, 9):
        for n_shards in (1, 2, 4):
            for shard in range(n_shards):
                assert np.array_equal(got.batch(step, shard, n_shards),
                                      want.batch(step, shard, n_shards))
