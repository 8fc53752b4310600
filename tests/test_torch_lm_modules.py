"""PyTorch port: the modules of the other LM families and their server,
against the reference on the same numpy inputs.

``wkv_chunked`` and ``ssd_chunked`` against the reference's and against
the recurrences (lengths that the chunk divides, one it does not, one
token); ``_causal_conv`` with and without a carry; ``top_k``'s tie order
and ``_dispatch_indices`` equal to the reference's on routes with exact
ties; ``moe_ffn`` with drops and without, and with grok's virtual
experts; ``BatchedServer.serve`` returns the reference server's greedy
tokens for each family (with its zero stub inputs); the CLI takes any
arch; the card script's ``[lmfam]`` phase runs on the CPU at reduced size.

JAX is imported inside fixtures and helpers only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import api, mamba2, moe, rwkv6
from test_torch_lm_families import (FAMILIES, _np, _reduced,
                                    _reference_tree, _rel)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# RWKV6 and Mamba2 scans


def _wkv_inputs(t, seed=0, b=2, h=3, n=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-3, 1.2, (b, t, h, n)))).astype(
        np.float32)
    u = (0.5 * rng.standard_normal((h, n))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, n, n))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("t", [32, 20, 1])
def test_wkv_chunked_matches_reference_and_scan(t):
    import jax.numpy as jnp
    from repro.models import rwkv6 as rr
    args = _wkv_inputs(t)
    out, st = rwkv6.wkv_chunked(*map(torch.from_numpy, args))
    sout, sst = rwkv6.wkv_scan(*map(torch.from_numpy, args))
    rout, rst = rr.wkv_chunked(*map(jnp.asarray, args))
    rsout, rsst = rr.wkv_scan(*map(jnp.asarray, args))
    assert _rel(_np(out), np.asarray(rout)) < 1e-5
    assert _rel(_np(st), np.asarray(rst)) < 1e-5
    assert _rel(_np(sout), np.asarray(rsout)) < 1e-5
    assert _rel(_np(sst), np.asarray(rsst)) < 1e-5
    assert _rel(_np(out), _np(sout)) < 1e-4
    assert _rel(_np(st), _np(sst)) < 1e-4


def test_wkv_state_in_activation_dtype():
    """The carried state comes back in r's dtype (bfloat16 at full
    width), as the reference's."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(16)]
    r = args[0].bfloat16()
    for fn in (rwkv6.wkv_chunked, rwkv6.wkv_scan):
        out, st = fn(r, *args[1:])
        assert out.dtype == st.dtype == torch.bfloat16


def _ssd_inputs(t, seed=0, b=2, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    bi, ci = (rng.standard_normal((b, t, n)).astype(np.float32)
              for _ in range(2))
    a = np.exp(-rng.uniform(0.01, 0.5, (b, t, h))).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    return x, bi, ci, a, d, s0


@pytest.mark.parametrize("t", [128, 40, 1])
def test_ssd_chunked_matches_reference_and_scan(t):
    import jax.numpy as jnp
    from repro.models import mamba2 as rm
    args = _ssd_inputs(t)
    y, st = mamba2.ssd_chunked(*map(torch.from_numpy, args))
    sy, sst = mamba2.ssd_scan(*map(torch.from_numpy, args))
    ry, rst = rm.ssd_chunked(*map(jnp.asarray, args))
    rsy, rsst = rm.ssd_scan(*map(jnp.asarray, args))
    assert _rel(_np(y), np.asarray(ry)) < 1e-5
    assert _rel(_np(st), np.asarray(rst)) < 1e-5
    assert _rel(_np(sy), np.asarray(rsy)) < 1e-5
    assert _rel(_np(sst), np.asarray(rsst)) < 1e-5
    assert _rel(_np(y), _np(sy)) < 1e-4
    assert _rel(_np(st), _np(sst)) < 1e-4


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_reference(carry):
    import jax.numpy as jnp
    from repro.models import mamba2 as rm
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((mamba2.CONV_W, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    c = (rng.standard_normal((2, mamba2.CONV_W - 1, 6)).astype(np.float32)
         if carry else None)
    y, nc = mamba2._causal_conv(*map(torch.from_numpy, (x, w, b)),
                                None if c is None else torch.from_numpy(c))
    ry, rnc = rm._causal_conv(*map(jnp.asarray, (x, w, b)),
                              None if c is None else jnp.asarray(c))
    assert _rel(_np(y), np.asarray(ry)) < 1e-6
    assert np.array_equal(_np(nc), np.asarray(rnc))
    # the carry continues the sequence: two calls = one call
    y1, c1 = mamba2._causal_conv(torch.from_numpy(x[:, :5]),
                                 torch.from_numpy(w), torch.from_numpy(b))
    y2, _ = mamba2._causal_conv(torch.from_numpy(x[:, 5:]),
                                torch.from_numpy(w), torch.from_numpy(b), c1)
    y0, _ = mamba2._causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert torch.allclose(torch.cat([y1, y2], 1), y0, atol=1e-6)


# ---------------------------------------------------------------------------
# MoE


def _tied_probs(t, e, seed):
    """Router probabilities with exact ties: few distinct values a row."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 3, (t, e)).astype(np.float32)
    return (levels / levels.sum(-1, keepdims=True).clip(1)).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_tie_order_matches_reference(seed):
    import jax
    import jax.numpy as jnp
    probs = _tied_probs(64, 16, seed)
    gate, eid = moe.top_k(torch.from_numpy(probs), 4)
    rgate, reid = jax.lax.top_k(jnp.asarray(probs), 4)
    assert np.array_equal(eid.numpy(), np.asarray(reid))
    assert np.array_equal(gate.numpy(), np.asarray(rgate))


@pytest.mark.parametrize("seed,cap", [(0, 3), (1, 8), (2, 64)])
def test_dispatch_indices_equal_reference(seed, cap):
    import jax
    import jax.numpy as jnp
    from repro.models import moe as rmoe
    k, e = 4, 16
    probs = _tied_probs(64, e, seed)
    _, reid = jax.lax.top_k(jnp.asarray(probs), k)
    _, eid = moe.top_k(torch.from_numpy(probs), k)
    tok, slot, valid = moe._dispatch_indices(eid.reshape(-1), k, e, cap)
    rtok, rslot, rvalid = rmoe._dispatch_indices(
        reid.reshape(-1).astype(jnp.int32), k, e, cap)
    assert tok.dtype == torch.int64
    assert np.array_equal(tok.numpy(), np.asarray(rtok))
    assert np.array_equal(slot.numpy(), np.asarray(rslot))
    assert np.array_equal(valid.numpy(), np.asarray(rvalid))


def _moe_case(arch, cf=None, seed=0):
    import jax
    from repro.configs.base import get_config as rget
    from repro.models import moe as rmoe
    rcfg = rget(arch).reduced(param_dtype="float32", act_dtype="float32")
    if cf is not None:
        rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
    rp = rmoe.moe_params(rcfg, jax.random.PRNGKey(seed), np.float32)
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, rcfg.d_model)).astype(np.float32)
    return rcfg, jax.tree.map(np.asarray, rp), x


@pytest.mark.parametrize("arch,cf", [("qwen3_moe_30b_a3b", None),
                                     ("qwen3_moe_30b_a3b", 8.0),
                                     ("grok_1_314b", None),
                                     ("grok_1_314b", 8.0)])
def test_moe_ffn_matches_reference(arch, cf):
    """At the default capacity factor (choices drop) and at 8.0 (none
    do); grok's virtual experts ([E*v, D, F/v] slices)."""
    import jax.numpy as jnp
    from repro.models import moe as rmoe
    rcfg, rp, x = _moe_case(arch, cf)
    cfg = dataclasses.replace(_reduced(arch),
                              capacity_factor=rcfg.capacity_factor)
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    y = moe.moe_ffn(cfg, p, torch.from_numpy(x))
    ry = rmoe.moe_ffn(rcfg, {k: jnp.asarray(v) for k, v in rp.items()},
                      jnp.asarray(x), None, None)
    assert _rel(_np(y), np.asarray(ry)) < 1e-5
    t = x.shape[0] * x.shape[1]
    if cf is None:                     # the default drops some choices
        _, eid = moe.top_k(torch.softmax(torch.from_numpy(
            x.reshape(t, -1)) @ p["router"], -1), cfg.top_k)
        counts = torch.bincount(eid.reshape(-1), minlength=cfg.n_experts)
        assert int(counts.max()) > moe._capacity(cfg, t)
    else:
        assert moe._capacity(cfg, t) == t


def test_virtual_experts_equal_whole_experts():
    """v F-slices of each expert ([E*v, D, F/v]) compute what the whole
    experts ([E, D, F]) compute."""
    cfg = _reduced("grok_1_314b")                 # v = 2, gelu
    v = cfg.moe_virtual
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_params(cfg, gen, torch.float32)
    e, d, fw = cfg.n_experts, cfg.d_model, cfg.moe_d_ff // v
    whole = {"router": p["router"],
             "moe_w1": p["moe_w1"].reshape(e, v, d, fw).permute(
                 0, 2, 1, 3).reshape(e, d, v * fw),
             "moe_w2": p["moe_w2"].reshape(e, v * fw, d)}
    x = torch.randn((2, 12, d), generator=gen)
    y = moe.moe_ffn(cfg, p, x)
    y1 = moe.moe_ffn(dataclasses.replace(cfg, moe_virtual=1), whole, x)
    assert _rel(_np(y), _np(y1)) < 1e-6          # the F-sum's order only


# ---------------------------------------------------------------------------
# the server


SERVE = dict(n=3, batch=4, prompt=8, new=5, max_len=40)


@pytest.fixture(scope="module", params=list(FAMILIES), ids=lambda v: str(v))
def reference_serve(request):
    """The reference ``BatchedServer``'s greedy tokens (zero stubs, as it
    adds them) on 3 prompts of 8 tokens, 5 new tokens, batch 4."""
    import jax
    from repro.configs.base import get_config as rget
    from repro.launch.serve import BatchedServer as RServer
    from repro.launch.serve import Request as RRequest
    arch, kw = request.param
    rcfg = rget(arch).reduced(param_dtype="float32", act_dtype="float32",
                              **dict(kw))
    tree = _reference_tree(rcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rcfg.vocab, SERVE["prompt"]).astype(np.int32)
               for _ in range(SERVE["n"])]
    reqs = [RRequest(rid=i, prompt=pr, max_new=SERVE["new"])
            for i, pr in enumerate(prompts)]
    out = RServer(rcfg, jax.tree.map(jax.numpy.asarray, tree),
                  batch_size=SERVE["batch"],
                  max_len=SERVE["max_len"]).serve(reqs)
    return arch, kw, tree, prompts, out


def test_batched_server_matches_reference(reference_serve):
    from repro_torch.launch.serve import BatchedServer, Request
    arch, kw, tree, prompts, ref = reference_serve
    cfg = _reduced(arch, kw)
    server = BatchedServer(cfg, api.params_from_numpy(cfg, tree, "cpu"),
                           batch_size=SERVE["batch"],
                           max_len=SERVE["max_len"], device="cpu")
    out = server.serve([Request(rid=i, prompt=pr, max_new=SERVE["new"])
                        for i, pr in enumerate(prompts)])
    assert out == ref
    batch, _ = server._batchify([Request(rid=0, prompt=prompts[0])])
    for key, n in (("img_embed", cfg.n_img_tokens), ("frames",
                                                     cfg.n_frames)):
        if n:
            assert tuple(batch[key].shape) == (SERVE["batch"], n,
                                               cfg.d_model)
            assert not batch[key].any()


@pytest.mark.parametrize("arch", ["rwkv6-7b", "whisper-tiny"])
def test_serve_main_takes_every_arch(arch, capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", arch, "--device", "cpu", "--requests", "2",
                "--max-new", "3"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the card script's [lmfam] phase, rehearsed on the CPU


def test_lmfam_phase_runs_on_cpu(monkeypatch):
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    failed = []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: None if ok else failed.append(what))
    out = cs.lmfam_phase(torch, None, device="cpu", reduced=True)
    assert not failed, failed
    assert sorted(out["families"]) == sorted(cs.LMFAM_DEPTH)
    assert not any(out["launches"].values())     # no kernel on this path
    for fam in out["families"].values():
        assert fam["consistency_f32"] <= cs.LMFAM_CONSIST_TOL
