"""PyTorch port: the LM serving path of the dense family (``models/config``,
``configs/*``, ``models/layers``, ``models/transformer``, ``models/api``,
``launch/serve``) against the reference on the same numpy inputs.

For the 4 dense configs (``qwen3_0_6b`` with qk-norm and a tied head,
``qwen1_5_4b`` with QKV bias, ``nemotron_4_15b`` with squared ReLU and an
untied head, ``codeqwen1_5_7b``) at ``reduced(float32)``, the reference's
parameters (``jax.random.PRNGKey(0)``; the QKV biases set nonzero) are
carried across by ``params_from_numpy``: ``prefill`` logits and caches,
``decode_step`` logits and caches and ``train_loss`` within 1e-4 relative
of the reference's.  Also: ``flash_attention`` against naive attention and
the reference's; prefill + 1 decode against a prefill of the extended
sequence (the reference's consistency test); ``BatchedServer.serve``
returns the reference's greedy tokens on its ``main()`` inputs; the
configurations equal the reference's field for field.  The other families
and MoE are held to the reference in ``test_torch_lm_families.py``.

JAX is imported inside fixtures and helpers only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cbase
from repro_torch.models import api, layers
from repro_torch.models.config import param_count

torch.set_num_threads(2)

DENSE = ("qwen3_0_6b", "qwen1_5_4b", "nemotron_4_15b", "codeqwen1_5_7b")
RTOL = 1e-4
B, S, CACHE = 2, 32, 40


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _reduced(arch, **kw):
    return cbase.get_config(arch).reduced(param_dtype="float32",
                                          act_dtype="float32", **kw)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(arch, ref cfg, ref params, port cfg, port params, tokens, ref
    outputs): the reference's prefill, decode and loss on one batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as rget
    from repro.models import api as rapi
    arch = request.param
    rcfg = rget(arch).reduced(param_dtype="float32", act_dtype="float32")
    tree = jax.tree.map(np.asarray, rapi.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
    if rcfg.qkv_bias:                      # biases that matter
        rng = np.random.default_rng(1)
        for k in ("bq", "bk", "bv"):
            a = tree["blocks"]["attn"][k]
            tree["blocks"]["attn"][k] = (0.1 * rng.standard_normal(
                a.shape)).astype(np.float32)
    rp = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(0).integers(0, rcfg.vocab,
                                             (B, S + 1)).astype(np.int32)
    rl, rc = rapi.prefill(rcfg, rp, {"tokens": jnp.asarray(toks[:, :S])},
                          cache_len=CACHE)
    rl2, rc2 = rapi.decode_step(rcfg, rp,
                                {"tokens": jnp.asarray(toks[:, S:])}, rc,
                                jnp.int32(S))
    rloss = rapi.train_loss(rcfg, rp, {"tokens": jnp.asarray(toks)})
    ref = dict(prefill=np.asarray(rl), k=np.asarray(rc["k"]),
               v=np.asarray(rc["v"]), decode=np.asarray(rl2),
               k2=np.asarray(rc2["k"]), v2=np.asarray(rc2["v"]),
               loss=float(rloss))
    cfg = _reduced(arch)
    return arch, cfg, api.params_from_numpy(cfg, tree, "cpu"), toks, ref


def test_prefill_matches_reference(pair):
    _, cfg, p, toks, ref = pair
    logits, cache = api.prefill(cfg, p, {"tokens": torch.from_numpy(
        toks[:, :S])}, cache_len=CACHE)
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, CACHE,
                                       cfg.n_kv_heads, cfg.hd)
    assert _rel(_np(logits), ref["prefill"]) < RTOL
    assert _rel(_np(cache["k"]), ref["k"]) < RTOL
    assert _rel(_np(cache["v"]), ref["v"]) < RTOL
    assert not cache["k"][:, :, S:].any()           # zero-padded rows


def test_decode_step_matches_reference(pair):
    _, cfg, p, toks, ref = pair
    t = torch.from_numpy(toks)
    _, cache = api.prefill(cfg, p, {"tokens": t[:, :S]}, cache_len=CACHE)
    logits, cache2 = api.decode_step(cfg, p, {"tokens": t[:, S:]}, cache,
                                     torch.tensor(S))
    assert _rel(_np(logits), ref["decode"]) < RTOL
    assert _rel(_np(cache2["k"]), ref["k2"]) < RTOL
    assert _rel(_np(cache2["v"]), ref["v2"]) < RTOL
    assert torch.equal(cache2["k"][:, :, :S], cache["k"][:, :, :S])


def test_train_loss_matches_reference(pair):
    _, cfg, p, toks, ref = pair
    loss = api.train_loss(cfg, p, {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - ref["loss"]) <= RTOL * abs(ref["loss"])


def test_prefill_decode_consistency(pair):
    """Prefill + 1 decode step = a prefill of the extended sequence (the
    reference's test, here at float32 and 1e-4)."""
    _, cfg, p, toks, _ = pair
    t = torch.from_numpy(toks)
    logits1, cache = api.prefill(cfg, p, {"tokens": t[:, :S]},
                                 cache_len=S + 4)
    nxt = logits1.argmax(-1)[:, None]
    logits2, _ = api.decode_step(cfg, p, {"tokens": nxt}, cache,
                                 torch.tensor(S))
    full, _ = api.prefill(cfg, p, {"tokens": torch.cat([t[:, :S], nxt],
                                                       dim=1)})
    assert _rel(_np(logits2), _np(full)) < RTOL


# ---------------------------------------------------------------------------
# layers


def _naive(q, k, v, causal):
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    kk = k.repeat_interleave(g, dim=2)
    vv = v.repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) / hd ** 0.5
    if causal:
        mask = torch.ones(s, k.shape[1], dtype=torch.bool).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), vv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,bq,bkv", [(64, 16, 32), (48, 16, 32),
                                      (40, 512, 1024)])
def test_flash_attention(causal, s, bq, bkv):
    """Blocked online softmax = naive attention (GQA, blocks that do and
    do not divide the sequence) and = the reference's."""
    import jax.numpy as jnp
    from repro.models.layers import flash_attention as rflash
    rng = np.random.default_rng(s + bq)
    q, k, v = (rng.standard_normal((2, s, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    out = layers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, block_q=bq, block_kv=bkv)
    naive = _naive(*map(torch.from_numpy, (q, k, v)), causal)
    assert _rel(_np(out), _np(naive)) < 1e-5
    ref = rflash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=bq,
                 block_kv=bkv)
    assert _rel(_np(out), np.asarray(ref)) < 1e-5


def test_decode_attention_and_rope_match_reference():
    import jax.numpy as jnp
    from repro.models import layers as rl
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
              for _ in range(2))
    mask = np.arange(24)[None, :] <= np.array([[10], [23]])
    out = layers.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc),
                                  torch.from_numpy(mask))
    ref = rl.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(mask))
    assert _rel(_np(out), np.asarray(ref)) < 1e-6
    x = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    pos = np.arange(24)
    assert _rel(_np(layers.apply_rope(torch.from_numpy(x),
                                      torch.from_numpy(pos), 1e6)),
                np.asarray(rl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6))) < 1e-6
    w = rng.standard_normal(32).astype(np.float32)
    assert _rel(_np(layers.rms_norm(torch.from_numpy(x),
                                    torch.from_numpy(w))),
                np.asarray(rl.rms_norm(jnp.asarray(x), jnp.asarray(w)))) \
        < 1e-6


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_matches_reference(act):
    import jax.numpy as jnp
    from repro.models import layers as rl
    cfg = dataclasses.replace(_reduced("qwen3_0_6b"), act=act)
    gen = torch.Generator().manual_seed(0)
    p = layers.mlp_params(cfg, gen, torch.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    out = layers.mlp(cfg, p, torch.from_numpy(x))
    ref = rl.mlp(cfg, {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                 jnp.asarray(x))
    assert _rel(_np(out), np.asarray(ref)) < 1e-5


def test_sharding_rules_not_ported():
    """Without a device mesh the rules change only the flash blocking: the
    query blocks re-cut for context parallelism (KV heads that do not
    shard), the reference's values with the same rules and
    ``model_size``; ``msize`` > 1 without a mesh raises ``ValueError``.
    (The mesh runs are in ``test_torch_lm_mesh.py``.)"""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.models import layers as rlayers
    from repro.parallel.sharding import Rules as RRules
    from repro_torch.parallel.sharding import Rules
    # the reference's constraints need a mesh in context on jax 0.9 (its
    # fallback catches ValueError and TypeError, not RuntimeError): one
    # device, where they change no value
    one = jax.make_mesh((1, 1), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)
    assert layers.flash_blocks(12, 12, 4, 4) == (3, 4, 3, 4)
    assert layers.flash_blocks(12, 12, 4, 4, cp=2) == (2, 6, 3, 4)
    assert layers.flash_blocks(9, 9, 4, 4, cp=2) == (1, 9, 1, 9)
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 12, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    for attn_tp in (False, True):
        kw = dict(causal=True, block_q=4, block_kv=4, model_size=2)
        got = layers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     rules=Rules(attn_tp=attn_tp), **kw)
        with jax.set_mesh(one):
            want = rlayers.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           rules=RRules(attn_tp=attn_tp),
                                           **kw)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    cfg = cbase.get_config("qwen3_0_6b").reduced(param_dtype="float32",
                                                 act_dtype="float32")
    p = api.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="mesh"):
        api.prefill(cfg, p, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                    msize=2)


# ---------------------------------------------------------------------------
# the server


@pytest.fixture(scope="module")
def reference_serve():
    """The reference's ``launch/serve.py`` main() inputs and tokens:
    qwen3-0.6b reduced, PRNGKey(0) parameters, 4 prompts of 8 tokens from
    ``default_rng(0)``, 8 new tokens, max_len 64."""
    import jax
    from repro.configs.base import get_config as rget
    from repro.launch.serve import BatchedServer as RServer
    from repro.launch.serve import Request as RRequest
    from repro.models import api as rapi
    rcfg = rget("qwen3-0.6b").reduced(param_dtype="float32",
                                      act_dtype="float32")
    rp = rapi.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    reqs = [RRequest(rid=i, prompt=rng.integers(0, rcfg.vocab, 8).astype(
        np.int32), max_new=8) for i in range(4)]
    out = RServer(rcfg, rp, batch_size=4, max_len=64).serve(reqs)
    return jax.tree.map(np.asarray, rp), out


def test_batched_server_matches_reference(reference_serve):
    from repro_torch.launch.serve import BatchedServer, make_requests
    tree, ref = reference_serve
    cfg = _reduced("qwen3-0.6b")
    server = BatchedServer(cfg, api.params_from_numpy(cfg, tree, "cpu"),
                           batch_size=4, max_len=64, device="cpu")
    out = server.serve(make_requests(cfg, 4, 8, 8, seed=0))
    assert out == ref


def test_batched_server_pads_the_batch(reference_serve):
    """Fewer requests than the batch: rid -1 padding fills it, and the
    real requests' tokens are as in the full batch's run."""
    from repro_torch.launch.serve import BatchedServer, make_requests
    tree, ref = reference_serve
    cfg = _reduced("qwen3-0.6b")
    server = BatchedServer(cfg, api.params_from_numpy(cfg, tree, "cpu"),
                           batch_size=4, max_len=64, device="cpu")
    reqs = make_requests(cfg, 4, 8, 8, seed=0)[:3]
    out = server.serve(reqs)
    assert sorted(out) == [0, 1, 2] and all(len(v) == 8
                                            for v in out.values())
    with pytest.raises(ValueError, match="max_len"):
        BatchedServer(cfg, server.params, 4, 12, "cpu").serve(reqs)


def test_serve_main_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    out = main(["--device", "cpu", "--requests", "2", "--max-new", "3"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# configurations and the family dispatch


@pytest.mark.parametrize("arch", cbase.ARCHS)
def test_configs_equal_reference(arch):
    from repro.configs import base as rbase
    from repro.models.config import param_count as rcount
    mine, ref = cbase.get_config(arch), rbase.get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (mine.hd, mine.sub_quadratic, mine.has_decoder) == \
        (ref.hd, ref.sub_quadratic, ref.has_decoder)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert param_count(mine) == rcount(ref)
    for shape in cbase.SHAPES:
        assert cbase.shape_applicable(mine, shape) == \
            rbase.shape_applicable(ref, shape)


def test_registry_equals_reference():
    from repro.configs import base as rbase
    assert cbase.ARCHS == rbase.ARCHS and cbase.ALIASES == rbase.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in cbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}
    assert cbase.get_config("qwen3-0.6b") is cbase.get_config("qwen3_0_6b")


def test_init_params_shapes_and_bf16_carry():
    """The port's own init has the reference's shapes; a bfloat16 tree
    carries across bit for bit."""
    import jax
    from repro.configs.base import get_config as rget
    from repro.models import api as rapi
    cfg = cbase.get_config("qwen3_0_6b").reduced()        # bfloat16
    rtree = jax.tree.map(np.asarray, rapi.init_params(
        rget("qwen3_0_6b").reduced(), jax.random.PRNGKey(0)))
    mine = api.init_params(cfg, 0, "cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(rtree)[0]
    for path, a in flat_ref:
        t = mine
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.bfloat16
    carried = api.params_from_numpy(cfg, rtree, "cpu")
    emb = carried["embed"]
    assert emb.dtype == torch.bfloat16
    assert np.array_equal(emb.view(torch.int16).numpy().view(np.uint16),
                          rtree["embed"].view(np.uint16))
    with pytest.raises(ValueError, match="embed"):
        api.params_from_numpy(cfg, {**rtree, "embed": rtree["embed"][:3]},
                              "cpu")
