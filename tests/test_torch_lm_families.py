"""PyTorch port: the other LM families through ``models/api`` (``moe``,
``rwkv6``, ``mamba2``, ``zamba2``, ``vision``, ``whisper``) against the
reference on the same numpy inputs.

For ``rwkv6_7b``, ``zamba2_7b`` (also at 5 layers, so that a tail of
Mamba2 layers follows the last shared-block application),
``whisper_tiny``, ``llama_3_2_vision_11b``, ``qwen3_moe_30b_a3b`` and
``grok_1_314b`` at ``reduced(float32)``: the reference's parameters
(``PRNGKey(0)``, every constant-initialised leaf perturbed so that it
matters) are carried across by ``params_from_numpy``, with seeded nonzero
``img_embed``/``frames``; ``prefill`` logits and every cache entry,
``decode_step`` logits and every cache entry and ``train_loss`` agree with
the reference's within 1e-4 relative.  Each runs at a prompt length that
the families' chunk (RWKV 16, Mamba2 64) and the flash blocks divide and at
one they do not (the one-chunk path).
Also: prefill + k decode steps against the extended prefill for each;
``params_from_numpy`` checks every family's tree.  The modules, the
server and the card script's phase are held in ``test_torch_lm_modules.py``.

JAX is imported inside fixtures and helpers only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cbase
from repro_torch.models import api

torch.set_num_threads(2)

RTOL = 1e-4
B = 2
FAMILIES = {                 # (arch, config overrides): prompt lengths
    ("rwkv6_7b", ()): (32, 20),
    ("zamba2_7b", ()): (128, 20),
    ("zamba2_7b", (("n_layers", 5),)): (128, 20),
    ("whisper_tiny", ()): (32, 20),
    ("llama_3_2_vision_11b", ()): (32, 20),
    ("qwen3_moe_30b_a3b", ()): (32, 20),
    ("grok_1_314b", ()): (32, 20),
}
CASES = [(arch, kw, s) for (arch, kw), lens in FAMILIES.items()
         for s in lens]


def _id(case) -> str:
    arch, kw, s = case
    return f"{arch}{''.join(f'-{k}{v}' for k, v in kw)}-s{s}"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _flat(tree, prefix=""):
    """(path, leaf) of a nested dict / tuple / list, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_tree_close(got, want, what: str) -> None:
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for k in w:
        gk, wk = _np(g[k]), np.asarray(w[k])
        assert gk.shape == wk.shape, (what, k, gk.shape, wk.shape)
        assert _rel(gk, wk) < RTOL, (what, k, _rel(gk, wk))


def _reduced(arch, kw=()):
    return cbase.get_config(arch).reduced(param_dtype="float32",
                                          act_dtype="float32", **dict(kw))


def _stubs(cfg, b, seed: int = 7) -> dict:
    """Seeded nonzero stub modality inputs (numpy)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["img_embed"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _reference_tree(rcfg):
    """The reference's PRNGKey(0) parameters as numpy, every leaf that
    its init fills with one constant (norms, token-shift mixes, decay
    biases, conv biases, ...) perturbed by 0.1 N(0, 1)."""
    import jax
    from repro.models import api as rapi
    tree = jax.tree.map(np.asarray, rapi.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def perturb(a):
        if a.size > 1 and np.all(a == a.reshape(-1)[0]):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(perturb, tree)


@pytest.fixture(scope="module", params=CASES, ids=_id)
def pair(request):
    """(cfg, port params, tokens, stubs, s, reference outputs): the
    reference's prefill, decode and loss on one batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as rget
    from repro.models import api as rapi
    arch, kw, s = request.param
    rcfg = rget(arch).reduced(param_dtype="float32", act_dtype="float32",
                              **dict(kw))
    tree = _reference_tree(rcfg)
    rp = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(s).integers(0, rcfg.vocab,
                                             (B, s + 1)).astype(np.int32)
    stubs = _stubs(rcfg, B)
    rstubs = {k: jnp.asarray(v) for k, v in stubs.items()}
    cache_len = s + 8
    rl, rc = rapi.prefill(rcfg, rp, {"tokens": jnp.asarray(toks[:, :s]),
                                     **rstubs}, cache_len=cache_len)
    rl2, rc2 = rapi.decode_step(rcfg, rp, {"tokens": jnp.asarray(
        toks[:, s:]), **rstubs}, rc, jnp.int32(s))
    rloss = rapi.train_loss(rcfg, rp, {"tokens": jnp.asarray(toks),
                                       **rstubs})
    ref = dict(prefill=np.asarray(rl), cache=jax.tree.map(np.asarray, rc),
               decode=np.asarray(rl2), cache2=jax.tree.map(np.asarray, rc2),
               loss=float(rloss))
    cfg = _reduced(arch, kw)
    return (cfg, api.params_from_numpy(cfg, tree, "cpu"), toks,
            {k: torch.from_numpy(v) for k, v in stubs.items()}, s,
            cache_len, ref)


def test_prefill_matches_reference(pair):
    cfg, p, toks, stubs, s, cache_len, ref = pair
    with torch.no_grad():
        logits, cache = api.prefill(cfg, p, {"tokens": torch.from_numpy(
            toks[:, :s]), **stubs}, cache_len=cache_len)
    assert _rel(_np(logits), ref["prefill"]) < RTOL
    _assert_tree_close(cache, ref["cache"], "prefill cache")


def test_decode_step_matches_reference(pair):
    cfg, p, toks, stubs, s, cache_len, ref = pair
    t = torch.from_numpy(toks)
    with torch.no_grad():
        _, cache = api.prefill(cfg, p, {"tokens": t[:, :s], **stubs},
                               cache_len=cache_len)
        logits, cache2 = api.decode_step(cfg, p, {"tokens": t[:, s:]},
                                         cache, torch.tensor(s))
    assert _rel(_np(logits), ref["decode"]) < RTOL
    _assert_tree_close(cache2, ref["cache2"], "decode cache")


def test_train_loss_matches_reference(pair):
    cfg, p, toks, stubs, s, cache_len, ref = pair
    with torch.no_grad():
        loss = api.train_loss(cfg, p, {"tokens": torch.from_numpy(toks),
                                       **stubs})
    assert abs(float(loss) - ref["loss"]) <= RTOL * abs(ref["loss"])


@pytest.mark.parametrize("arch,kw", list(FAMILIES), ids=lambda v: str(v))
def test_prefill_decode_consistency(arch, kw):
    """Prefill of s tokens + k decode steps fed the known next tokens =
    a prefill of s + k tokens (MoE: capacity raised so nothing drops, as
    the reference's test)."""
    cfg = _reduced(arch, kw)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    s, k = (16, 16) if cfg.family in ("rwkv", "hybrid") else (16, 2)
    p = api.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, s + k)))
    stubs = {n: torch.from_numpy(v) for n, v in _stubs(cfg, B).items()}
    with torch.no_grad():
        _, cache = api.prefill(cfg, p, {"tokens": toks[:, :s], **stubs},
                               cache_len=s + k)
        for j in range(k):
            logits, cache = api.decode_step(
                cfg, p, {"tokens": toks[:, s + j:s + j + 1], **stubs}, cache,
                torch.tensor(s + j))
        full, _ = api.prefill(cfg, p, {"tokens": toks, **stubs})
    assert _rel(_np(logits), _np(full)) < RTOL


@pytest.mark.parametrize("arch,kw", list(FAMILIES), ids=lambda v: str(v))
def test_params_from_numpy_checks_shapes(arch, kw):
    """The carried tree's keys and shapes are checked against the
    config's, and the port's own init has the reference's tree."""
    import jax
    from repro.configs.base import get_config as rget
    from repro.models import api as rapi
    rcfg = rget(arch).reduced(**dict(kw))                  # bfloat16
    cfg = cbase.get_config(arch).reduced(**dict(kw))
    shapes = jax.eval_shape(lambda k: rapi.init_params(rcfg, k),
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    carried = api.params_from_numpy(cfg, tree, "cpu")
    mine = api.init_params(cfg, 0, "cpu")
    flat_ref = dict(_flat(tree))
    assert sorted(dict(_flat(mine))) == sorted(flat_ref)
    for path, t in _flat(mine):
        assert tuple(t.shape) == flat_ref[path].shape, path
        assert t.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for _, t in _flat(carried))
    bad = dict(tree)
    bad["head"] = tree["head"][:, :3]
    with pytest.raises(ValueError, match="head"):
        api.params_from_numpy(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="should hold"):
        api.params_from_numpy(cfg, {k: v for k, v in tree.items()
                                    if k != "final_norm"}, "cpu")


def test_sharding_rules_raise_for_every_family():
    """Without a device mesh ``msize`` > 1 raises ``ValueError`` for every
    family, and rules at ``msize`` 1 change no value (the reference's
    constraints are no-ops outside a mesh).  The mesh runs are in
    ``test_torch_lm_mesh.py``."""
    from repro_torch.parallel.sharding import Rules
    for arch in ("rwkv6_7b", "zamba2_7b", "qwen3_moe_30b_a3b"):
        cfg = _reduced(arch)
        p = api.init_params(cfg, 0, "cpu")
        batch = {"tokens": torch.arange(4, dtype=torch.long)[None]}
        with pytest.raises(ValueError, match="mesh"):
            api.prefill(cfg, p, batch, rules=Rules(), msize=2)
        with pytest.raises(ValueError, match="mesh"):
            api.train_loss(cfg, p, batch, rules=Rules(), msize=2)
        a, _ = api.prefill(cfg, p, batch, rules=Rules())
        b, _ = api.prefill(cfg, p, batch)
        assert torch.equal(a, b)
