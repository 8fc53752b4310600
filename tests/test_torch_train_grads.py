"""PyTorch port: the training gradients against the JAX reference.

* ``layers.flash_attention``'s backward (``_FlashAttention``, the
  reference's custom VJP): ``dq, dk, dv`` against ``jax.grad`` of the
  reference's ``flash_attention`` (causal and not; grouped-query g = 2; a
  length the blocks divide and one they do not, which is one block; a
  query offset), float32, within 1e-5 relative; its output bitwise the
  same with and without ``requires_grad``.
* ``models.api.train_loss`` for all 10 configs at ``reduced(float32)``:
  the loss and every parameter leaf's gradient against
  ``jax.value_and_grad`` of the reference's, with the reference's
  parameters carried by ``params_from_numpy`` (every constant leaf
  perturbed, seeded nonzero stub inputs).  Tolerances: the loss within
  1e-5 relative; each gradient leaf within 1e-4 of its largest entry, or
  1e-3 for rwkv6 and zamba2, whose chunked exp/cumsum chains are longest.
* Remat on against off (``cfg.remat``): the loss and every gradient
  bitwise equal in the port.
* On the card (``cuda`` marker): the backward on CUDA tensors against the
  CPU's.

JAX is imported inside fixtures and helpers only.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cbase
from repro_torch.models import api, layers
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

torch.set_num_threads(2)

FLASH_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4                 # of each leaf's largest gradient entry
GRAD_TOL_LONG_CHAINS = {"rwkv6_7b": 1e-3, "zamba2_7b": 1e-3}
B = 2
SEQ = {"zamba2_7b": 128}        # two SSD chunks of 64; the others 64
FLASH_CASES = [                  # (causal, S, q_offset): blocks 16 / 32
    (True, 64, 0), (False, 64, 0), (True, 40, 0), (False, 40, 0),
    (True, 64, 8)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _qkv(s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((B, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, s, 2, 16)).astype(np.float32)
    dout = rng.standard_normal((B, s, 4, 16)).astype(np.float32)
    return q, k, v, dout


def _port_flash(q, k, v, causal, q_offset, requires_grad=True):
    ts = [torch.from_numpy(a).requires_grad_(requires_grad)
          for a in (q, k, v)]
    out = layers.flash_attention(*ts, causal=causal, q_offset=q_offset,
                                 block_q=16, block_kv=32)
    return ts, out


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,s,q_offset", FLASH_CASES)
def test_flash_backward_matches_reference(causal, s, q_offset):
    import jax
    import jax.numpy as jnp
    from repro.models import layers as rlayers
    q, k, v, dout = _qkv(s)

    def f(q_, k_, v_):
        out = rlayers.flash_attention(q_, k_, v_, causal=causal,
                                      q_offset=q_offset, block_q=16,
                                      block_kv=32)
        return jnp.sum(out * dout)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    ts, out = _port_flash(q, k, v, causal, q_offset)
    got = torch.autograd.grad(out, ts, torch.from_numpy(dout))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= FLASH_RTOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("causal,s,q_offset", FLASH_CASES)
def test_flash_output_same_with_and_without_grad(causal, s, q_offset):
    q, k, v, _ = _qkv(s, seed=1)
    _, with_grad = _port_flash(q, k, v, causal, q_offset, True)
    _, without = _port_flash(q, k, v, causal, q_offset, False)
    with torch.no_grad():
        _, no_grad = _port_flash(q, k, v, causal, q_offset, True)
    assert with_grad.requires_grad and not without.requires_grad
    assert torch.equal(with_grad.detach(), without)
    assert torch.equal(without, no_grad)


def test_flash_backward_bfloat16_returns_input_dtypes():
    q, k, v, dout = _qkv(64, seed=2)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
          for a in (q, k, v)]
    out = layers.flash_attention(*ts, causal=True, block_q=16, block_kv=32)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, ts, torch.from_numpy(dout).to(
        torch.bfloat16))
    ref = [t.detach().float().requires_grad_(True) for t in ts]
    out32 = layers.flash_attention(*ref, causal=True, block_q=16,
                                   block_kv=32)
    want = torch.autograd.grad(out32, ref, torch.from_numpy(dout).to(
        torch.bfloat16).float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), w.numpy()) <= 1e-2


# ---------------------------------------------------------------------------
# every config's loss and gradients
# ---------------------------------------------------------------------------

def _reduced(arch, **kw):
    return cbase.get_config(arch).reduced(param_dtype="float32",
                                          act_dtype="float32", **kw)


def _batch(cfg, seed: int = 3) -> dict:
    """Tokens [B, S+1] and seeded nonzero stub inputs (numpy)."""
    rng = np.random.default_rng(seed)
    s = SEQ.get(cfg.name.replace("-", "_").replace(".", "_"), 64)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, s + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img_embed"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _reference_tree(rcfg):
    """The reference's PRNGKey(0) parameters as numpy, every leaf that its
    init fills with one constant perturbed by 0.1 N(0, 1)."""
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


def _port_loss_grads(cfg, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = api.train_loss(cfg, tree_unflatten(params, leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


@pytest.fixture(scope="module", params=cbase.ARCHS)
def reference_grads(request):
    """(arch, port cfg, port params, batch, reference loss, reference
    gradient leaves)."""
    import jax
    from repro.configs import base as rbase
    from repro.models import api as rapi
    arch = request.param
    rcfg = rbase.get_config(arch).reduced(param_dtype="float32",
                                          act_dtype="float32")
    cfg = _reduced(arch)
    tree = _reference_tree(rcfg)
    batch = _batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: rapi.train_loss(rcfg, p, batch)))(tree)
    params = api.params_from_numpy(cfg, tree, "cpu")
    return (arch, cfg, params, batch, float(loss),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def test_train_loss_and_grads_match_reference(reference_grads):
    arch, cfg, params, batch, rloss, rgrads = reference_grads
    loss, grads = _port_loss_grads(cfg, params, batch)
    assert abs(float(loss) - rloss) <= LOSS_RTOL * abs(rloss), \
        (float(loss), rloss)
    tol = GRAD_TOL_LONG_CHAINS.get(arch, GRAD_TOL)
    assert len(grads) == len(rgrads)
    for i, (g, w) in enumerate(zip(grads, rgrads)):
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        assert scale > 0, (arch, i)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol * scale, (arch, i, err / scale)


@pytest.mark.parametrize("arch", cbase.ARCHS)
def test_remat_on_and_off_bitwise(arch):
    cfg = _reduced(arch)
    params = api.init_params(cfg, 0, "cpu")
    batch = _batch(cfg, seed=4)
    on = _port_loss_grads(dataclasses.replace(cfg, remat=True), params,
                          batch)
    off = _port_loss_grads(dataclasses.replace(cfg, remat=False), params,
                           batch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal,s,q_offset", FLASH_CASES)
def test_cuda_flash_backward_matches_cpu(cuda, causal, s, q_offset):
    q, k, v, dout = _qkv(s, seed=5)
    ts, out = _port_flash(q, k, v, causal, q_offset)
    want = torch.autograd.grad(out, ts, torch.from_numpy(dout))
    tc = [torch.from_numpy(a).to(cuda).requires_grad_(True)
          for a in (q, k, v)]
    oc = layers.flash_attention(*tc, causal=causal, q_offset=q_offset,
                                block_q=16, block_kv=32)
    got = torch.autograd.grad(oc, tc, torch.from_numpy(dout).to(cuda))
    for g, w in zip(got, want):
        assert _rel(g.cpu().numpy(), w.numpy()) <= FLASH_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("arch", cbase.ARCHS)
def test_cuda_train_grads_match_cpu(cuda, arch):
    cfg = _reduced(arch)
    params = api.init_params(cfg, 0, "cpu")
    batch = _batch(cfg, seed=6)
    loss, grads = _port_loss_grads(cfg, params, batch)
    cp = tree_unflatten(params, [p.to(cuda) for p in tree_leaves(params)])
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(cp)]
    tb = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    closs = api.train_loss(cfg, tree_unflatten(cp, leaves), tb)
    cgrads = torch.autograd.grad(closs, leaves)
    assert math.isclose(float(closs.detach()), float(loss), rel_tol=1e-4)
    for g, w in zip(cgrads, grads):
        assert _rel(g.cpu().numpy(), w.numpy()) <= 1e-4
