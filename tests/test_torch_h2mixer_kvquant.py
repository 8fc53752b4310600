"""PyTorch port: the H^2 token mixer (``models/h2mixer``), the int8 KV
cache (``serving/kv_quant``) and the deprecated ``apps.fractional.pcg``
shim, against the reference on the same numpy inputs.

- ``h2mixer_apply`` on the uncompressed operator: its mixed part (the
  output less the residual) within 1e-5 of the reference's, the
  reference's parameters carried across with a nonzero gate; against the
  dense kernel mix at the reference's 2e-2; the compressed mixer within
  1e-2 of the uncompressed with less memory, and its ranks the
  reference's; O(N) memory; the 1-D tree's identity permutation;
- ``kv_quant``: ``quantize`` equal to the reference's (int8 values and
  float16 scales, round half to even), ``dequantize``, ``update``,
  ``decode_attention_q`` (within 1e-6 of the reference's, within 3e-2 of
  full-precision attention) and ``cache_bytes``;
- the ``pcg`` shim's ``(x, iters, relres)`` tuple and its warning.

JAX is imported inside fixtures and helpers only.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.matvec import h2_matvec
from repro_torch.models.h2mixer import (h2mixer_apply, h2mixer_params,
                                        h2mixer_structure)
from repro_torch.serving import kv_quant

torch.set_num_threads(2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfg():
    return get_config("qwen3-0.6b").reduced(param_dtype="float32",
                                            act_dtype="float32")


S = 128


@pytest.fixture(scope="module")
def mixer_pair():
    """The reference's and the port's mixer on one input: (port cfg,
    port params, x, ref output)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as rget
    from repro.models.h2mixer import h2mixer_apply as rapply
    from repro.models.h2mixer import h2mixer_params as rparams
    from repro.models.h2mixer import h2mixer_structure as rstruct
    rcfg = rget("qwen3-0.6b").reduced(param_dtype="float32",
                                      act_dtype="float32")
    shape, data = rstruct(S, leaf_size=8, cheb_p=5, tol=None, corr=0.1)
    rp = jax.tree.map(np.asarray, rparams(rcfg, jax.random.PRNGKey(0),
                                          jnp.float32))
    rp["gate"] = np.random.default_rng(2).uniform(
        0.5, 2.0, rp["gate"].shape).astype(np.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, S, rcfg.d_model)).astype(np.float32)
    y = np.asarray(rapply(rcfg, jax.tree.map(jnp.asarray, rp),
                          jnp.asarray(x), shape, data))
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return _cfg(), p, x, y


def test_h2mixer_apply_matches_reference(mixer_pair):
    cfg, p, x, y_ref = mixer_pair
    shape, data = h2mixer_structure(S, leaf_size=8, cheb_p=5, tol=None,
                                    corr=0.1, device="cpu")
    y = h2mixer_apply(cfg, p, torch.from_numpy(x), shape, data,
                      backend="torch")
    assert _rel(y.numpy() - x, y_ref - x) < 1e-5
    # backend="cuda" on CPU tensors: the kernels' plain versions
    y_cuda = h2mixer_apply(cfg, p, torch.from_numpy(x), shape, data)
    assert _rel(y_cuda.numpy() - x, y_ref - x) < 1e-5


def test_h2mixer_matches_dense_kernel_mix(mixer_pair):
    """The reference's test: against the dense kernel mix at 2e-2."""
    from repro_torch.models.layers import rms_norm
    cfg, p, x, _ = mixer_pair
    shape, data = h2mixer_structure(S, leaf_size=8, cheb_p=5, tol=None,
                                    corr=0.1, device="cpu")
    p = dict(p, gate=torch.full_like(p["gate"], 10.0))      # tanh -> ~1
    xt = torch.from_numpy(x)
    y = h2mixer_apply(cfg, p, xt, shape, data, backend="torch")
    pos = np.arange(S)[:, None] / S
    a = np.exp(-np.abs(pos - pos.T) / 0.1)
    h = (rms_norm(xt, p["norm"], cfg.norm_eps) @ p["w_in"]).numpy()
    mixed = np.einsum("st,btd->bsd", a, h)
    ref = x + (mixed @ p["w_out"].numpy()) * np.tanh(p["gate"].numpy())
    np.testing.assert_allclose(y.numpy(), ref, rtol=2e-2, atol=2e-2)


def test_compressed_mixer_close_and_smaller():
    from repro.models.h2mixer import h2mixer_structure as rstruct
    s = 256
    sh0, d0 = h2mixer_structure(s, tol=None, device="cpu")
    sh1, d1 = h2mixer_structure(s, tol=1e-4, device="cpu", backend="torch")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (s, 4)).astype(np.float32))
    y0 = h2_matvec(sh0, d0, x, backend="torch").numpy()
    y1 = h2_matvec(sh1, d1, x, backend="torch").numpy()
    assert _rel(y1, y0) < 1e-2
    assert sh1.memory_lowrank() < sh0.memory_lowrank()
    assert sh1.ranks == rstruct(s, tol=1e-4)[0].ranks


def test_o_n_memory():
    m1 = h2mixer_structure(256, tol=None, device="cpu")[0]
    m2 = h2mixer_structure(1024, tol=None, device="cpu")[0]
    total1 = m1.memory_lowrank() + m1.memory_dense()
    total2 = m2.memory_lowrank() + m2.memory_dense()
    assert total2 < 8 * total1     # ~linear, far below the 16x of dense


def test_h2mixer_params_and_shape_check():
    cfg = _cfg()
    p = h2mixer_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    assert not p["gate"].any() and tuple(p["w_in"].shape) == (128, 128)
    shape, data = h2mixer_structure(64, tol=None, device="cpu")
    x = torch.zeros(1, 32, cfg.d_model)
    with pytest.raises(ValueError, match="64 positions"):
        h2mixer_apply(cfg, p, x, shape, data)


# ---------------------------------------------------------------------------
# kv_quant


def _ref_kv():
    from repro.serving import kv_quant as rkv
    return rkv


def test_quantize_equals_reference():
    import jax.numpy as jnp
    rkv = _ref_kv()
    x = np.random.default_rng(0).standard_normal((2, 16, 4, 32)).astype(
        np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, 0.0]      # ties at the rounding
    mine, ref = kv_quant.quantize(torch.from_numpy(x)), rkv.quantize(
        jnp.asarray(x))
    assert mine.q.dtype == torch.int8 and mine.scale.dtype == torch.float16
    assert np.array_equal(mine.q.numpy(), np.asarray(ref.q))
    assert np.array_equal(mine.scale.numpy(), np.asarray(ref.scale))
    deq = kv_quant.dequantize(mine)
    assert np.array_equal(deq.numpy(), np.asarray(rkv.dequantize(ref)))
    assert _rel(deq.numpy(), x) < 1e-2


def test_round_half_even():
    x = torch.tensor([[[[63.5, 64.5, -0.5, 127.0]]]])
    q = kv_quant.quantize(x).q
    assert q.tolist() == [[[[64, 64, 0, 127]]]]      # 63.5 and 64.5 -> 64


def test_quantized_decode_attention():
    import jax.numpy as jnp
    from repro_torch.models.layers import decode_attention
    rkv = _ref_kv()
    rng = np.random.default_rng(1)
    b, s, h, hkv, hd = 2, 32, 4, 2, 16
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, 1, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    mask = np.arange(s)[None, :] <= np.array([[20], [31]])
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    out = kv_quant.decode_attention_q(tq, kv_quant.quantize(tk),
                                      kv_quant.quantize(tv), tm)
    full = decode_attention(tq, tk, tv, tm)
    assert _rel(out.numpy(), full.numpy()) < 3e-2
    ref = rkv.decode_attention_q(jnp.asarray(q), rkv.quantize(jnp.asarray(k)),
                                 rkv.quantize(jnp.asarray(v)),
                                 jnp.asarray(mask))
    assert _rel(out.numpy(), np.asarray(ref)) < 1e-6


def test_update_appends():
    import jax.numpy as jnp
    rkv = _ref_kv()
    c = kv_quant.quantize(torch.zeros(1, 8, 2, 4))
    step = torch.full((1, 1, 2, 4), 3.0)
    c2 = kv_quant.update(c, step, 5)
    deq = kv_quant.dequantize(c2)
    np.testing.assert_allclose(deq[0, 5].numpy(), 3.0, rtol=2e-2)
    np.testing.assert_allclose(deq[0, 4].numpy(), 0.0, atol=1e-6)
    assert not c.q.any()                          # out of place
    ref = rkv.update(rkv.quantize(jnp.zeros((1, 8, 2, 4))),
                     jnp.full((1, 1, 2, 4), 3.0), 5)
    assert np.array_equal(c2.q.numpy(), np.asarray(ref.q))
    assert np.array_equal(c2.scale.numpy(), np.asarray(ref.scale))
    c3 = kv_quant.update(c, step, torch.tensor(7))     # a device position
    assert np.array_equal(kv_quant.dequantize(c3)[0, 7].numpy(),
                          deq[0, 5].numpy())


@pytest.mark.parametrize("shape,nbytes", [((128, 32768, 8, 128), 2),
                                          ((8, 256, 8, 128), 2),
                                          ((2, 16, 4, 32), 4)])
def test_cache_bytes_equal_reference(shape, nbytes):
    rkv = _ref_kv()
    assert kv_quant.cache_bytes(shape, nbytes) == \
        rkv.cache_bytes(shape, nbytes)
    full, quant = kv_quant.cache_bytes(shape)
    assert quant < 0.6 * full


# ---------------------------------------------------------------------------
# the deprecated pcg shim


def test_pcg_shim_tuple_and_warning():
    from repro_torch.apps.fractional import pcg
    rng = np.random.default_rng(0)
    m = rng.standard_normal((16, 16)).astype(np.float32)
    a = torch.from_numpy(m @ m.T + 16 * np.eye(16, dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    with pytest.warns(DeprecationWarning, match="deprecated"):
        x, iters, relres = pcg(lambda v: a @ v, b, tol=1e-6, maxiter=50)
    assert isinstance(iters, int) and isinstance(relres, float)
    assert 0 < iters <= 16 and relres <= 1e-6
    assert _rel((a @ x).numpy(), b.numpy()) < 1e-5


# ---------------------------------------------------------------------------
# on the card: the mixer's kernels against the plain backend


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_h2mixer_kernels_match_plain(cuda):
    """The mixer at nv = B*D = 128 on the kernels (``batched_gemm``,
    ``coupling_mv``; the structure's compress on ``batched_qr``/
    ``batched_svd``) against the plain backend, and every kernel
    launched."""
    from repro_torch.kernels import ops
    cfg = _cfg()
    ops.reset_launch_counts()
    shape, data = h2mixer_structure(1024, device=cuda, backend="cuda")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = h2mixer_params(cfg, gen, torch.float32)
    p["gate"] = torch.rand(cfg.d_model, generator=gen, device=cuda) + 0.5
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device=cuda)
    y = h2mixer_apply(cfg, p, x, shape, data, backend="cuda")
    counts = ops.launch_counts()
    y0 = h2mixer_apply(cfg, p, x, shape, data, backend="torch")
    assert _rel((y - x).cpu().numpy(), (y0 - x).cpu().numpy()) < 1e-5
    for name in ("batched_gemm", "coupling_mv", "batched_qr",
                 "batched_svd"):
        assert counts[name] > 0, name


@pytest.mark.cuda
def test_cuda_kv_quant_equals_cpu(cuda):
    x = torch.randn((2, 16, 4, 32), generator=torch.Generator()
                    .manual_seed(0))
    on_card = kv_quant.quantize(x.to(cuda))
    here = kv_quant.quantize(x)
    assert torch.equal(on_card.q.cpu(), here.q)
    assert torch.equal(on_card.scale.cpu(), here.scale)
