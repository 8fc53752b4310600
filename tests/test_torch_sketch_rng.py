"""PyTorch port: the sketch constructor's counter-based Gaussians
(``repro_torch.sketch.rng``).

The reference draws ``jax.random`` threefry bits, which torch cannot
reproduce, so the port keeps the counter-based property instead and is
held to it here: Philox 4x32-10 against the Random123 known answers; a
node's block independent of how nodes are batched or ordered; the same
seed the same bits, other seeds, streams and budgets other bits; moments
of N(0, 1); the float64 polynomials standing in for log, cos and sin
within 1e-14 of libm's; and, on a card, the CPU's bits exactly.  The
parity of the sketch construction with the reference (the reference's
Gaussians injected) is in tests/test_torch_sketch.py.  No JAX import: the
card test collects on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.sketch import rng as trng

torch.set_num_threads(2)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))])
def test_philox_known_answers(ctr, key, want):
    """Philox 4x32-10 on int64 words: the Random123 known-answer vectors."""
    c = [torch.tensor([x], dtype=torch.int64) for x in ctr]
    got = tuple(int(w) for w in trng.philox4x32(*c, *key))
    assert got == want


def test_node_gaussians_independent_of_batching_and_order():
    base = trng.stream_key(3, 5)
    ids = torch.arange(12)
    whole = trng.node_gaussians(base, ids, rows=10, cols=7)
    perm = torch.tensor([7, 2, 11, 0, 5])
    assert torch.equal(trng.node_gaussians(base, perm, rows=10, cols=7),
                       whole[perm])
    one = trng.node_gaussians(base, torch.tensor([9]), rows=10, cols=7)
    assert torch.equal(one[0], whole[9])
    assert torch.equal(trng.level_gaussians(3, 5, 12, 10, 7), whole)


def test_level_gaussians_reproducible_and_seeded():
    a = trng.level_gaussians(0, 4, 16, 32, 9)
    assert torch.equal(a, trng.level_gaussians(0, 4, 16, 32, 9))
    assert not torch.equal(a, trng.level_gaussians(1, 4, 16, 32, 9))
    assert not torch.equal(a, trng.level_gaussians(0, 5, 16, 32, 9))
    # a larger budget is a fresh draw, not a superset
    b = trng.level_gaussians(0, 4, 16, 32, 18)
    assert not torch.equal(a, b[..., :9])
    # nodes differ from each other
    assert not torch.equal(a[0], a[1])


def test_gaussian_moments():
    z = trng.level_gaussians(7, 2, 4, 4096, 64, dtype=torch.float64)
    z = z.reshape(-1)
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n ** 0.5
    assert abs(float(z.var()) - 1.0) < 0.01
    assert abs(float((z ** 3).mean())) < 0.02
    assert abs(float((z ** 4).mean()) - 3.0) < 0.05
    assert float((z.abs() > 3).double().mean()) == pytest.approx(
        0.0027, abs=5e-4)


def test_box_muller_polynomials_match_libm():
    """The exactly rounded polynomials stand in for log, cos and sin."""
    u = torch.linspace(1e-9, 1.0, 100001, dtype=torch.float64)
    assert float((trng._log_unit(u) - torch.log(u)).abs().max()) < 1e-14
    v = torch.linspace(0.0, 1.0 - 1e-9, 100001, dtype=torch.float64)
    c, s = trng._cos_sin_turn(v)
    ang = 2 * np.pi * v
    assert float((c - torch.cos(ang)).abs().max()) < 1e-14
    assert float((s - torch.sin(ang)).abs().max()) < 1e-14


def test_stream_key_rejects_wide_streams():
    with pytest.raises(ValueError, match="32-bit"):
        trng.stream_key(0, 1 << 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_gaussians_equal_cpu_bitwise(cuda):
    """The card draws the CPU's bits (level 3 of K at n = 512's budget)."""
    cpu = trng.level_gaussians(0, 3, 8, 32768, 74)
    dev = trng.level_gaussians(0, 3, 8, 32768, 74, device=cuda)
    assert torch.equal(dev.cpu(), cpu)
