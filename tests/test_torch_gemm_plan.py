"""PyTorch port: the path ``batched_gemm`` takes (``plan_launch``), and --
on a CUDA card only -- every fast-path variant against the plain version.

``plan_launch`` is a pure function of shapes, strides and pointer
alignment, so it is checked here on CPU tensors: every HGEMV shape of the
main path (N = 2^20, leaf 64, ranks 36; nv = 16) and of its compressed
operator must take the fast path with the intended M bucket, A layout and
load (bulk copy where the spans are 16-byte aligned multiples of 16 bytes,
``cp.async`` otherwise); shapes outside it must take the general kernel.
On the card: 1e-5 relative to the plain einsum (fp32 sums in another
order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import batched_gemm as kbg
from repro_torch.kernels import ref

torch.set_num_threads(2)

NV = 16
COMPRESSED_RANKS = (1, 1, 1, 6, 11, 13, 15, 12, 12, 10, 8, 6, 5, 5, 3)


def _t(nb, rows, cols):
    """``[nb, cols, rows]`` transposed view: a basis read as ``V^T``."""
    return torch.zeros(nb, cols, rows).transpose(-1, -2)


def _hgemv_operands(nb_leaf, leaf, ranks):
    """(what, a, b) of every batched_gemm call of one HGEMV, with the batch
    cut to ``nb_leaf`` (``plan_launch`` does not depend on it beyond 1)."""
    q = len(ranks) - 1
    out = [("leaf V^T x", _t(nb_leaf, ranks[q], leaf),
            torch.zeros(nb_leaf, leaf, NV)),
           ("leaf U", torch.zeros(nb_leaf, leaf, ranks[q]),
            torch.zeros(nb_leaf, ranks[q], NV))]
    for l in range(1, q + 1):
        nb = min(1 << l, nb_leaf)
        out.append((f"F^T l={l}", _t(nb, ranks[l - 1], ranks[l]),
                    torch.zeros(nb, ranks[l], NV)))
        out.append((f"E l={l}", torch.zeros(nb, ranks[l], ranks[l - 1]),
                    torch.zeros(nb, ranks[l - 1], NV)))
    return out


@pytest.mark.parametrize("what,a,b,want", [
    ("leaf V^T x", _t(8, 36, 64), torch.zeros(8, 64, NV), "bulk:m48:t"),
    ("leaf U", torch.zeros(8, 64, 36), torch.zeros(8, 36, NV),
     "bulk:m64:n4"),
    ("F^T l=14", _t(8, 36, 36), torch.zeros(8, 36, NV), "bulk:m48:t"),
    ("E l=14", torch.zeros(8, 36, 36), torch.zeros(8, 36, NV),
     "bulk:m48:n4"),
    ("F^T l=1", _t(2, 36, 36), torch.zeros(2, 36, NV), "bulk:m48:t"),
    ("compressed leaf V^T x", _t(8, 3, 64), torch.zeros(8, 64, NV),
     "bulk:m16:t"),
    ("compressed leaf U", torch.zeros(8, 64, 3), torch.zeros(8, 3, NV),
     "bulk:m64:n"),
    ("compressed F^T l=5", _t(8, 11, 13), torch.zeros(8, 13, NV),
     "async:m16:t"),
    ("compressed E l=6", torch.zeros(8, 15, 13), torch.zeros(8, 13, NV),
     "async:m16:n"),
    ("compressed E l=7", torch.zeros(8, 12, 15), torch.zeros(8, 15, NV),
     "bulk:m16:n"),
    ("compressed E l=8", torch.zeros(8, 12, 12), torch.zeros(8, 12, NV),
     "bulk:m16:n4"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_plan_of_main_path_shapes(what, a, b, want):
    assert kbg.plan_launch(a, b) == want, what


@pytest.mark.parametrize("ranks", [tuple([36] * 15), COMPRESSED_RANKS],
                         ids=["uncompressed", "compressed"])
def test_every_hgemv_gemm_takes_the_fast_path(ranks):
    for what, a, b in _hgemv_operands(8, 64, ranks):
        plan = kbg.plan_launch(a, b)
        m = a.shape[1]
        bucket = "m16" if m <= 16 else "m48" if m <= 48 else "m64"
        assert plan.split(":")[1:2] == [bucket], (what, plan)
        assert plan not in ("general", "zeros"), (what, plan)


@pytest.mark.parametrize("case,want", [
    ("non-dense batch stride", "general"),
    ("misaligned pointer", "async:m48:t"),
    ("misaligned B", "async:m48:n4"),
    ("K > 64", "general"),
    ("M > 64", "general"),
    ("N = 32", "general"),
    ("B transposed", "general"),
    ("A neither layout", "general"),
    ("one matrix, any batch stride", "bulk:m48:t"),
])
def test_plan_of_other_layouts(case, want):
    flat = torch.zeros(4 * 64 * 36 + 1)
    a, b = {
        "non-dense batch stride": lambda: (
            torch.zeros(4, 40, 64)[:, :36], torch.zeros(4, 64, NV)),
        "misaligned pointer": lambda: (
            flat[1:].view(4, 64, 36).transpose(-1, -2),
            torch.zeros(4, 64, NV)),
        "misaligned B": lambda: (
            torch.zeros(4, 36, 36),
            torch.zeros(4 * 36 * NV + 1)[1:].view(4, 36, NV)),
        "K > 64": lambda: (torch.zeros(4, 36, 72), torch.zeros(4, 72, NV)),
        "M > 64": lambda: (torch.zeros(4, 72, 36), torch.zeros(4, 36, NV)),
        "N = 32": lambda: (torch.zeros(4, 36, 36), torch.zeros(4, 36, 32)),
        "B transposed": lambda: (
            torch.zeros(4, 36, 36), torch.zeros(4, NV, 36).transpose(-1, -2)),
        "A neither layout": lambda: (
            torch.zeros(4, 36, 128)[:, :, ::2], torch.zeros(4, 64, NV)),
        "one matrix, any batch stride": lambda: (
            torch.zeros(2, 64, 36)[::2].transpose(-1, -2),
            torch.zeros(1, 64, NV)),
    }[case]()
    assert kbg.plan_launch(a, b) == want


@pytest.mark.parametrize("sa,sb,want", [
    ((7, 5, 3), (7, 3, 1), "general"), ((3, 1, 9), (3, 9, 2), "general"),
    ((5, 70, 33), (5, 33, 19), "general"),
    ((0, 4, 4), (0, 4, 2), "zeros"), ((3, 0, 4), (3, 4, 2), "zeros"),
    ((3, 4, 0), (3, 0, 2), "zeros"), ((3, 4, 5), (3, 5, 0), "zeros")])
def test_plan_of_edge_shapes(sa, sb, want):
    assert kbg.plan_launch(torch.zeros(sa), torch.zeros(sb)) == want


def test_plan_names_are_distinct():
    """One name per kernel path: the general kernel, and async/bulk x three
    M buckets x three A layouts of the fast path."""
    names = list(kbg.PLAN_NAMES.values())
    assert len(set(names)) == len(names) == 2 + 18
    assert kbg.PLAN_NAMES[0] == "general" and kbg.PLAN_NAMES[-1] == "zeros"


# ---------------------------------------------------------------------------
# on the card: every variant against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(nb, m, k, n, layout, offset, dev, seed):
    """A (in ``layout``) and B, both starting ``offset`` floats into their
    buffers (offset 1 breaks the 16-byte alignment)."""
    gen = torch.Generator().manual_seed(seed)
    fa = torch.randn(nb * m * k + offset, generator=gen).to(dev)[offset:]
    fb = torch.randn(nb * k * n + offset, generator=gen).to(dev)[offset:]
    a = fa.view(nb, k, m).transpose(-1, -2) if layout == "t" else \
        fa.view(nb, m, k)
    return a, fb.view(nb, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 16, 36, 48, 64])
@pytest.mark.parametrize("k", [36, 13, 64])
@pytest.mark.parametrize("layout", ["t", "n"])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_fast_variants_match_plain(cuda, m, k, layout, offset):
    for nb, n in [(1, 16), (5, 16), (300, 16), (37, 4), (9, 8)]:
        a, b = _operands(nb, m, k, n, layout, offset, cuda, nb + m + k)
        plan = kbg.plan_launch(a, b)
        assert plan != "general", plan
        assert plan.startswith("bulk") == (offset == 0 and m * k % 4 == 0)
        before = kbg.LAUNCHES
        got = kbg.batched_gemm(a, b)
        torch.cuda.synchronize()
        assert kbg.LAUNCHES == before + 1
        want = ref.batched_gemm(a, b)
        err = (got - want).abs().max().item() / want.abs().max().item()
        assert err <= 1e-5, (plan, nb, n, err)


@pytest.mark.cuda
def test_cuda_fast_path_at_main_path_size(cuda):
    """Leaf ``V^T x`` at N = 2^20 (16,384 leaves): the persistent grid
    walks many groups per CTA."""
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(16384, 64, 36, generator=gen).to(cuda)
    x = torch.randn(16384, 64, 16, generator=gen).to(cuda)
    a = v.transpose(-1, -2)
    assert kbg.plan_launch(a, x) == "bulk:m48:t"
    got = kbg.batched_gemm(a, x)
    want = ref.batched_gemm(a, x)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.cuda
def test_cuda_general_path_still_matches(cuda):
    rng = np.random.default_rng(1)
    for sa, sb in [((7, 5, 3), (7, 3, 1)), ((5, 70, 33), (5, 33, 19)),
                   ((4, 36, 72), (4, 72, 16))]:
        a = torch.as_tensor(rng.standard_normal(sa).astype(np.float32)
                            ).to(cuda)
        b = torch.as_tensor(rng.standard_normal(sb).astype(np.float32)
                            ).to(cuda)
        assert kbg.plan_launch(a, b) == "general"
        got, want = kbg.batched_gemm(a, b), ref.batched_gemm(a, b)
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
