"""PyTorch port: the autograd-aware collectives of
``parallel/collectives.py`` and the layout changes of
``parallel/sharding.py`` (``constrain``, ``local_block``, ``assemble``)
on spawned gloo groups of 2 and 4 CPU ranks.

Every rank holds its part of a seeded global problem (float64) and the
forward and the backward of each function are held to the same
computation in one process: for a collective ``f`` and seeded weights
``w_r``, the sum over the ranks of ``<w_r, f(x)_r>`` (each rank's own
term when its output is split work, one term when the output is a
replicated value whose gradient is full) has the gradient the function's
backward must produce on each rank -- reduce-scatter for ``all_gather``,
all-gather for ``reduce_scatter`` and ``scatter``, psum for ``copy_to``
and ``psum``, the identity for ``reduce_from``, this rank's block for
``all_gather(grad="slice")``.  ``constrain`` between every pair of specs
of a 2 x 2 mesh (and a 1 x 2 and a 2 x 1 one) gives this rank's block of
the global tensor, and its backward this rank's block of the global
gradient.  ``Comm.reduce_scatter`` and ``Comm.pmax`` equal the one-process
sum and maximum, the same bits on every rank, with their bytes counted
under ``reduce-scatter`` and ``all-reduce``.
"""
import itertools

import numpy as np
import pytest
import torch

import torch_lm_mesh_util as U

torch.set_num_threads(2)

FUNCS = ("all_gather", "all_gather_slice", "reduce_scatter", "scatter",
         "copy_to", "reduce_from", "psum")
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
SPECS = [(None, None), ("data", None), ("model", None), (None, "model"),
         ("data", "model"), ("model", "data"), (("data", "model"), None)]


def _problem(p: int, seed: int = 0):
    """Seeded global inputs and weights: x_r [4, 6] per rank, w_r per
    rank (for the split consumers) and w (for the replicated ones)."""
    rng = np.random.default_rng(seed + p)
    xs = [rng.standard_normal((4, 6)) for _ in range(p)]
    ws = [rng.standard_normal((4 * p, 6)) for _ in range(p)]
    w = rng.standard_normal((4 * p, 6))
    return xs, ws, w


def _expected(name: str, p: int):
    """(every rank's forward value, every rank's input gradient), from
    one process."""
    xs, ws, w = _problem(p)
    t = [torch.tensor(x, requires_grad=True) for x in xs]
    big = [torch.tensor(w_[:4 * p]) for w_ in ws]
    if name == "all_gather":
        y = torch.cat(t)
        ys = [y] * p
        loss = sum((wr * y).sum() for wr in big)
    elif name == "all_gather_slice":
        y = torch.cat(t)
        ys = [y] * p
        loss = (torch.tensor(w) * y).sum()
    elif name == "reduce_scatter":
        x4 = [torch.tensor(np.tile(x, (p, 1)), requires_grad=True)
              for x in xs]
        t = x4
        total = sum(x4)
        ys = list(total.chunk(p))
        loss = sum((big[r][:4] * ys[r]).sum() for r in range(p))
    elif name == "scatter":
        x = torch.tensor(np.concatenate(xs), requires_grad=True)
        t = [x] * p
        ys = list(x.chunk(p))
        loss = sum((big[r][:4] * ys[r]).sum() for r in range(p))
    elif name == "copy_to":
        x = torch.tensor(xs[0], requires_grad=True)
        t = [x] * p
        ys = [x] * p
        loss = sum((big[r][:4] * x).sum() for r in range(p))
    elif name == "reduce_from":
        y = sum(t)
        ys = [y] * p
        loss = (torch.tensor(w[:4]) * y).sum()
    elif name == "psum":
        y = sum(t)
        ys = [y] * p
        loss = sum((big[r][:4] * y).sum() for r in range(p))
    grads = torch.autograd.grad(loss, list(dict.fromkeys(t)))
    if name in ("scatter", "copy_to"):
        grads = grads * p
    return [y.detach() for y in ys], list(grads)


def _rank(rank, world, init, tmp):
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as S
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    comm = Comm()
    xs, ws, w = _problem(world)
    out = {"funcs": {}, "constrain": {}}
    for name in FUNCS:
        if name == "reduce_scatter":
            x = torch.tensor(np.tile(xs[rank], (world, 1)),
                             requires_grad=True)
            y = C.reduce_scatter(x, 0, comm)
            loss = (torch.tensor(ws[rank][:4]) * y).sum()
        elif name == "scatter":
            x = torch.tensor(np.concatenate(xs), requires_grad=True)
            y = C.scatter(x, 0, comm)
            loss = (torch.tensor(ws[rank][:4]) * y).sum()
        elif name in ("copy_to",):
            x = torch.tensor(xs[0], requires_grad=True)
            y = C.copy_to(x, comm)
            loss = (torch.tensor(ws[rank][:4]) * y).sum()
        else:
            x = torch.tensor(xs[rank], requires_grad=True)
            if name == "all_gather":
                y = C.all_gather(x, 0, comm)
                loss = (torch.tensor(ws[rank][:4 * world]) * y).sum()
            elif name == "all_gather_slice":
                y = C.all_gather(x, 0, comm, grad="slice")
                loss = (torch.tensor(w) * y).sum()
            elif name == "reduce_from":
                y = C.reduce_from(x, comm)
                loss = (torch.tensor(w[:4]) * y).sum()
            else:
                y = C.psum(x, comm)
                loss = (torch.tensor(ws[rank][:4]) * y).sum()
        loss.backward()
        out["funcs"][name] = (y.detach(), x.grad)
    comm.reset_counts()
    z = torch.arange(24, dtype=torch.float64).reshape(4 * world // 2, -1) \
        * (rank + 1)
    out["rs"] = comm.reduce_scatter(z.reshape(world, -1), 0)
    out["rs_kinds"] = dict(comm.recv_by_kind)
    out["pmax"] = comm.pmax(torch.tensor([rank, -rank, 3.0],
                                         dtype=torch.float64))
    for shape in MESHES[world]:
        mesh = make_test_mesh(*shape)
        rng = np.random.default_rng(7)
        g = torch.tensor(rng.standard_normal((4, 8)))
        dg = torch.tensor(rng.standard_normal((4, 8)))
        for src, dst in itertools.product(SPECS, SPECS):
            x = S.local_block(g, src, mesh).clone().requires_grad_(True)
            y = S.constrain(x, dst, mesh, src=src)
            y.backward(S.local_block(dg, dst, mesh))
            out["constrain"][(shape, src, dst)] = (
                U.max_err(y.detach(), S.local_block(g, dst, mesh)),
                U.max_err(x.grad, S.local_block(dg, src, mesh)),
                U.max_err(S.assemble(y.detach(), dst, mesh), g))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = {}
    for p in (2, 4):
        tmp = tmp_path_factory.mktemp(f"coll{p}")
        out[p] = U.run_ranks(_rank, tmp, (), world=p)
    return out


@pytest.mark.parametrize("name", FUNCS)
@pytest.mark.parametrize("p", (2, 4))
def test_collective_forward_and_backward(groups, p, name):
    ys, grads = _expected(name, p)
    for r, res in enumerate(groups[p]):
        y, g = res["funcs"][name]
        assert U.max_err(y, ys[r]) < 1e-12, (name, r)
        want = grads[r] if len(grads) == p else grads[0]
        assert U.max_err(g, want) < 1e-12, (name, r)


@pytest.mark.parametrize("p", (2, 4))
def test_comm_reduce_scatter_and_pmax(groups, p):
    for r, res in enumerate(groups[p]):
        z = sum(torch.arange(24, dtype=torch.float64).reshape(p, -1) *
                (q + 1) for q in range(p))
        assert torch.equal(res["rs"], z[r:r + 1])
        assert res["rs_kinds"] == {"reduce-scatter": (p - 1) * 24 // p * 8}
        assert torch.equal(res["pmax"], torch.tensor(
            [p - 1, 0.0, 3.0], dtype=torch.float64))


@pytest.mark.parametrize("p", (2, 4))
def test_constrain_is_a_layout_change(groups, p):
    """Between every pair of specs: the forward is this rank's block of
    the global tensor, the backward this rank's block of the global
    gradient, and ``assemble`` gives the global tensor back."""
    n = 0
    for res in groups[p]:
        for key, errs in res["constrain"].items():
            assert max(errs) == 0.0, (key, errs)
            n += 1
    assert n == len(groups[p]) * len(MESHES[p]) * len(SPECS) ** 2
