"""A closed loop of HGEMVs (``repro_torch.core.matvec.h2_matvec``) on the
H² operator of a kernel configuration, built by ``construct_h2``.

Each call takes a block of ``nv`` vectors in the operator's tree order,
from a pool of seeded blocks cycled so that no input stays in the card's
cache, and returns the product in that order, as the port's entry takes
and gives them (an H2Opus user permutes the points once, when the
operator is built).  The check compares the last output of every pool
block on rows drawn from the seed with the exact kernel rows in float64
(``reference.rows.kernel_rows``), over the points in the port's tree
order, which it first checks to be a permutation of the points.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from h2bench import trace, work
from h2bench.cells import kernel_operator
from h2bench.reference import rows

SPAN = "h2bench/hgemv-call"


class Cell:
    min_calls = 1
    SPAN = SPAN

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 control=None):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.control = control
        self.nv, self.pool_size = traffic["nv"], traffic["pool"]

    def setup(self) -> None:
        from repro_torch.core import matvec
        t = time.perf_counter()
        self.op = kernel_operator.build(self.cfg, self.dev)
        self.mv = matvec
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        self.pool = torch.randn((self.pool_size, self.op.shape.n, self.nv),
                                generator=gen, device=self.dev)
        self.outs = [None] * self.pool_size
        self.i = 0
        self.parts = {"construct": time.perf_counter() - t}
        t = time.perf_counter()
        for _ in range(self.tr["warmup"]):
            self.call()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.parts["warmup"] = time.perf_counter() - t

    def call(self) -> None:
        j = self.i % self.pool_size
        self.outs[j] = self.mv.h2_matvec(self.op.shape, self.op.data,
                                         self.pool[j], backend="cuda")
        self.i += 1

    def end_to_end(self, window_s: float, calls: int) -> dict:
        return {"hgemv_ms": window_s / calls * 1e3}

    def traced(self):
        return trace.traced_window(self.call, self.tr["traced_calls"], SPAN)

    def counters(self) -> dict:
        return {}

    def work(self) -> dict:
        out = dict(work.hgemv_phases(self.op.opshape, self.nv))
        out[SPAN] = work.hgemv_call(self.op.opshape, self.nv)
        return out

    def release(self) -> None:
        # drop this runner's hold on the operator's arrays; the check
        # needs only its points and order
        self.op = dataclasses.replace(self.op, shape=None, data=None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, calls: int):
        """The largest relative error, over the pool's blocks, of the
        last output of each on the sampled rows."""
        n = self.pool.shape[1]
        p = kernel_operator.tree_points(self.op)
        if p is None:
            return {"hgemv_rel_err": float("inf")}, calls, calls
        rng = np.random.default_rng([self.seed, 1])
        r = torch.as_tensor(np.sort(rng.choice(n, self.tr["check_rows"],
                                               replace=False)),
                            device=self.dev)
        kern = kernel_operator.reference_kernel(self.cfg)
        x = self.pool.permute(1, 0, 2).reshape(n, -1)
        if self.control == "tf32":
            got_all = rows.kernel_rows_low(p, kern, r, x).reshape(
                -1, self.pool_size, self.nv)
        exact = rows.kernel_rows(p, kern, r, x).reshape(
            -1, self.pool_size, self.nv)
        worst, bad = 0.0, 0
        for j, y in enumerate(self.outs):
            want = exact[:, j]
            got = got_all[:, j] if self.control == "tf32" else y[r].double()
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                bad += 1
                continue
            worst = max(worst, float((got - want).norm() / want.norm()))
        return {"hgemv_rel_err": worst if not bad else float("inf")}, \
            calls, bad
