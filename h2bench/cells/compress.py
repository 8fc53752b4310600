"""A closed loop of recompressions, ``repro_torch.core.compression
.compress(shape, data, tol)``, of the operator of a kernel configuration
as ``construct_h2`` built it (the call does not modify its input).

The check reads the last recompressed operator's arrays and judges them
in float64 (``reference.h2ops``): its product with seeded probes against
the exact kernel rows on rows drawn from the seed, the orthonormality of
its nested bases, which the algorithm guarantees, and, on coupling blocks
drawn from the seed, each block against the exact kernel block projected
on the block's bases.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from h2bench import trace, work
from h2bench.cells import kernel_operator
from h2bench.reference import h2ops, rows

SPAN = "h2bench/compress-call"


class Cell:
    min_calls = 1
    SPAN = SPAN

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 control=None):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.control = control

    def setup(self) -> None:
        from repro_torch.core import compression
        if self.control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        t = time.perf_counter()
        self.op = kernel_operator.build(self.cfg, self.dev)
        self.cp = compression
        self.out = None
        self.parts = {"construct": time.perf_counter() - t}
        t = time.perf_counter()
        for _ in range(self.tr["warmup"]):
            self.call()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.parts["warmup"] = time.perf_counter() - t

    def call(self) -> None:
        self.out = None            # the last output alone stays alive
        self.out = self.cp.compress(self.op.shape, self.op.data,
                                    tol=self.tr["tol"], backend="cuda")

    def end_to_end(self, window_s: float, calls: int) -> dict:
        return {"compress_s": window_s / calls}

    def counters(self) -> dict:
        return {}

    def traced(self):
        return trace.traced_window(self.call, self.tr["traced_calls"], SPAN)

    def work(self) -> dict:
        cshape, _ = self.out
        return {"compress/orthogonalize": work.orthogonalize_work(
                    self.op.opshape),
                "compress/truncate": work.truncate_work(self.op.opshape,
                                                        cshape.ranks)}

    def release(self) -> None:
        # drop this runner's hold on the operator's arrays; the check
        # needs only its points and order
        self.op = dataclasses.replace(self.op, shape=None, data=None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, calls: int):
        """The recompressed operator's relative error against the exact
        rows, over the probes, and the largest defect of its bases'
        orthonormality."""
        _, d = self.out
        p = kernel_operator.tree_points(self.op)
        if p is None:
            return {"compress_rel_err": float("inf")}, calls, calls
        n = p.shape[0]
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        x = torch.randn((n, self.tr["probe_nv"]), generator=gen,
                        dtype=torch.float64, device=self.dev)
        y = h2ops.h2_apply(d.u_leaf, d.e, d.s, d.s_rows, d.s_cols, d.dense,
                           d.d_rows, d.d_cols, x, v_leaf=d.v_leaf, f=d.f)
        rng = np.random.default_rng([self.seed, 4])
        r = torch.as_tensor(np.sort(rng.choice(n, self.tr["check_rows"],
                                               replace=False)),
                            device=self.dev)
        kern = kernel_operator.reference_kernel(self.cfg)
        want = rows.kernel_rows(p, kern, r, x)
        err = float((y[r] - want).norm() / want.norm())
        if not np.isfinite(err):
            err = float("inf")
        defect = max(h2ops.basis_defect(d.u_leaf, d.e),
                     h2ops.basis_defect(d.v_leaf, d.f))
        coupling = h2ops.coupling_defect(
            d.u_leaf, d.e, d.s, d.s_rows, d.s_cols, p, kern,
            self.sample_blocks(d, rng))
        return {"compress_rel_err": err, "basis_defect": defect,
                "coupling_defect": coupling}, calls, 0

    def sample_blocks(self, d, rng):
        """Coupling blocks drawn from the seed: up to ``coupling_blocks``
        at each level whose clusters hold at most ``coupling_points``."""
        depth, m = len(d.e) - 1, d.u_leaf.shape[1]
        out = []
        for level in range(depth + 1):
            nb = d.s[level].shape[0]
            if not nb or m << (depth - level) > self.tr["coupling_points"]:
                continue
            k = min(nb, self.tr["coupling_blocks"])
            out += [(level, int(b)) for b in rng.choice(nb, k,
                                                       replace=False)]
        return out
