"""Serving driver: batched prefill + greedy decode over a request batch,
the port of the reference's ``launch/serve.py``.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8
    python -m repro_torch.launch.serve --arch rwkv6-7b --device cpu
    python -m repro_torch.launch.serve --full --requests 8 --prompt-len 128

``--arch`` takes any of the 10 configs (``configs/base.py``).
``--reduced`` (the default, as the reference's) serves the family's small
config in float32; ``--full`` the real one (qwen3-0.6b: 28 layers, d 1024,
bfloat16).  Weights come from the port's seeded init: nothing is
downloaded.  ``--device`` defaults to ``cuda``.

The batch is static and left-padded with token 0, as the reference's, and
the padding is not masked: a shorter prompt attends to the pad tokens in
front of it (the reference's behaviour, kept).  The ``vlm`` and ``audio``
families get the reference's stub inputs, zero ``img_embed`` [B,
n_img_tokens, D] and ``frames`` [B, n_frames, D] in the activation dtype;
they stay in the decode batch, which reads the cached cross K/V.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import api
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new: int = 16


class BatchedServer:
    """Static-batch server: groups requests, prefills once, decodes
    greedily at ``pos = s + step``."""

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 max_len: int, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.bs = batch_size
        self.max_len = max_len
        self.device = torch.device(device)

    def _batchify(self, reqs: List[Request]) -> Tuple[Dict[str, Any], int]:
        s = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.bs, s), np.int64)
        for i, r in enumerate(reqs):
            toks[i, s - len(r.prompt):] = r.prompt     # left-pad
        b = {"tokens": torch.from_numpy(toks).to(self.device)}
        cfg, act = self.cfg, getattr(torch, self.cfg.act_dtype)
        if cfg.family == "vlm":            # the reference's zero stubs
            b["img_embed"] = torch.zeros(
                (self.bs, cfg.n_img_tokens, cfg.d_model), dtype=act,
                device=self.device)
        if cfg.family == "audio":
            b["frames"] = torch.zeros((self.bs, cfg.n_frames, cfg.d_model),
                                      dtype=act, device=self.device)
        return b, s

    def prefill(self, batch):
        return api.prefill(self.cfg, self.params, batch,
                           cache_len=self.max_len)

    def decode(self, batch, cache, pos):
        return api.decode_step(self.cfg, self.params, batch, cache, pos)

    def serve(self, reqs: List[Request]) -> Dict[int, List[int]]:
        """rid -> its greedy tokens; padding requests (rid -1) fill the
        batch.  The tokens stay on the device until the last step."""
        if len(reqs) > self.bs:
            raise ValueError(f"{len(reqs)} requests, batch of {self.bs}")
        while len(reqs) < self.bs:
            reqs = reqs + [Request(rid=-1, prompt=np.zeros(1, np.int32))]
        batch, s = self._batchify(reqs)
        max_new = max(r.max_new for r in reqs)
        if s + max_new > self.max_len:
            raise ValueError(f"prompt {s} + {max_new} new tokens exceed "
                             f"max_len {self.max_len}")
        with torch.no_grad():
            logits, cache = self.prefill(batch)
            tok = logits.argmax(-1)[:, None]
            steps = []
            for step in range(max_new):
                steps.append(tok)
                logits, cache = self.decode(
                    {**batch, "tokens": tok}, cache,
                    torch.tensor(s + step, device=self.device))
                tok = logits.argmax(-1)[:, None]
        toks = torch.cat(steps, dim=1).cpu().numpy() if steps else \
            np.zeros((self.bs, 0), np.int64)
        return {r.rid: [int(t) for t in toks[i, :r.max_new]]
                for i, r in enumerate(reqs) if r.rid >= 0}


def make_requests(cfg: ModelConfig, n: int, prompt_len: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """``n`` prompts of ``prompt_len`` tokens drawn from ``seed`` (the
    reference's ``main`` inputs at its defaults)."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, prompt_len
                                               ).astype(np.int32),
                    max_new=max_new) for i in range(n)]


def main(argv=None) -> Dict[int, List[int]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="serve the real config (bfloat16)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(param_dtype="float32", act_dtype="float32")
    params = api.init_params(cfg, args.seed, args.device)
    server = BatchedServer(cfg, params, batch_size=args.requests,
                           max_len=args.max_len, device=args.device)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                         args.seed)
    t0 = time.perf_counter()
    out = server.serve(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s) on {args.device}")
    for rid, toks in out.items():
        print(f"  req {rid}: {toks}")
    return out


if __name__ == "__main__":
    main()
