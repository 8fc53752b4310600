"""The training loop: train step + checkpoint/restart + straggler monitor +
optional PowerSGD gradient compression, the port of the reference's
``repro/launch/train.py``, on one device or over the ranks of a device
mesh.

Library entry (``train``) and the CLI:

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 100 \\
        --reduced --device cpu

``--device`` defaults to ``cuda`` (no silent fallback: a missing card
raises).  The step is ``torch.autograd.grad`` of ``models.api.train_loss``
over the parameter leaves (the layers recomputed in the backward when
``cfg.remat``, the attention's backward recomputing its score tiles), then
PowerSGD (optional), the cosine schedule and AdamW; the new state is built
out of place, as the reference's donated ``jax.jit`` step.

With ``mesh=`` (a ``("data", "model")`` or ``("pod", "data", "model")``
``DeviceMesh``, or a ``launch.mesh.MeshComms``) and ``rules=`` every
rank holds its blocks of the state (``parallel/sharding.py``'s specs; FSDP
gathers a layer's parameters over ``data`` inside the layer, so remat
gathers them again in the backward), trains on its data shard's rows of
the global batch, and the backward reduces the gradients over ``data``.
Checkpoints go through rank 0 as one global state (the reference's
layout, so a mesh checkpoint restores into a one-device run and the other
way round); after a barrier every rank reads the newest complete step and
takes its blocks.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, ClassVar, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, config_digest
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import api
from repro_torch.launch.mesh import mesh_comms
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.grad_compress import (PowerSGDConfig, PowerSGDState,
                                             compress_and_reduce,
                                             init_state as psgd_init)
from repro_torch.parallel import sharding as S
from repro_torch.runtime.fault import (FailureInjector, StragglerMonitor,
                                       StepFailure, run_with_restarts)


# what ``train`` trains with: the reference's constants
OPT_CFG = adamw.AdamWConfig(lr=1e-3)
PSGD_CFG = PowerSGDConfig(rank=4, min_compress_size=4096)
WARMUP = 20


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    psgd: Optional[PowerSGDState] = None
    # checkpoint leaf paths ".params/...", as the reference's pytree
    CKPT_FIELD_PATHS: ClassVar[bool] = True


def _specs(cfg, rules, mesh):
    """The parameter specs of a mesh run (None without a mesh)."""
    if mesh is None:
        return None
    return api.param_specs(cfg, rules if rules is not None else S.Rules(),
                           mesh_comms(mesh).layout)


def build_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     rules=None, mesh=None, total_steps: int = 10000,
                     psgd_cfg: Optional[PowerSGDConfig] = None):
    """``step_fn(state, batch) -> (new_state, metrics)``: the loss and its
    gradients, PowerSGD when ``psgd_cfg``, ``cosine_schedule(step,
    warmup=WARMUP, total=total_steps)`` and ``apply_updates``.  ``metrics``
    holds ``loss``, ``grad_norm`` and ``lr`` as device tensors.  On a mesh
    ``state`` holds this rank's blocks and ``batch`` its data shard's rows;
    the loss and the norm are the global ones on every rank."""
    specs = _specs(cfg, rules, mesh)
    api.shard_ctx(cfg, rules, 1, mesh)       # a mesh it cannot run raises

    def step_fn(state: TrainState, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in adamw.tree_leaves(state.params)]
        with torch.enable_grad():
            params = adamw.tree_unflatten(state.params, leaves)
            loss = api.train_loss(cfg, params, batch, rules, mesh=mesh)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        grads = adamw.tree_unflatten(state.params, grads)
        psgd_state = state.psgd
        with torch.no_grad():
            if psgd_cfg is not None:
                # the gradients are reduced already: the compression
                # re-expresses them low-rank (error-feedback corrected),
                # as the reference's axis=None
                grads, psgd_state = compress_and_reduce(
                    psgd_cfg, grads, psgd_state, mesh=mesh, specs=specs)
            lr_scale = adamw.cosine_schedule(state.opt.step, warmup=WARMUP,
                                             total=total_steps)
            params, opt, metrics = adamw.apply_updates(
                opt_cfg, state.params, grads, state.opt, lr_scale,
                specs=specs, mesh=mesh)
        metrics["loss"] = loss.detach()
        return TrainState(params, opt, psgd_state), metrics

    return step_fn


def init_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     seed: int = 0, device="cuda", mesh=None, rules=None,
                     psgd_cfg: Optional[PowerSGDConfig] = None
                     ) -> TrainState:
    """Seeded parameters (``models.api.init_params``), zero AdamW moments
    and, with ``psgd_cfg``, seeded PowerSGD factors, on ``device``; on a
    mesh, this rank's blocks of that global state."""
    params = api.init_params(cfg, seed, device)
    psgd = psgd_init(psgd_cfg, params, seed) if psgd_cfg else None
    if mesh is not None:
        specs = _specs(cfg, rules, mesh)
        params = S.tree_local(params, specs, mesh)
        if psgd is not None:
            psgd = PowerSGDState(q=psgd.q, err=[
                None if e is None else S.local_block(e, sp, mesh)
                for e, sp in zip(psgd.err, adamw.spec_leaves(specs))])
    opt = adamw.init_state(opt_cfg, params)
    return TrainState(params, opt, psgd)


def state_global(cfg: ModelConfig, state: TrainState, rules, mesh
                 ) -> TrainState:
    """The global training state from every rank's blocks (every rank
    calls it and gets the whole state)."""
    specs = _specs(cfg, rules, mesh)
    psgd = state.psgd
    if psgd is not None:
        psgd = PowerSGDState(q=psgd.q, err=[
            None if e is None else S.assemble(e, sp, mesh)
            for e, sp in zip(psgd.err, adamw.spec_leaves(specs))])
    return TrainState(
        S.tree_assemble(state.params, specs, mesh),
        adamw.AdamWState(state.opt.step,
                         S.tree_assemble(state.opt.m, specs, mesh),
                         S.tree_assemble(state.opt.v, specs, mesh)), psgd)


def state_local(cfg: ModelConfig, state: TrainState, rules, mesh
                ) -> TrainState:
    """This rank's blocks of a global training state."""
    specs = _specs(cfg, rules, mesh)
    psgd = state.psgd
    if psgd is not None:
        psgd = PowerSGDState(q=psgd.q, err=[
            None if e is None else S.local_block(e, sp, mesh)
            for e, sp in zip(psgd.err, adamw.spec_leaves(specs))])
    return TrainState(
        S.tree_local(state.params, specs, mesh),
        adamw.AdamWState(state.opt.step,
                         S.tree_local(state.opt.m, specs, mesh),
                         S.tree_local(state.opt.v, specs, mesh)), psgd)


def train_state_from_numpy(cfg: ModelConfig, tree, device="cuda"
                           ) -> TrainState:
    """The reference's ``TrainState`` with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, state)``; any object with ``params``,
    ``opt`` holding ``step``, ``m`` and ``v``, and ``psgd`` holding ``q``
    and ``err`` lists or None) as the port's on ``device``: the parameters
    through ``api.params_from_numpy`` (shapes checked against ``cfg``),
    the moments, the step and the PowerSGD lists as tensors."""
    def tensor(a):
        return api._tensor(a, device)

    params = api.params_from_numpy(cfg, tree.params, device)
    opt = adamw.AdamWState(
        step=tensor(np.asarray(tree.opt.step, np.int32).reshape(())),
        m=adamw.tree_map(tensor, tree.opt.m),
        v=adamw.tree_map(tensor, tree.opt.v))
    for name, t in (("m", opt.m), ("v", opt.v)):
        shapes = [tuple(x.shape) for x in adamw.tree_leaves(t)]
        want = [tuple(x.shape) for x in adamw.tree_leaves(params)]
        if shapes != want:
            raise ValueError(f"{cfg.name}: AdamW {name} leaves {shapes} do "
                             f"not match the parameters' {want}")
    psgd = None
    if tree.psgd is not None:
        psgd = PowerSGDState(
            q=[None if a is None else tensor(a) for a in tree.psgd.q],
            err=[None if a is None else tensor(a) for a in tree.psgd.err])
    return TrainState(params, opt, psgd)


def train(cfg: ModelConfig, *, steps: int = 50, global_batch: int = 8,
          seq_len: int = 64, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, mesh=None, rules=None, seed: int = 0,
          use_psgd: bool = False, injector: Optional[FailureInjector] = None,
          log_every: int = 10, resume: bool = True, device="cuda"
          ) -> Dict[str, Any]:
    """Run the loop; returns the history (``loss`` per completed step,
    ``restarts``, ``stragglers``; also ``grad_norm`` and ``step_s``, the
    host seconds of each step, synchronised by reading its loss).  On a
    mesh every rank calls it with the same arguments (``ckpt_dir`` one
    directory that all of them see)."""
    opt_cfg = OPT_CFG
    psgd_cfg = PSGD_CFG if use_psgd else None
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len,
                       global_batch=global_batch, seed=seed)
    state = init_train_state(cfg, opt_cfg, seed, device, mesh, rules,
                             psgd_cfg)
    step_fn = build_train_step(cfg, opt_cfg, rules, mesh, total_steps=steps,
                               psgd_cfg=psgd_cfg)
    mc = mesh_comms(mesh)
    lead = mc is None or mc.world.rank == 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    def restore(like):
        """The newest complete step: (state, step), every rank after a
        barrier, its blocks on a mesh."""
        if mc is not None:
            mc.world.barrier()
        if mgr.latest_step() is None:
            return None, None
        restored, manifest = mgr.restore(like)
        if mc is not None:
            restored = state_local(cfg, restored, rules, mesh)
        return restored, manifest["step"]

    start = 0
    if mgr and resume:
        restored, step = restore(state)
        if restored is not None:
            state, start = restored, step

    monitor = StragglerMonitor()
    history = {"loss": [], "restarts": 0, "stragglers": 0,
               "grad_norm": [], "step_s": []}
    state_box = {"state": state}
    del state

    def make_batch(step):
        if mc is None or not (rules or S.Rules()).batch_shardable:
            return make_train_batch(cfg, data.batch(step), device)
        return make_train_batch(cfg, data.rows(step, mc.data.rank,
                                               mc.data.p), device)

    def one_step(step):
        if injector:
            injector.check(step)
        t0 = time.perf_counter()
        new_state, metrics = step_fn(state_box["state"], make_batch(step))
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise StepFailure(f"non-finite loss at step {step}")
        state_box["state"] = new_state
        dt = time.perf_counter() - t0
        if monitor.record(step, dt):
            history["stragglers"] += 1
        history["loss"].append(loss)
        history["grad_norm"].append(float(metrics["grad_norm"]))
        history["step_s"].append(dt)
        if mgr and (step + 1) % ckpt_every == 0:
            whole = state_box["state"] if mc is None else state_global(
                cfg, state_box["state"], rules, mesh)
            if lead:
                mgr.save(step + 1, whole, block=False,
                         extra={"config": config_digest(cfg)})
        if step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  {dt*1e3:.0f} ms")

    def on_restart(step):
        history["restarts"] += 1
        if mgr:
            # a save still in flight is the newest checkpoint: wait for it
            # before looking (the reference looks first, then waits)
            mgr.wait()
            restored, at = restore(state_box["state"])
            if restored is not None:
                state_box["state"] = restored
                print(f"RESTART: restored step {at}")
                return at
        print("RESTART: no checkpoint, restarting step")
        return step

    run_with_restarts(one_step, start_step=start, total_steps=steps,
                      on_restart=on_restart)
    if mgr:
        mgr.wait()
    if mc is not None:
        mc.world.barrier()
    return history


def make_train_batch(cfg: ModelConfig, tokens: np.ndarray, device
                     ) -> Dict[str, torch.Tensor]:
    """A batch of ``tokens`` [B, S+1] on ``device``, with the reference's
    zero ``img_embed`` (``vlm``) or ``frames`` (``audio``) stubs."""
    toks = torch.from_numpy(np.asarray(tokens)).to(device)
    b = {"tokens": toks}
    act = getattr(torch, cfg.act_dtype)
    if cfg.family == "vlm":
        b["img_embed"] = torch.zeros(
            (toks.shape[0], cfg.n_img_tokens, cfg.d_model), dtype=act,
            device=device)
    if cfg.family == "audio":
        b["frames"] = torch.zeros(
            (toks.shape[0], cfg.n_frames, cfg.d_model), dtype=act,
            device=device)
    return b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--psgd", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a rehearsal)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(param_dtype="float32", act_dtype="float32")
    hist = train(cfg, steps=args.steps, global_batch=args.batch,
                 seq_len=args.seq, ckpt_dir=args.ckpt, use_psgd=args.psgd,
                 device=args.device)
    print(f"final loss {hist['loss'][-1]:.4f} "
          f"(restarts={hist['restarts']}, stragglers={hist['stragglers']})")


if __name__ == "__main__":
    main()
