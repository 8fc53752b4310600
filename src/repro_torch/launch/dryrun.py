"""The LM dry run on the production layouts, the port of the reference's
``launch/dryrun.py``: every (architecture x input shape) cell's work per
device and the bytes of its arguments per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Where the reference lowers and compiles one sharded program over 512 fake
XLA devices, the port walks the GLOBAL program once on the ``meta``
device under ``perf.op_cost.count_ops`` and divides by the layout's device
count, as the reference divides its jaxpr walk (``flops_per_device``,
``bytes_per_device``).  That walk runs the models unsharded
(``rules=None``): train is ``api.train_loss``, ``torch.autograd.grad``
over the leaves and ``optim.adamw.apply_updates``; prefill is
``api.prefill`` with ``cache_len = seq_len``; decode is one
``api.decode_step`` against ``launch.shapes.abstract_cache``.

Then it walks ONE RANK's sharded program (``rank``, default 0): the same
step run under the cell's rules over ``launch.mesh.dry_mesh_comms(layout,
rank)``, a ``MeshComms`` of ``core.comm.DryComm``s, on the rank's blocks
(``rank_arguments``: ``local_block`` of the parameters by their specs, its
rows of the batch, its block of the decode cache in the layout the port's
prefill returns it).  That is the port's counterpart of the compiled,
partitioned per-device program the reference reads its compiler's fields
from: ``collectives`` (the output bytes of each collective kind, the
reference's ``hlo_cost.collective_bytes``; every Python loop iteration is
dispatched, so no loop correction is needed), ``recv_bytes_by_kind``
(what ``Comm`` counts: the bytes that crossed the wire to this rank),
``rank_flops``/``rank_matmul_flops`` (beside ``xla_flops``) and
``memory``'s ``argument_size_in_bytes`` and ``output_size_in_bytes`` (the
rank's arguments and the step's outputs).  A cell whose rank layout the
port does not take (an equal-block rule, ``zero1``'s optimizer layout)
records ``rank_skipped`` with the reason.

Every tensor is ``meta``, so the walks allocate nothing, read no value on
the host (a ``meta`` tensor has none) and launch no kernel (``count_ops``
raises if one launches).  The dry run is on ``meta`` by design; it runs no
program on any device.

``argument_bytes`` is new beside the reference's fields: the exact bytes
per device of the step's arguments (parameters, AdamW moments and step,
batch, decode cache and position), summed over ``parallel.sharding``'s
``shard_shape`` of each leaf under the cell's rules and variant, in the
reference's layout.  What only a compiler gives (``compile_s``,
``xla_flops``, ``xla_bytes_accessed``, ``memory``'s temp and code sizes,
``collectives_flat``) is listed under ``absent``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ARCHS, SHAPES, ShapeCfg, get_config, \
    shape_applicable
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import Rules, make_param_shardings, \
    mesh_axis_size, shard_shape
from repro_torch.perf import op_cost

from .mesh import MeshLayout, unravel, data_axes, dry_mesh_comms, \
    production_layout, sum_by_kind
from .shapes import abstract_cache, batch_specs, cache_spec_tree, \
    input_specs

VARIANTS = ("serve-nofsdp", "opt-bf16", "cache-2d", "zero1", "no-sp")
ABSENT = ("compile_s", "xla_flops", "xla_bytes_accessed",
          "memory.temp_size_in_bytes", "memory.generated_code_size_in_bytes",
          "collectives_flat")
# what the per-rank walk gives, absent where it did not run
RANK_FIELDS = ("collectives", "memory.argument_size_in_bytes",
               "memory.output_size_in_bytes")
ARGUMENT_BYTES_NOTE = (
    "exact per-device bytes of the step's arguments from the specs' shard "
    "shapes: the port's stand-in for XLA's argument_size_in_bytes")


def _cfg_for_dryrun(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    # the loss chunk keeps [B, chunk, V] per device manageable
    if shape_name == "train_4k":
        return dataclasses.replace(cfg, loss_chunk=512)
    return cfg


def cell_rules(cfg: ModelConfig, shape: ShapeCfg, layout: MeshLayout,
               variant: Optional[str] = None) -> Rules:
    """The rules ``lower_cell`` builds for a cell: KV heads over the model
    axis when they divide it, the batch over the data axes when it
    divides them, FSDP off for ``serve-nofsdp`` serving, the decode cache
    over (data x model) for ``cache-2d`` when the batch cannot use the data
    axes, no sequence parallelism for ``no-sp``."""
    msize = layout.axis_size("model")
    daxes = data_axes(layout)
    dsize = mesh_axis_size(layout, daxes)
    return Rules(
        data_axes=daxes, model_axis="model",
        attn_tp=cfg.n_kv_heads % msize == 0,
        batch_shardable=shape.global_batch % dsize == 0,
        fsdp=not (variant == "serve-nofsdp" and shape.kind != "train"),
        seq_axes_decode=(daxes + ("model",) if variant == "cache-2d" and
                         shape.global_batch % dsize else None),
        seq_parallel=variant != "no-sp")


def _pairs(tree, specs):
    """(leaf, spec) of two trees of one structure (specs are tuples)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            yield from _pairs(t, s)
    else:
        yield tree, specs


def sharded_bytes(tree, specs, layout: MeshLayout,
                  dtype: Optional[torch.dtype] = None) -> int:
    """One device's bytes of ``tree`` laid out by ``specs`` (in ``dtype``
    when given, else each leaf's own)."""
    return sum(math.prod(shard_shape(leaf.shape, spec, layout)) *
               (dtype or leaf.dtype).itemsize
               for leaf, spec in _pairs(tree, specs))


def argument_bytes(cfg: ModelConfig, shape: ShapeCfg, layout: MeshLayout,
                   variant: Optional[str], params, batch, cache=None
                   ) -> Dict[str, int]:
    """Per-device bytes of the cell's arguments by part, and their
    ``total``: ``params`` (replicated over the data axes under ``zero1``),
    train's ``moments`` (m and v in the master dtype, bfloat16 under
    ``opt-bf16``; still FSDP under ``zero1``) and ``step``, the ``batch``,
    decode's ``cache`` (sequence over (data x model) under ``cache-2d``)
    and ``pos``."""
    rules = cell_rules(cfg, shape, layout, variant)
    p_rules = dataclasses.replace(rules, fsdp=False) \
        if variant == "zero1" else rules
    psh = make_param_shardings(params, p_rules, layout)
    out = {"params": sharded_bytes(params, psh, layout)}
    if shape.kind == "train":
        msh = make_param_shardings(params, rules, layout) \
            if variant == "zero1" else psh
        master = torch.bfloat16 if variant == "opt-bf16" else torch.float32
        out["moments"] = 2 * sharded_bytes(params, msh, layout, master)
        out["step"] = 4
    out["batch"] = sharded_bytes(batch, batch_specs(cfg, shape, rules),
                                 layout)
    if cache is not None:
        msize = layout.axis_size("model")
        dsize = mesh_axis_size(layout, rules.data_axes)
        out["cache"] = sharded_bytes(cache, cache_spec_tree(
            cfg, cache, rules, msize=msize, dsize=dsize,
            seq_2d=variant == "cache-2d"), layout)
        out["pos"] = 4
    out["total"] = sum(out.values())
    return out


def _program(cfg: ModelConfig, shape: ShapeCfg, variant: Optional[str],
             params, batch, cache, rules: Optional[Rules] = None,
             mesh=None, opt=None, pos=None):
    """The cell's program as a thunk: the global one over ``meta``
    arguments, or with ``mesh`` (a ``MeshComms`` or ``DeviceMesh``) and
    ``rules`` one rank's over its blocks.  Train returns ``((params,
    opt, metrics), loss)``, prefill and decode ``(logits, cache)``.
    ``opt`` (train) and ``pos`` (decode) default to zero moments and a
    ``meta`` position."""
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(
            master_dtype="bfloat16" if variant == "opt-bf16" else "float32")
        opt = adamw.init_state(opt_cfg, params) if opt is None else opt
        specs = None if mesh is None else api.param_specs(
            cfg, rules, S.mesh_comms(mesh).layout)
        leaves = [p.detach().requires_grad_(True)
                  for p in adamw.tree_leaves(params)]
        tracked = adamw.tree_unflatten(params, leaves)

        def train_step():
            with torch.enable_grad():
                loss = api.train_loss(cfg, tracked, batch, rules, mesh=mesh)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            with torch.no_grad():
                return adamw.apply_updates(
                    opt_cfg, params, adamw.tree_unflatten(params, grads),
                    opt, specs=specs, mesh=mesh), loss
        return train_step
    if shape.kind == "prefill":
        def prefill_step():
            with torch.no_grad():
                return api.prefill(cfg, params, batch, rules,
                                   cache_len=shape.seq_len, mesh=mesh)
        return prefill_step
    if pos is None:
        pos = torch.empty((), dtype=torch.int32, device="meta")

    def serve_step():
        with torch.no_grad():
            return api.decode_step(cfg, params, batch, cache, pos, rules,
                                   mesh=mesh)
    return serve_step


def abstract_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                         psgd_cfg=None):
    """``launch.train.init_train_state``'s state on ``meta``: the
    parameters, zero AdamW moments and, with ``psgd_cfg``, the PowerSGD
    factors and error feedback, nothing allocated (a walk of
    ``launch.train.build_train_step`` takes it)."""
    from repro_torch.launch.train import TrainState
    from repro_torch.optim.grad_compress import init_state as psgd_init
    params = api.abstract_params(cfg)
    psgd = psgd_init(psgd_cfg, params, api._ShapeOnly()) if psgd_cfg \
        else None
    return TrainState(params, adamw.init_state(opt_cfg, params), psgd)


def walk(cfg: ModelConfig, shape: ShapeCfg, variant: Optional[str] = None,
         params=None, batch=None, cache=None) -> Dict[str, Any]:
    """One walk of the cell's global program on ``meta``: per-operator
    counts (``op_cost.count_ops``) and the walk's wall seconds."""
    params = api.abstract_params(cfg) if params is None else params
    batch = input_specs(cfg, shape) if batch is None else batch
    if shape.kind == "decode" and cache is None:
        cache = abstract_cache(cfg, shape, params)
    fn = _program(cfg, shape, variant, params, batch, cache)
    t0 = time.perf_counter()
    per_op = op_cost.count_ops(fn)
    return {"per_op": per_op, "walk_s": time.perf_counter() - t0}


def _local(tree, specs, mc):
    """``local_block`` of every leaf of a nested dict/list/tuple tree by
    a spec tree of the same structure (spec tuples as leaves)."""
    if isinstance(tree, dict):
        return {k: _local(v, specs[k], mc) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local(t, sp, mc) for t, sp in zip(tree, specs))
    return S.local_block(tree, specs, mc)


def tree_bytes(*trees) -> int:
    """Bytes of every distinct tensor in ``trees`` (nested dicts, lists,
    tuples, NamedTuples; a tensor met twice counts once)."""
    leaves = {id(t): t for t in tree_leaves(trees)
              if isinstance(t, torch.Tensor)}
    return sum(t.numel() * t.element_size() for t in leaves.values())


def rank_arguments(cfg: ModelConfig, shape: ShapeCfg, rules: Rules, mc,
                   params, batch, cache=None) -> Dict[str, Any]:
    """One rank's arguments of the cell's step on ``mc`` (a
    ``MeshComms``) from the global ``meta`` ones: the parameters' blocks
    by ``api.param_specs``, the rank's rows of the batch
    (``batch_specs``), its block of the decode cache in the layout the
    port's sharded prefill returns (``api.cache_specs``).  Raises
    ``ValueError`` where a dim does not split into equal blocks."""
    out = {"params": _local(params, api.param_specs(cfg, rules, mc.layout),
                            mc),
           "batch": _local(batch, batch_specs(cfg, shape, rules), mc),
           "cache": None}
    if cache is not None:
        out["cache"] = _local(cache, api.cache_specs(cfg, cache, rules, mc),
                              mc)
    return out


def rank_walk(cfg: ModelConfig, shape: ShapeCfg, layout: MeshLayout,
              rank: int = 0, variant: Optional[str] = None, params=None,
              batch=None, cache=None, rules: Optional[Rules] = None
              ) -> Dict[str, Any]:
    """One walk of rank ``rank``'s sharded program of the cell on
    ``meta`` over ``dry_mesh_comms(layout, rank)`` under ``rules``
    (default ``cell_rules``): per-operator counts, the collectives' bytes
    by kind (``out``: output bytes; ``recv``: received bytes), the
    rank's argument and output bytes, the walk's wall seconds.  Raises
    ``ValueError`` for a rank layout the port does not take and
    ``NotImplementedError`` for ``zero1``."""
    if variant == "zero1":
        raise NotImplementedError(
            "zero1: the parameters replicated over data with the AdamW "
            "moments sharded over it; the port's AdamW updates blocks of "
            "the parameters' own layout")
    rules = cell_rules(cfg, shape, layout, variant) if rules is None \
        else rules
    params = api.abstract_params(cfg) if params is None else params
    batch = input_specs(cfg, shape) if batch is None else batch
    if shape.kind == "decode" and cache is None:
        cache = abstract_cache(cfg, shape, params)
    mc = dry_mesh_comms(layout, rank)
    args = rank_arguments(cfg, shape, rules, mc, params, batch, cache)
    opt = pos = None
    if shape.kind == "train":
        opt = adamw.init_state(adamw.AdamWConfig(
            master_dtype="bfloat16" if variant == "opt-bf16"
            else "float32"), args["params"])
    elif shape.kind == "decode":
        pos = torch.empty((), dtype=torch.int32, device="meta")
    fn = _program(cfg, shape, variant, args["params"], args["batch"],
                  args["cache"], rules, mc, opt=opt, pos=pos)
    got = []
    mc.reset_counts()
    t0 = time.perf_counter()
    per_op = op_cost.count_ops(lambda: got.append(fn()))
    walk_s = time.perf_counter() - t0
    out = got[0]
    if shape.kind == "train":               # (params, opt, loss)
        (new_p, new_opt, _), loss = out
        out = (new_p, new_opt, loss)
    return {"per_op": per_op, "walk_s": walk_s,
            "out": sum_by_kind(mc.bytes_by_kind(out=True)),
            "recv": sum_by_kind(mc.bytes_by_kind()),
            "argument_bytes": tree_bytes(args, opt, pos),
            "output_bytes": tree_bytes(out),
            "coords": dict(zip(layout.axes, unravel(rank, layout.shape)))}


def dry_cell(arch: str, shape_name: str, *,
             layout: Optional[MeshLayout] = None,
             variant: Optional[str] = None, n_layers: Optional[int] = None,
             seq_len: Optional[int] = None,
             walks: Optional[Dict] = None,
             rank: Optional[int] = 0) -> Dict[str, Any]:
    """One cell's per-device work and argument bytes on ``layout``
    (default the single pod): the counterpart of the reference's
    ``lower_cell``, with its rules (``cell_rules``) and ``variant``s:

      serve-nofsdp -- params replicated over the data axes at serve time
      opt-bf16     -- AdamW moments in bfloat16
      cache-2d     -- long-context decode cache sequence-sharded over
                      (data x model) instead of model only
      zero1        -- params replicated over data, moments still FSDP
      no-sp        -- no sequence parallelism

    ``n_layers`` and ``seq_len`` cut the config's depth and the shape's
    length (recorded under ``cut``).  ``walks`` caches the program's walk
    across layouts and variants that run the same program (the walk
    depends on neither but ``opt-bf16``); ``walk_reused`` says a cell
    took its walk (and ``walk_s``) from there.  ``rank`` (None: skipped)
    adds the per-rank walk's fields (``rank_walk``), its walk cached in
    ``walks`` by layout and variant too."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    layout = layout or production_layout()
    cfg = _cfg_for_dryrun(get_config(arch), shape_name)
    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    shape = SHAPES[shape_name]
    cut = {}
    if n_layers is not None and n_layers != cfg.n_layers:
        cut["n_layers"] = [n_layers, cfg.n_layers]
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if seq_len is not None and seq_len != shape.seq_len:
        cut["seq_len"] = [seq_len, shape.seq_len]
        shape = dataclasses.replace(shape, seq_len=seq_len)

    params = api.abstract_params(cfg)
    batch = input_specs(cfg, shape)
    cache = abstract_cache(cfg, shape, params) \
        if shape.kind == "decode" else None
    wvar = variant if variant == "opt-bf16" and shape.kind == "train" \
        else None
    key = (arch, shape_name, wvar, n_layers, seq_len)
    reused = walks is not None and key in walks
    if reused:
        w = walks[key]
    else:
        w = walk(cfg, shape, wvar, params, batch, cache)
        if walks is not None:
            walks[key] = w
    per_op = w["per_op"]
    n_dev = layout.size
    flops = sum(r["flops"] for r in per_op.values())
    nbytes = sum(r["bytes"] for r in per_op.values())
    mm = op_cost.matmul_flops(per_op)
    res = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "variant": variant, "mesh": dict(zip(layout.axes, layout.shape)),
        "n_devices": n_dev, "cut": cut,
        "flops_global": flops, "bytes_global": nbytes,
        "matmul_flops_global": mm,
        "flops_per_device": flops / n_dev,
        "bytes_per_device": nbytes / n_dev,
        "matmul_flops_per_device": mm / n_dev,
        "dispatches": int(sum(r["calls"] for r in per_op.values())),
        "walk_s": w["walk_s"], "walk_reused": reused,
        "argument_bytes": argument_bytes(cfg, shape, layout, variant,
                                         params, batch, cache),
        "argument_bytes_note": ARGUMENT_BYTES_NOTE,
        "absent": list(ABSENT) + list(RANK_FIELDS),
    }
    if rank is None:
        return res
    res["rank"] = rank
    rkey = key[:2] + (variant,) + key[3:] + (layout, rank)
    if walks is not None and rkey in walks:
        rw = walks[rkey]
    else:
        try:
            rw = rank_walk(cfg, shape, layout, rank, variant, params, batch,
                           cache)
        except (ValueError, NotImplementedError) as e:
            rw = {"skipped": f"{type(e).__name__}: {e}"}
        if walks is not None:
            walks[rkey] = rw
    if "skipped" in rw:
        res["rank_skipped"] = rw["skipped"]
        return res
    rops = rw["per_op"]
    res.update({
        "rank_coords": rw["coords"],
        "rank_flops": sum(r["flops"] for r in rops.values()),
        "rank_matmul_flops": op_cost.matmul_flops(rops),
        "rank_bytes": sum(r["bytes"] for r in rops.values()),
        "rank_dispatches": int(sum(r["calls"] for r in rops.values())),
        "rank_walk_s": rw["walk_s"],
        "collectives": rw["out"],
        "recv_bytes_by_kind": rw["recv"],
        "memory": {"argument_size_in_bytes": rw["argument_bytes"],
                   "output_size_in_bytes": rw["output_bytes"]},
        "absent": list(ABSENT)})
    return res


def run_cells(archs: Sequence[str], shapes: Sequence[str], *,
              multi_pod: bool = False, out_path: Optional[str] = None,
              walks: Optional[Dict] = None) -> List[Dict[str, Any]]:
    """Every (arch x shape) cell on one production layout, with rank 0's
    walk; a failed cell is recorded with its error, a skipped one with
    its reason."""
    layout = production_layout(multi_pod=multi_pod)
    walks = {} if walks is None else walks
    results = []
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch} x {shape_name} x " \
                  f"{'2pod' if multi_pod else '1pod'}"
            try:
                r = dry_cell(arch, shape_name, layout=layout, walks=walks)
                if "skipped" in r:
                    print(f"SKIP {tag}: {r['skipped']}", flush=True)
                else:
                    print(f"OK   {tag}: "
                          f"flops/dev={r['flops_per_device']:.3e} "
                          f"matmul/dev={r['matmul_flops_per_device']:.3e} "
                          f"bytes/dev={r['bytes_per_device']:.3e} "
                          f"args/dev={r['argument_bytes']['total']} "
                          f"walk={r['walk_s']:.1f}s", flush=True)
                    if "rank_skipped" in r:
                        print(f"     rank 0 skipped: {r['rank_skipped']}",
                              flush=True)
                    else:
                        print(f"     rank 0: "
                              f"matmul={r['rank_matmul_flops']:.3e} "
                              f"collectives={r['collectives']} "
                              f"memory={r['memory']} "
                              f"walk={r['rank_walk_s']:.1f}s", flush=True)
            except Exception as e:                # record and go on
                r = {"arch": arch, "shape": shape_name,
                     "error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()[-2000:]}
                print(f"FAIL {tag}: {r['error']}", flush=True)
            r["multi_pod"] = multi_pod
            results.append(r)
            if out_path:
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-compile", action="store_true",
                    help="accepted for the reference's CLI; does nothing "
                         "(the port walks on meta and never compiles)")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    walks: Dict = {}
    t0 = time.perf_counter()
    results = run_cells(archs, shapes, multi_pod=args.multi_pod,
                        out_path=args.out, walks=walks)
    if args.both_meshes:
        results += run_cells(archs, shapes, multi_pod=True,
                             out_path=args.out.replace(".json", "_2pod.json"),
                             walks=walks)
    n_ok = sum(1 for r in results if "flops_per_device" in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    n_fail = sum(1 for r in results if "error" in r)
    n_rank = sum(1 for r in results if "rank_skipped" in r)
    print(f"\n{n_ok} ok, {n_skip} skipped, {n_fail} failed in "
          f"{time.perf_counter() - t0:.1f} s"
          + (f"; {n_rank} rank walks skipped" if n_rank else ""))
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
