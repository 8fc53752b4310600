"""PyTorch port: the LM dry run (``repro_torch.launch.dryrun``) against the
reference's ``launch/dryrun.py``.

The reference's values come from one subprocess (``_REF_SCRIPT``): it
imports ``repro.launch.dryrun``, which sets ``XLA_FLAGS`` to 512 host
devices (they must not leak into this process), builds each cell's
``Rules`` and production mesh as ``lower_cell`` does, and returns

  * the trip-count-corrected ``dot_general`` flops of the cell's jaxpr
    (``perf/jaxpr_cost.count_jaxpr``'s rules: scans times their length,
    ``shard_map`` bodies times the mesh size), traced with the mesh;
  * the per-device bytes of the step's arguments, summed over
    ``NamedSharding(mesh, spec).shard_shape`` of every leaf.

Depth and length are cut for time (``dataclasses.replace`` on both
sides): the dense, MoE and RWKV6 cells run 2 layers, Zamba2 7 (one group
of 6 and a tail of 1), Llama-3.2-Vision 5 (one cross layer), Whisper whole;
the RWKV6 and Zamba2 prefill cells run 256 tokens and their train cells
128 (their chunk loops walk once per chunk).  Widths, batches and the
other lengths are the shapes' own.

Held here:

- matrix-product flops of the prefill and decode cells equal the
  reference's, and so do the train cells', apart from the differences
  ROADMAP Queue 3 states, each held by its formula (``_gap``): the MoE's
  expert-parallel ``shard_map`` (the router per model shard, the
  capacity per data shard), the outer products and RWKV6's bonus
  ``einsum`` that the reference writes as ``dot_general`` and
  ``torch.einsum`` dispatches as an elementwise ``mul``, and the chunk
  steps' second recompute under nested ``torch.utils.checkpoint``;
- per-device argument bytes equal the reference's shard shapes' bytes,
  part by part, in every variant tried;
- each variant moves the bytes it should, the walk stays on ``meta`` and
  launches nothing, and the CLI writes its JSON.

Two cells of the reference do not trace under its mesh on this JAX (a
``ShardingTypeError``; ``lower_cell`` fails there too): the MoE's train
step (a contraction over data-sharded dims in the backward) and Zamba2's
long_500k decode (its attention cache update).  Their flops come from the
reference traced without a mesh (no ``shard_map``: the MoE's train cell
then equals the port's), and the test requires them to be the only such
cells.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD
from repro_torch.models.moe import _capacity
from repro_torch.parallel.sharding import mesh_axis_size

torch.set_num_threads(2)

REF_TIMEOUT_S = 600
REF_MESH_FAILS = {("qwen3-moe-30b-a3b", "train_4k"),
                  ("zamba2-7b", "long_500k")}
RWKV_CHUNK, SSD_CHUNK = 16, 64

# (arch, shape, n_layers, seq_len, variant, multi_pod, flops?)
CELLS = [
    ("qwen3-0.6b", "train_4k", 2, None, None, False, True),
    ("qwen3-0.6b", "prefill_32k", 2, None, None, False, True),
    ("qwen3-0.6b", "decode_32k", 2, None, None, False, True),
    ("qwen3-0.6b", "train_4k", 2, None, None, True, True),
    ("qwen1.5-4b", "prefill_32k", 2, None, None, False, True),
    ("qwen3-moe-30b-a3b", "train_4k", 2, None, None, False, True),
    ("qwen3-moe-30b-a3b", "prefill_32k", 2, None, None, False, True),
    ("qwen3-moe-30b-a3b", "decode_32k", 2, None, None, False, True),
    ("qwen3-moe-30b-a3b", "decode_32k", 2, None, None, True, True),
    ("grok-1-314b", "decode_32k", 2, None, None, False, True),
    ("rwkv6-7b", "train_4k", 2, 128, None, False, True),
    ("rwkv6-7b", "prefill_32k", 2, 256, None, False, True),
    ("rwkv6-7b", "decode_32k", 2, None, None, False, True),
    ("rwkv6-7b", "long_500k", 2, None, None, False, True),
    ("zamba2-7b", "train_4k", 7, 128, None, False, True),
    ("zamba2-7b", "prefill_32k", 7, 256, None, False, True),
    ("zamba2-7b", "decode_32k", 7, None, None, False, True),
    ("zamba2-7b", "long_500k", 7, None, None, True, True),
    ("llama-3.2-vision-11b", "train_4k", 5, None, None, False, True),
    ("llama-3.2-vision-11b", "prefill_32k", 5, None, None, False, True),
    ("llama-3.2-vision-11b", "decode_32k", 5, None, None, False, True),
    ("whisper-tiny", "train_4k", None, None, None, False, True),
    ("whisper-tiny", "prefill_32k", None, None, None, False, True),
    ("whisper-tiny", "decode_32k", None, None, None, False, True),
    # the variants: argument bytes only
    ("qwen3-0.6b", "train_4k", 2, None, "zero1", False, False),
    ("qwen3-0.6b", "train_4k", 2, None, "zero1", True, False),
    ("qwen3-0.6b", "train_4k", 2, None, "opt-bf16", False, False),
    ("qwen3-0.6b", "decode_32k", 2, None, "serve-nofsdp", False, False),
    ("qwen3-0.6b", "prefill_32k", 2, None, "no-sp", False, False),
    ("rwkv6-7b", "long_500k", 2, None, "cache-2d", False, False),
    ("zamba2-7b", "long_500k", 7, None, "cache-2d", False, False),
    ("zamba2-7b", "long_500k", 7, None, "cache-2d", True, False),
]
FLOP_CELLS = [c for c in CELLS if c[-1]]

_REF_SCRIPT = r"""
import dataclasses, json, sys
import repro.launch.dryrun as R           # sets XLA_FLAGS: 512 host devices
import jax, jax.numpy as jnp
import jax._src.core as jcore
import numpy as np
from jax.sharding import NamedSharding
from repro.configs.base import SHAPES, get_config
from repro.launch.mesh import make_production_mesh, data_axes
from repro.launch.shapes import (abstract_cache, batch_specs,
                                 cache_spec_tree, input_specs)
from repro.models import api
from repro.optim import adamw
from repro.parallel.sharding import Rules, make_param_shardings
from repro.perf import jaxpr_cost as J

CALLS = ("pjit", "jit", "closed_call", "core_call", "remat_call", "xla_call",
         "custom_jvp_call", "custom_vjp_call", "custom_vjp_call_jaxpr",
         "checkpoint", "remat", "remat2")

def dots(jaxpr):
    tot = 0
    for eqn in jaxpr.eqns:
        p = eqn.primitive.name
        if p == "dot_general":
            tot += J._dot_flops(eqn)
        elif p == "scan":
            tot += eqn.params["length"] * dots(eqn.params["jaxpr"].jaxpr)
        elif p == "while":
            tot += dots(eqn.params["body_jaxpr"].jaxpr)
        elif p == "cond":
            tot += max(dots(b.jaxpr) for b in eqn.params["branches"])
        elif p in CALLS:
            sub = (eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
                   or eqn.params.get("fun_jaxpr"))
            if sub is not None:
                tot += dots(getattr(sub, "jaxpr", sub))
        elif p == "shard_map":
            sub = eqn.params["jaxpr"]
            tot += J._mesh_size(eqn.params) * dots(getattr(sub, "jaxpr", sub))
    return tot

def nbytes(sds, shardings):
    leaves = jax.tree.leaves(shardings,
                             is_leaf=lambda x: isinstance(x, NamedSharding))
    return sum(int(np.prod(sh.shard_shape(x.shape))) *
               jnp.dtype(x.dtype).itemsize
               for x, sh in zip(jax.tree.leaves(sds), leaves))

meshes = {}

def cell(arch, shape_name, n_layers, seq_len, variant, multi_pod, flops):
    cfg = R._cfg_for_dryrun(get_config(arch), shape_name)
    shape = SHAPES[shape_name]
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    if multi_pod not in meshes:
        meshes[multi_pod] = make_production_mesh(multi_pod=multi_pod)
    mesh = meshes[multi_pod]
    msize = mesh.shape["model"]
    daxes = data_axes(mesh)
    dsize = int(np.prod([mesh.shape[a] for a in daxes]))
    rules = Rules(data_axes=daxes, model_axis="model",
                  attn_tp=(cfg.n_kv_heads % msize == 0),
                  batch_shardable=(shape.global_batch % dsize == 0),
                  fsdp=not (variant == "serve-nofsdp" and
                            shape.kind != "train"),
                  seq_axes_decode=(tuple(daxes) + ("model",)
                                   if variant == "cache-2d" and
                                   shape.global_batch % dsize else None),
                  seq_parallel=(variant != "no-sp"))
    params = api.abstract_params(cfg)
    p_rules = dataclasses.replace(rules, fsdp=False) \
        if variant == "zero1" else rules
    param_sh = make_param_shardings(params, p_rules, mesh)
    batch = input_specs(cfg, shape)
    batch_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                            batch_specs(cfg, shape, rules))
    args = {"params": nbytes(params, param_sh),
            "batch": nbytes(batch, batch_sh)}
    out = {}
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(master_dtype="bfloat16"
                                    if variant == "opt-bf16" else "float32")
        opt = jax.eval_shape(lambda p: adamw.init_state(opt_cfg, p), params)
        msh = make_param_shardings(params, rules, mesh) \
            if variant == "zero1" else param_sh
        args["moments"] = nbytes(opt.m, msh) + nbytes(opt.v, msh)
        args["step"] = 4

        def fn(params, opt, batch, rules=rules, msize=msize, mesh=mesh):
            loss, grads = jax.value_and_grad(lambda p: api.train_loss(
                cfg, p, batch, rules, msize, mesh))(params)
            return adamw.apply_updates(opt_cfg, params, grads, opt), loss
        fargs = (params, opt, batch)
    elif shape.kind == "prefill":
        def fn(params, batch, rules=rules, msize=msize, mesh=mesh):
            return api.prefill(cfg, params, batch, rules, msize, mesh,
                               cache_len=shape.seq_len)
        fargs = (params, batch)
    else:
        cache = abstract_cache(cfg, shape)
        cache_sh = jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            cache_spec_tree(cfg, cache, rules, msize=msize, dsize=dsize,
                            seq_2d=(variant == "cache-2d")))
        args["cache"] = nbytes(cache, cache_sh)
        args["pos"] = 4

        def fn(params, batch, cache, pos, rules=rules, msize=msize,
               mesh=mesh):
            return api.decode_step(cfg, params, batch, cache, pos, rules,
                                   msize, mesh)
        fargs = (params, batch, cache, jax.ShapeDtypeStruct((), jnp.int32))
    if flops:
        with mesh:
            try:
                out["dots"] = dots(jax.make_jaxpr(fn)(*fargs).jaxpr)
            except jcore.ShardingTypeError as e:
                out["mesh_error"] = f"{type(e).__name__}: {str(e)[:160]}"
                out["dots"] = dots(jax.make_jaxpr(
                    lambda *a: fn(*a, rules=None, msize=1, mesh=None))(
                        *fargs).jaxpr)
    args["total"] = sum(args.values())
    out["args"] = args
    return out

cells = json.loads(sys.argv[1])
print(json.dumps([cell(*c) for c in cells]))
"""


def _key(c) -> str:
    return "-".join(str(x) for x in c[:6])


@pytest.fixture(scope="module")
def ref_cells():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                          json.dumps(CELLS)], env=env, capture_output=True,
                         text=True, timeout=REF_TIMEOUT_S, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {_key(c): r for c, r in zip(CELLS, res)}


@pytest.fixture(scope="module")
def walks():
    return {}


def _port(c, walks):
    arch, shape, n_layers, seq_len, variant, multi_pod, _ = c
    return D.dry_cell(arch, shape, layout=MULTI_POD if multi_pod
                      else SINGLE_POD, variant=variant, n_layers=n_layers,
                      seq_len=seq_len, walks=walks)


def _gap(arch, shape_name, n_layers, seq_len, multi_pod) -> int:
    """The reference's matrix-product flops less the port's, for the
    differences ROADMAP Queue 3 states (0 elsewhere)."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    shape = SHAPES[shape_name]
    b, t = shape.global_batch, seq_len or shape.seq_len
    kind = shape.kind
    lay = MULTI_POD if multi_pod else SINGLE_POD
    n_l = cfg.n_layers
    if cfg.moe and kind != "train":
        # (train: the reference is traced without its mesh, REF_MESH_FAILS)
        # the reference's shard_map: every device routes its data shard's
        # tokens over all E experts and runs its E*v/msize virtual experts
        # at the capacity of its shard's tokens; the port, one layer over
        # all tokens
        rules = D.cell_rules(cfg, shape, lay)
        msize = lay.axis_size("model")
        dsize = mesh_axis_size(lay, rules.data_axes) \
            if rules.batch_shardable else 1
        tok = b * t if kind == "prefill" else b
        t_loc = tok // dsize
        e, d = cfg.n_experts, cfg.d_model
        v = max(cfg.moe_virtual, 1)
        fw = cfg.moe_d_ff // v
        mats = 3 if cfg.act == "swiglu" else 2
        router = (lay.size * t_loc - tok) * 2 * d * e
        experts = (lay.size * (e * v // msize) * _capacity(cfg, t_loc)
                   - e * v * _capacity(cfg, tok)) * 2 * d * fw * mats
        return n_l * (router + experts)
    if cfg.family == "rwkv":
        h, n = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        if kind == "decode":       # k v^T: an outer product a layer
            return n_l * 2 * b * h * n * n
        bonus = 4 * b * t * h * n  # einsum(r, u, k): two dot_generals
        if kind == "prefill":
            return n_l * bonus
        nc = t // RWKV_CHUNK       # train: fwd, recompute, 2 backward
        return n_l * (4 * bonus -
                      (2 * nc - 3) * 2 * b * RWKV_CHUNK * h * n * n)
    if cfg.family == "hybrid":
        p, n = cfg.mamba_head_dim, cfg.ssm_state
        h = 2 * cfg.d_model // p
        if kind == "decode":       # x B^T: an outer product a layer
            return n_l * 2 * b * h * p * n
        if kind == "train":
            nc = t // SSD_CHUNK
            return -n_l * (2 * nc - 3) * 2 * b * SSD_CHUNK * h * p * n
    return 0


@pytest.mark.parametrize("cell", FLOP_CELLS, ids=_key)
def test_matmul_flops_equal_reference(ref_cells, walks, cell):
    ref = ref_cells[_key(cell)]
    r = _port(cell, walks)
    gap = _gap(cell[0], cell[1], cell[2], cell[3], cell[5])
    assert r["matmul_flops_global"] + gap == ref["dots"], (
        cell, r["matmul_flops_global"], ref["dots"], gap)
    assert r["matmul_flops_per_device"] * r["n_devices"] == \
        pytest.approx(r["matmul_flops_global"], rel=1e-12)
    assert r["flops_per_device"] == r["flops_global"] / r["n_devices"]
    assert r["flops_global"] > r["matmul_flops_global"] > 0
    # the only cells the reference cannot trace under its mesh
    assert ("mesh_error" in ref) == (cell[:2] in REF_MESH_FAILS), ref


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_argument_bytes_equal_reference(ref_cells, walks, cell):
    ref = ref_cells[_key(cell)]["args"]
    got = _port(cell, walks)["argument_bytes"]
    assert got == ref, (cell, got, ref)


def test_gaps_are_what_queue_3_states():
    """The formulas are not vacuous: the MoE's shard_map and the recurrent
    families' outer products and recomputes move the counts."""
    assert _gap("qwen3-moe-30b-a3b", "decode_32k", 2, None, False) > 0
    assert _gap("grok-1-314b", "decode_32k", 2, None, False) > 0
    assert _gap("qwen3-moe-30b-a3b", "train_4k", 2, None, False) == 0
    assert _gap("rwkv6-7b", "train_4k", 2, 128, False) < 0
    assert _gap("zamba2-7b", "prefill_32k", 7, 256, False) == 0
    assert _gap("qwen3-0.6b", "decode_32k", 2, None, False) == 0


def test_variants_move_argument_bytes(walks):
    def args(arch, shape, variant, n_layers=2, multi_pod=False):
        return _port((arch, shape, n_layers, None, variant, multi_pod,
                      False), walks)["argument_bytes"]
    base = args("qwen3-0.6b", "train_4k", None)
    bf16 = args("qwen3-0.6b", "train_4k", "opt-bf16")
    assert bf16["moments"] * 2 == base["moments"]
    assert bf16["params"] == base["params"]
    zero1 = args("qwen3-0.6b", "train_4k", "zero1")
    assert zero1["params"] > base["params"]
    assert zero1["moments"] == base["moments"]
    serve = args("qwen3-0.6b", "decode_32k", None)
    nofsdp = args("qwen3-0.6b", "decode_32k", "serve-nofsdp")
    assert nofsdp["params"] > serve["params"]
    assert nofsdp["cache"] == serve["cache"]
    # serve-nofsdp leaves training alone
    assert args("qwen3-0.6b", "train_4k", "serve-nofsdp") == base
    for multi_pod in (False, True):
        long_ = args("zamba2-7b", "long_500k", None, 7, multi_pod)
        twod = args("zamba2-7b", "long_500k", "cache-2d", 7, multi_pod)
        assert twod["cache"] < long_["cache"]
        assert twod["params"] == long_["params"]
    # no-sp changes activations only
    assert args("qwen3-0.6b", "prefill_32k", "no-sp") == \
        args("qwen3-0.6b", "prefill_32k", None)


def test_walks_are_shared_across_layouts_and_variants(walks):
    a = _port(("qwen3-0.6b", "train_4k", 2, None, None, False, True), walks)
    b = _port(("qwen3-0.6b", "train_4k", 2, None, "zero1", True, True),
              walks)
    c = _port(("qwen3-0.6b", "train_4k", 2, None, "opt-bf16", False, True),
              walks)
    assert b["walk_reused"] and a["flops_global"] == b["flops_global"]
    assert b["flops_per_device"] * 2 == a["flops_per_device"]
    assert c["matmul_flops_global"] == a["matmul_flops_global"]
    assert c["bytes_global"] < a["bytes_global"]     # bfloat16 moments


class _Devices(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_walk_stays_on_meta_and_launches_nothing(shape):
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=1)
    sh = SHAPES[shape]
    params = D.api.abstract_params(cfg)
    batch = D.input_specs(cfg, sh)
    cache = D.abstract_cache(cfg, sh, params) if sh.kind == "decode" \
        else None
    fn = D._program(cfg, sh, None, params, batch, cache)
    before = dict(ops.launch_counts())
    mode = _Devices()
    with mode:
        fn()
    assert mode.devices == {"meta"}
    assert dict(ops.launch_counts()) == before


def test_dry_cell_skips_and_refuses():
    r = D.dry_cell("qwen3-0.6b", "long_500k")
    assert "skipped" in r and "sub-quadratic" in r["skipped"]
    with pytest.raises(ValueError, match="unknown variant"):
        D.dry_cell("qwen3-0.6b", "train_4k", variant="fp8")
    r = D.dry_cell("whisper-tiny", "decode_32k")
    assert r["absent"] == list(D.ABSENT) and r["cut"] == {}
    assert "argument_size_in_bytes" in r["argument_bytes_note"]
    assert r["mesh"] == {"data": 16, "model": 16}


def test_cli_writes_json(tmp_path, capsys):
    out = tmp_path / "dry.json"
    rc = D.main(["--arch", "whisper-tiny", "--both-meshes", "--no-compile",
                 "--out", str(out)])
    assert rc == 0
    one = json.loads(out.read_text())
    two = json.loads((tmp_path / "dry_2pod.json").read_text())
    assert [r["shape"] for r in one] == list(SHAPES)
    assert sum("skipped" in r for r in one) == 1          # long_500k
    assert all(r["multi_pod"] for r in two)
    for a, b in zip(one, two):
        if "skipped" in a:
            continue
        assert b["walk_reused"] and a["flops_global"] == b["flops_global"]
        assert math.isclose(a["flops_per_device"],
                            2 * b["flops_per_device"])
    assert "6 ok, 2 skipped, 0 failed" in capsys.readouterr().out


def test_lmdry_phase_runs_on_cpu(monkeypatch):
    """The card's ``[lmdry]`` phase rehearsed on the CPU: its checks at the
    reduced config, two dry cells."""
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    failed = []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: None if ok else failed.append(what))
    out = cs.lmdry_phase(torch, {"prefill_ms": 10.0, "decode_ms": 1.0},
                         {"step_ms": 100.0}, device="cpu", reduced=True,
                         cells=[("whisper-tiny", "decode_32k", False, None),
                                ("rwkv6-7b", "prefill_32k", False, 64)])
    assert not failed, failed
    assert len(out["specs"]) == 20 and not out["walk_diff"]
    assert out["cells"][1]["cut"] == {"seq_len": [64, 32768]}
    assert not any(out["launches"].values())
    assert all(w["flops"] > w["matmul_flops"] > 0
               for w in out["work"].values())
