"""PyTorch port: the LM dry run's per-rank walk (``launch.dryrun.rank_walk``,
``dry_cell(..., rank=)``) over ``launch.mesh.dry_mesh_comms``, a
``MeshComms`` of ``core.comm.DryComm``s.

Held here:

(a) ``DryComm`` against a real ``Comm`` on spawned gloo groups of 2 and
    4 CPU ranks: for the same payloads every collective (all-gather,
    ``psum``, ``pmax``, ``reduce_scatter`` along two dims, all-to-all,
    two permutes, broadcast, scatter) lands the same shape and dtype (on
    ``meta``) and counts the same ``recv_by_kind`` and ``out_by_kind``,
    and ``out_by_kind`` is the reference's ``collective_bytes`` measure:
    the gathered tensor, the reduced tensor, the block, the buffer, the
    landed tensor.
(b) The walk is the real run: on a (2, 2) ``("data", "model")`` and a
    (2, 1, 2) ``("pod", "data", "model")`` mesh of 4 gloo ranks, for
    reduced qwen3-0.6b, qwen3-moe-30b-a3b and rwkv6-7b, a prefill, one
    decode step and one train step (``dryrun._program``, the walk's own
    program, on the ranks' real blocks): each rank's ``Comm`` bytes by
    kind (received and output) and its ``op_cost`` matrix-product flops
    equal the ``DryComm`` walk of the same rank on ``meta`` exactly.
    Across the ranks the counts are equal: every rank runs the same
    program on blocks of one shape (the last model rank's logits row and
    the MoE's expert offset change values, not shapes).
(c) The MoE per rank against the reference: at 256 devices one MoE
    layer's matrix-product flops on rank 0 (router and experts) equal the
    reference's expert-parallel ``shard_map`` body counted once, per
    layer, for qwen3-moe prefill_32k and decode_32k and grok-1
    decode_32k at 2 layers (the reference's ``dot_general`` flops from a
    subprocess with 512 host devices: ``test_torch_dryrun._REF_SCRIPT``'s
    ``cell``, with the ``shard_map`` bodies counted once and not at all).
(d) The production cells: the walk of ``test_torch_dryrun.FLOP_CELLS``
    on both layouts stays on ``meta`` and launches nothing; the rank's
    argument bytes equal ``argument_bytes`` (the reference's shard
    shapes) but for the decode caches whose layout the port chooses
    (ROADMAP Queue 3), and every ``rank_skipped`` is one ROADMAP lists.
"""
import dataclasses
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_lm_mesh_util as U
from repro_torch.configs.base import SHAPES, ShapeCfg, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, MeshLayout, \
    dry_mesh_comms
from repro_torch.perf import op_cost

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# (a) DryComm against Comm
# ---------------------------------------------------------------------------

COLLECTIVES = ("all_gather", "psum", "pmax", "reduce_scatter_0",
               "reduce_scatter_1", "all_to_all", "ppermute_ring",
               "ppermute_one", "broadcast", "scatter")


def _run_collective(comm, name, p, rank, meta):
    def t(*shape):
        if meta:
            return torch.empty(shape, device="meta")
        g = torch.Generator().manual_seed(17 * rank + len(name))
        return torch.randn(shape, generator=g)
    if name == "all_gather":
        return comm.all_gather(t(3, 5))
    if name == "psum":
        return comm.psum(t(4, 2))
    if name == "pmax":
        return comm.pmax(t(3))
    if name == "reduce_scatter_0":
        return comm.reduce_scatter(t(2 * p, 3), 0)
    if name == "reduce_scatter_1":
        return comm.reduce_scatter(t(3, 2 * p), 1)
    if name == "all_to_all":
        return comm.all_to_all(t(p, 6))
    if name == "ppermute_ring":
        return comm.ppermute(t(5), [(i, (i + 1) % p) for i in range(p)])
    if name == "ppermute_one":
        return comm.ppermute(t(5), [(0, 1)])
    if name == "broadcast":
        return comm.broadcast(t(7), 0)
    if name == "scatter":
        return comm.scatter(t(p, 4) if rank == 0 else None, (4,), t(1))
    raise KeyError(name)


def _comm_rank(rank, world, init, tmp):
    import torch.distributed as dist
    from repro_torch.core.comm import Comm, DryComm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    comm, dry = Comm(), DryComm(rank, world)
    out = {}
    for name in COLLECTIVES:
        rec = {}
        for side, c, meta in (("real", comm, False), ("dry", dry, True)):
            c.reset_counts()
            y = _run_collective(c, name, world, rank, meta)
            rec[side] = dict(shape=tuple(y.shape), dtype=str(y.dtype),
                             device=y.device.type,
                             recv=dict(c.recv_by_kind),
                             out=dict(c.out_by_kind))
        out[name] = rec
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def comm_runs(tmp_path_factory):
    res = {}
    for p in (2, 4):
        tmp = tmp_path_factory.mktemp(f"drycomm{p}")
        res[p] = U.run_ranks(_comm_rank, tmp, world=p)
    return res


# output bytes of each collective on one rank (float32 payloads)
def _want_out(name, p):
    return {"all_gather": ("all-gather", p * 15 * 4),
            "psum": ("all-reduce", 8 * 4),
            "pmax": ("all-reduce", 3 * 4),
            "reduce_scatter_0": ("reduce-scatter", 2 * 3 * 4),
            "reduce_scatter_1": ("reduce-scatter", 3 * 2 * 4),
            "all_to_all": ("all-to-all", p * 6 * 4),
            "ppermute_ring": ("collective-permute", 5 * 4),
            "ppermute_one": ("collective-permute", 5 * 4),
            "broadcast": ("broadcast", 7 * 4),
            "scatter": ("scatter", 4 * 4)}[name]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_drycomm_equals_comm(comm_runs, p, name):
    for rank, r in enumerate(comm_runs[p]):
        real, dry = r[name]["real"], r[name]["dry"]
        assert dry["device"] == "meta" and real["device"] == "cpu"
        assert (dry["shape"], dry["dtype"]) == (real["shape"],
                                                real["dtype"]), (rank, r)
        assert dry["recv"] == real["recv"], (rank, dry, real)
        assert dry["out"] == real["out"], (rank, dry, real)
        kind, nbytes = _want_out(name, p)
        assert real["out"] == {kind: nbytes}, (rank, real)


def test_drycomm_reduce_scatter_takes_the_kind():
    """``Comm.reduce_scatter`` passes its kind to ``all_to_all_async``;
    ``DryComm``'s takes it (it raised ``TypeError`` before it did)."""
    from repro_torch.core.comm import DryComm
    c = DryComm(1, 4)
    y = c.reduce_scatter(torch.empty((8, 3), device="meta"), 0)
    assert y.shape == (2, 3) and y.device.type == "meta"
    assert c.recv_by_kind == {"reduce-scatter": 3 * 2 * 3 * 4}
    assert c.out_by_kind == {"reduce-scatter": 2 * 3 * 4}
    from repro_torch.launch import dryrun_h2
    assert dryrun_h2.DryComm is DryComm


def test_dry_mesh_comms_flattens_the_data_axes():
    mc = dry_mesh_comms(MULTI_POD, 16 * 16 + 3 * 16 + 5)   # pod 1, data 3
    assert mc.coords == {"pod": 1, "data": 16 + 3, "model": 5}
    assert (mc.data.rank, mc.data.p) == (19, 32)
    assert (mc.model.rank, mc.model.p) == (5, 16)
    assert (mc.world.rank, mc.world.p) == (16 * 16 + 3 * 16 + 5, 512)
    assert mc.comm(("pod", "data")) is mc.data
    assert mc.comm(("pod", "data", "model")) is mc.world
    assert mc.comm("model") is mc.model and mc.comm(None) is None
    assert mc.index(("pod", "data")) == 19
    assert mc.index(("pod", "data", "model")) == mc.world.rank
    assert mc.index("data") == 3
    with pytest.raises(ValueError):
        mc.comm("data")
    one = dry_mesh_comms(SINGLE_POD, 37)
    assert one.coords == {"data": 2, "model": 5}
    assert one.comm("data") is one.data and one.data.p == 16
    with pytest.raises(ValueError):
        dry_mesh_comms(SINGLE_POD, 256)
    with pytest.raises(ValueError):
        dry_mesh_comms(MeshLayout((4,), ("data",)), 0)


# ---------------------------------------------------------------------------
# (b) the walk equals the real run
# ---------------------------------------------------------------------------

MODEL_ARCHS = ("qwen3_0_6b", "qwen3_moe_30b_a3b", "rwkv6_7b")
LAYOUTS = {"2x2": MeshLayout((2, 2), ("data", "model")),
           "2x1x2": MeshLayout((2, 1, 2), ("pod", "data", "model"))}
B, S = 4, 32
STEPS = ("prefill", "decode", "train")


def _shape(step):
    return ShapeCfg(step, S, B, step)


def _rules(layout):
    from repro_torch.launch.mesh import data_axes
    from repro_torch.parallel.sharding import Rules
    return Rules(data_axes=data_axes(layout))


def _tokens(arch):
    cfg = U.reduced(arch)
    rng = np.random.default_rng(zlib.crc32(arch.encode()))
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(
        np.int32)) for k, shape in (("prompt", (B, S)), ("dec", (B, 1)),
                                    ("train", (B, S + 1)))}


def _model_rank(rank, world, init, tmp):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh, mesh_comms, \
        sum_by_kind
    from repro_torch.models import api
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    meshes = {k: make_device_mesh(lay, "cpu") for k, lay in LAYOUTS.items()}
    out = {}
    for key, mesh in meshes.items():
        rules = _rules(LAYOUTS[key])
        mc = mesh_comms(mesh)

        def rows(x):
            per = x.shape[0] // mc.data.p
            return x[mc.data.rank * per:(mc.data.rank + 1) * per]

        for arch in MODEL_ARCHS:
            cfg = U.reduced(arch)
            params = api.init_params(cfg, 0, "cpu", mesh, rules)
            toks = _tokens(arch)
            with torch.no_grad():
                _, cache = api.prefill(cfg, params, {"tokens": rows(
                    toks["prompt"][:, :S // 2])}, rules, cache_len=S,
                    mesh=mesh)
            programs = {
                "prefill": D._program(cfg, _shape("prefill"), None, params,
                                      {"tokens": rows(toks["prompt"])},
                                      None, rules, mesh),
                "decode": D._program(cfg, _shape("decode"), None, params,
                                     {"tokens": rows(toks["dec"])}, cache,
                                     rules, mesh, pos=torch.tensor(
                                         S // 2, dtype=torch.int32)),
                "train": D._program(cfg, _shape("train"), None, params,
                                    {"tokens": rows(toks["train"])}, None,
                                    rules, mesh)}
            for step, fn in programs.items():
                mc.reset_counts()
                per_op = op_cost.count_ops(fn)
                out[(key, arch, step)] = dict(
                    recv=sum_by_kind(mc.bytes_by_kind()),
                    out=sum_by_kind(mc.bytes_by_kind(out=True)),
                    mm=op_cost.matmul_flops(per_op))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    return U.run_ranks(_model_rank, tmp_path_factory.mktemp("dry_models"))


@pytest.fixture(scope="module")
def model_walks():
    out = {}
    for key, lay in LAYOUTS.items():
        for arch in MODEL_ARCHS:
            cfg = U.reduced(arch)
            for step in STEPS:
                for rank in range(lay.size):
                    w = D.rank_walk(cfg, _shape(step), lay, rank,
                                    rules=_rules(lay))
                    out[(key, arch, step, rank)] = dict(
                        recv=w["recv"], out=w["out"],
                        mm=op_cost.matmul_flops(w["per_op"]))
    return out


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", MODEL_ARCHS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rank_walk_equals_real_run(model_runs, model_walks, layout, arch,
                                   step):
    for rank, r in enumerate(model_runs):
        real = r[(layout, arch, step)]
        dry = model_walks[(layout, arch, step, rank)]
        assert real["recv"] and real["mm"] > 0
        assert dry == real, (rank, dry, real)
    # the ranks run one program on blocks of one shape: equal counts
    assert all(r[(layout, arch, step)] == model_runs[0][(layout, arch,
                                                         step)]
               for r in model_runs)


def test_pod_mesh_counts_equal_the_2x2_counts(model_walks):
    """The (2, 1, 2) mesh's flattened data group is the 2 x 2 mesh's data
    group: the same program and the same bytes on every rank."""
    for arch in MODEL_ARCHS:
        for step in STEPS:
            for rank in range(4):
                assert model_walks[("2x2", arch, step, rank)] == \
                    model_walks[("2x1x2", arch, step, rank)]


# ---------------------------------------------------------------------------
# (c) the MoE layer per rank against the reference's shard_map body
# ---------------------------------------------------------------------------

MOE_CELLS = [("qwen3-moe-30b-a3b", "prefill_32k"),
             ("qwen3-moe-30b-a3b", "decode_32k"),
             ("grok-1-314b", "decode_32k")]
MOE_LAYERS = 2

_MOE_REF = r"""
import json as _json
_orig = J._mesh_size
_res = []
for _c in _json.loads(sys.argv[2]):
    _full = cell(*_c)["dots"]
    J._mesh_size = lambda params: 0
    try:
        _other = cell(*_c)["dots"]
    finally:
        J._mesh_size = _orig
    _res.append({"full": _full, "other": _other})
print(_json.dumps(_res))
"""


@pytest.fixture(scope="module")
def ref_moe_bodies():
    """Per cell, the reference's shard_map bodies' dot_general flops once
    per device: (with the bodies times the mesh size - without them) /
    the mesh size."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_dryrun import _REF_SCRIPT
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    cells = [(a, s, MOE_LAYERS, None, None, False, True)
             for a, s in MOE_CELLS]
    out = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT + _MOE_REF, "[]",
         json.dumps(cells)], env=env, capture_output=True, text=True,
        timeout=REF_TIMEOUT_S, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {c[:2]: (r["full"] - r["other"]) / SINGLE_POD.size
            for c, r in zip(cells, res)}


@pytest.mark.parametrize("cell", MOE_CELLS, ids=lambda c: "-".join(c))
def test_moe_layer_per_rank_equals_reference_shard_body(
        ref_moe_bodies, monkeypatch, cell):
    from repro_torch.models import moe
    arch, shape_name = cell
    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_LAYERS)
    shape = SHAPES[shape_name]
    params = D.api.abstract_params(cfg)
    cache = D.abstract_cache(cfg, shape, params) \
        if shape.kind == "decode" else None      # before the counting
    calls = []
    orig = moe.moe_ffn

    def counted(*a, **k):
        counter = op_cost._Counter()
        with counter:
            y = orig(*a, **k)
        calls.append(op_cost.matmul_flops(counter.per_op))
        return y

    monkeypatch.setattr(moe, "moe_ffn", counted)
    D.rank_walk(cfg, shape, SINGLE_POD, 0, params=params, cache=cache)
    assert len(calls) == MOE_LAYERS and len(set(calls)) == 1, calls
    want = ref_moe_bodies[cell] / MOE_LAYERS
    assert calls[0] == want, (cell, calls[0], want)
    # the per-device form of _gap's MoE terms: t_loc tokens, e_loc experts
    rules = D.cell_rules(cfg, shape, SINGLE_POD)
    tok = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                else 1)
    t_loc = tok // 16 if rules.batch_shardable else tok
    v = max(cfg.moe_virtual, 1)
    e_loc = cfg.n_experts * v // 16
    mats = 3 if cfg.act == "swiglu" else 2
    assert calls[0] == t_loc * 2 * cfg.d_model * cfg.n_experts + \
        e_loc * moe._capacity(cfg, t_loc) * 2 * cfg.d_model * \
        (cfg.moe_d_ff // v) * mats


# ---------------------------------------------------------------------------
# (d) the production cells
# ---------------------------------------------------------------------------

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


def _flop_cells():
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_dryrun import FLOP_CELLS
    return FLOP_CELLS


def _roadmap_lists(arch, shape_name, layout) -> bool:
    text = (ROOT / "ROADMAP.md").read_text()
    tag = f"{arch} {shape_name} {'2pod' if len(layout.shape) == 3 else '1pod'}"
    return tag in text


# the decode caches whose layout on a mesh is the port's choice (ROADMAP
# Queue 3, "The sharded models": the states over their heads, the cross
# caches as the prefill computed them)
PORT_CACHE_LAYOUT = {"rwkv6-7b", "zamba2-7b", "llama-3.2-vision-11b"}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("cell", _flop_cells(),
                         ids=lambda c: "-".join(str(x) for x in c[:4]))
def test_rank_walk_of_production_cells(cell, multi_pod):
    arch, shape_name, n_layers, seq_len = cell[:4]
    layout = MULTI_POD if multi_pod else SINGLE_POD
    cfg = D._cfg_for_dryrun(get_config(arch), shape_name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = SHAPES[shape_name]
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    params = D.api.abstract_params(cfg)
    batch = D.input_specs(cfg, shape)
    cache = D.abstract_cache(cfg, shape, params) \
        if shape.kind == "decode" else None
    before = dict(ops.launch_counts())
    mode = _Devices()
    try:
        with mode:
            w = D.rank_walk(cfg, shape, layout, 0, None, params, batch,
                            cache)
    except (ValueError, NotImplementedError):
        assert _roadmap_lists(arch, shape_name, layout), cell
        return
    assert mode.devices == {"meta"}
    assert dict(ops.launch_counts()) == before
    assert w["out"] and w["recv"] and w["output_bytes"] > 0
    assert op_cost.matmul_flops(w["per_op"]) > 0
    args = D.argument_bytes(cfg, shape, layout, None, params, batch, cache)
    if cache is None or arch not in PORT_CACHE_LAYOUT:
        assert w["argument_bytes"] == args["total"], (w, args)
    else:
        assert w["argument_bytes"] != args["total"]


def test_dry_cell_rank_fields():
    """``rank`` adds the per-rank fields and leaves the global ones as
    they are; ``absent`` keeps what only a compiler gives."""
    kw = dict(layout=MULTI_POD, n_layers=2)
    r = D.dry_cell("qwen3-0.6b", "train_4k", **kw)
    g = D.dry_cell("qwen3-0.6b", "train_4k", rank=None, **kw)
    for k in g:
        if k not in ("walk_s", "absent"):
            assert r[k] == g[k], k
    assert "collectives" not in r["absent"] and "memory" not in r["absent"]
    assert r["absent"] == list(D.ABSENT)
    assert "collectives" in g["absent"] and "rank" not in g
    assert r["rank"] == 0 and r["rank_coords"] == {"pod": 0, "data": 0,
                                                   "model": 0}
    assert set(r["collectives"]) == set(r["recv_bytes_by_kind"]) == {
        "all-gather", "all-reduce", "reduce-scatter"}
    assert r["memory"]["argument_size_in_bytes"] == \
        r["argument_bytes"]["total"]
    assert r["rank_flops"] > r["rank_matmul_flops"] > 0
    assert r["rank_dispatches"] > 0 and r["rank_walk_s"] > 0
    # the last rank of the mesh runs the same shapes
    last = D.dry_cell("qwen3-0.6b", "train_4k", rank=511, **kw)
    assert last["rank_coords"] == {"pod": 1, "data": 15, "model": 15}
    assert last["collectives"] == r["collectives"]


def test_zero1_rank_walk_is_skipped_and_listed():
    r = D.dry_cell("qwen3-0.6b", "train_4k", n_layers=2, variant="zero1")
    assert r["rank_skipped"].startswith("NotImplementedError: zero1")
    assert "collectives" in r["absent"]
    assert "zero1" in (ROOT / "ROADMAP.md").read_text()


def test_cli_writes_rank_fields(tmp_path, capsys):
    out = tmp_path / "dry.json"
    rc = D.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--both-meshes", "--out", str(out)])
    assert rc == 0
    for path in (out, tmp_path / "dry_2pod.json"):
        (r,) = json.loads(path.read_text())
        assert r["rank"] == 0 and r["collectives"]["all-gather"] > 0
        assert r["memory"]["argument_size_in_bytes"] > 0
    text = capsys.readouterr().out
    assert "rank 0: matmul=" in text and "2 ok, 0 skipped, 0 failed" in text
