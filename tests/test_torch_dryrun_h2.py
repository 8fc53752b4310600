"""PyTorch port: the H^2 dry run (``repro_torch.launch.dryrun_h2``), the
production layouts (``launch.mesh``) and ``core.structure.abstract_data``.

- ``abstract_data`` has the shapes, dtypes and basis-tree alias of a real
  ``construct_h2`` operator, field by field, on the ``meta`` device;
- ``measured_structure_stats`` and ``synth_dist_shape`` equal the
  reference's at a small probe, and one rank's walked HGEMV has the
  reference's ``dot_general`` flops in all three comm modes.  The
  reference values come from a subprocess: importing
  ``repro.launch.dryrun_h2`` sets ``XLA_FLAGS`` to 512 host devices, which
  must not leak into this process or the ranks it spawns;
- ``DryComm`` counts ``matvec_comm_bytes`` exactly for halo-plan,
  ppermute and allgather at p = 16 and 32 (and the PCG cell the Krylov
  model plus its prologue);
- the walk launches no kernel, allocates nothing and reads nothing on the
  host (every tensor is ``meta``); the CLI writes its JSON;
- the layouts give p = 16 and 32, and ``make_test_mesh`` builds a 2 x 2
  ``DeviceMesh`` over 4 spawned gloo ranks.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from repro_torch.launch import dryrun_h2 as dry
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, data_axes,
                                     h2_ranks, production_layout)

torch.set_num_threads(2)

PROBE = 5                 # depth_probe of the reference comparison
ROWS = 8                  # 2^ROWS rows per rank there
REF_TIMEOUT_S = 300
MODES = ("halo-plan", "ppermute", "allgather")

_REF_SCRIPT = r"""
import dataclasses, json, sys
import repro.launch.dryrun_h2 as R
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core.dist import dist_specs, dist_h2_matvec_local
from repro.perf.jaxpr_cost import _dot_flops

def dots(jaxpr):
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            total += _dot_flops(eqn)
        for prm in eqn.params.values():
            for sub in (prm if isinstance(prm, (tuple, list)) else [prm]):
                sub = getattr(sub, "jaxpr", None)
                if sub is not None:
                    total += dots(getattr(sub, "jaxpr", sub))
    return total

probe, rows = int(sys.argv[1]), int(sys.argv[2])
out = {f"stats{dim}": R.measured_structure_stats(dim, depth_probe=probe)
       for dim in (2, 3)}
mesh = R.make_production_mesh()
axis = R.data_axes(mesh)[0]
depth = 4 + rows - 6
ds = R.synth_dist_shape(16, depth, 64, 64, out["stats2"])
out["shape"] = dataclasses.asdict(ds)
data = R.abstract_dist_data(ds)
specs = dist_specs(ds, axis)
for comm in sys.argv[3:]:
    def step(d, x):
        return dist_h2_matvec_local(ds, d, x, axis, comm)
    fn = shard_map(step, mesh=mesh, in_specs=(specs, P(axis, None)),
                   out_specs=P(axis, None), check_vma=False)
    with mesh:
        jp = jax.make_jaxpr(fn)(data, jax.ShapeDtypeStruct((ds.n, 1),
                                                           jnp.float32))
    body = [e for e in jp.jaxpr.eqns
            if e.primitive.name == "shard_map"][0].params["jaxpr"]
    out[comm] = dots(getattr(body, "jaxpr", body))  # per device
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_dry():
    """The reference's stats, synthesized shape and per-device matvec
    dot flops, from a subprocess (its ``XLA_FLAGS`` stay there)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(PROBE),
                          str(ROWS), *MODES], env=env, capture_output=True,
                         text=True, timeout=REF_TIMEOUT_S, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _json(x):
    return json.loads(json.dumps(x))


# ---------------------------------------------------------------------------
# abstract_data


def _fields(data):
    """(name, tensor) of every tensor of an H2Data, lists and plan
    flattened."""
    out = []
    for f in dataclasses.fields(data):
        v = getattr(data, f.name)
        if f.name == "plan":
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                for i, t in enumerate(w if isinstance(w, list) else [w]):
                    out.append((f"plan.{g.name}[{i}]", t))
        elif isinstance(v, list):
            out += [(f"{f.name}[{i}]", t) for i, t in enumerate(v)]
        else:
            out.append((f.name, v))
    return out


@pytest.fixture(scope="module")
def small_operator():
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    shape, data, _, _ = construct_h2(regular_grid_points(32, 2),
                                     exponential_kernel(0.1), leaf_size=16,
                                     cheb_p=4, eta=0.9, device="cpu")
    return shape, data


def test_abstract_data_matches_construct(small_operator):
    from repro_torch.core.structure import abstract_data
    shape, data = small_operator
    ab = abstract_data(shape)
    real, fake = _fields(data), _fields(ab)
    assert [n for n, _ in real] == [n for n, _ in fake]
    for (name, r), (_, a) in zip(real, fake):
        assert a.device.type == "meta", name
        assert (tuple(a.shape), a.dtype) == (tuple(r.shape), r.dtype), name
    assert ab.v_leaf is ab.u_leaf and data.v_leaf is data.u_leaf
    assert all(a is b for a, b in zip(ab.f, ab.e))


def test_abstract_data_without_plan(small_operator):
    from repro_torch.core.structure import abstract_data
    shape, data = small_operator
    ab = abstract_data(dataclasses.replace(shape, row_maxb=None))
    assert ab.plan is None and ab.s_mar is None and ab.dense_mar is None
    assert tuple(ab.dense.shape) == tuple(data.dense.shape)
    assert ab.nbytes() < data.nbytes()


# ---------------------------------------------------------------------------
# against the reference


@pytest.mark.parametrize("dim", [2, 3])
def test_structure_stats_match_reference(ref_dry, dim):
    assert _json(dry.measured_structure_stats(dim, PROBE)) == \
        ref_dry[f"stats{dim}"]


def test_synth_shape_matches_reference(ref_dry):
    ds, _ = dry.cell_shape(SINGLE_POD, 2, ROWS,
                           stats=dry.measured_structure_stats(2, PROBE))
    assert _json(dataclasses.asdict(ds)) == ref_dry["shape"]


@pytest.mark.parametrize("mode", MODES)
def test_matvec_matmul_flops_match_reference(ref_dry, mode):
    """One rank's walked HGEMV: the reference's per-device dot flops."""
    r = dry.dry_cell("matvec", 2, 1, SINGLE_POD, ROWS, mode=mode,
                     stats=dry.measured_structure_stats(2, PROBE))
    assert r["matmul_flops"] == ref_dry[mode]
    assert r["flops"] >= r["matmul_flops"]


# ---------------------------------------------------------------------------
# DryComm against the models


@pytest.fixture(scope="module")
def stats2():
    return dry.measured_structure_stats(2, PROBE)


@pytest.mark.parametrize("nv", [1, 64])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_dry_comm_bytes_equal_model(stats2, multi_pod, mode, nv):
    layout = production_layout(multi_pod=multi_pod)
    r = dry.dry_cell("matvec", 2, nv, layout, 10, mode=mode, stats=stats2)
    assert r["p"] == (32 if multi_pod else 16)
    assert sum(r["collectives"].values()) == r["model_comm_bytes"]


@pytest.mark.parametrize("rank", [0, 7, 15])
def test_every_rank_counts_the_model(stats2, rank):
    """The permutes are cyclic: every rank receives the same bytes."""
    r = dry.dry_cell("matvec", 2, 1, SINGLE_POD, 10, rank=rank,
                     stats=stats2)
    assert sum(r["collectives"].values()) == r["model_comm_bytes"]


def test_pcg_cell_bytes_and_flops(stats2):
    """One PCG iteration: the Krylov model plus the prologue's three
    psum'd scalars, and at least one HGEMV's products."""
    r = dry.dry_cell("pcg", 2, 1, SINGLE_POD, 10, stats=stats2)
    mv = dry.dry_cell("matvec", 2, 1, SINGLE_POD, 10, stats=stats2)
    assert sum(r["collectives"].values()) == r["model_comm_bytes"]
    assert r["model_comm_bytes"] == r["model_comm_bytes_per_iter"] + \
        dry.PCG_PROLOGUE_PSUMS * 4 * 15
    assert r["collectives"]["all-reduce"] == 6 * 4 * 15
    assert r["matmul_flops"] == mv["matmul_flops"]


def test_compress_cell_walks(stats2):
    r = dry.dry_cell("compress", 3, 1, SINGLE_POD, 10)
    assert r["matmul_flops"] > 0 and r["collectives"]["all-gather"] > 0


# ---------------------------------------------------------------------------
# the walk itself


def test_walk_launches_nothing_and_stays_meta(stats2, monkeypatch):
    """No kernel launches, no tensor off ``meta`` (nothing allocated, no
    host read: a meta tensor cannot be read)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.kernels import ops
    devices = set()

    class Devices(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            devices.update(t.device.type for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor))
            return out

    before = dict(ops.launch_counts())
    ds, _ = dry.cell_shape(SINGLE_POD, 2, 10, stats=stats2)
    d = dry.abstract_dist_data(ds)
    comm = dry.DryComm(3, ds.p)
    for kind in ("matvec", "pcg", "compress"):
        with Devices():
            dry._walk(kind, ds, d, comm, 1, "halo-plan")()
    assert devices == {"meta"}
    assert dict(ops.launch_counts()) == before


def test_abstract_dist_data_is_one_rank(stats2):
    """The one-rank view: sharded fields carry no leading p."""
    ds, _ = dry.cell_shape(SINGLE_POD, 2, 10, stats=stats2)
    d = dry.abstract_dist_data(ds)
    assert d.u_leaf.shape[0] == ds.leaves_per_dev
    assert d.dense_mar.shape[0] == ds.leaves_per_dev
    assert [t.shape[0] for t in d.s_br] == list(ds.br_counts)
    assert d.e_top[ds.lc].shape[0] == ds.p           # replicated
    # the shared basis tree counts once
    apart = dataclasses.replace(d, v_leaf=torch.zeros_like(d.u_leaf))
    assert dry.resident_bytes(apart) - dry.resident_bytes(d) == \
        d.u_leaf.numel() * d.u_leaf.element_size()


def test_dry_comm_refuses_a_bad_rank():
    with pytest.raises(ValueError):
        dry.DryComm(16, 16)


def test_cli_writes_json(tmp_path):
    out = tmp_path / "dry.json"
    assert dry.main(["--rows-log2", "10", "--cells", "matvec1,pcg",
                     "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert len(res) == 2 * (3 + 1)
    assert not any("error" in r for r in res)
    mv = [r for r in res if r["cell"].endswith("matvec-nv1")]
    assert all(sum(r["collectives"].values()) == r["model_comm_bytes"]
               for r in mv)


# ---------------------------------------------------------------------------
# layouts


def test_layouts():
    assert production_layout() is SINGLE_POD
    assert production_layout(multi_pod=True) is MULTI_POD
    assert data_axes(SINGLE_POD) == ("data",)
    assert data_axes(MULTI_POD) == ("pod", "data")
    assert (h2_ranks(SINGLE_POD), h2_ranks(MULTI_POD)) == (16, 32)
    assert (SINGLE_POD.size, MULTI_POD.size) == (256, 512)


def _mesh_rank(rank: int, init: str, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh, make_test_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=4)
    mesh = make_test_mesh(2, 2)
    res = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
           "data": dist.get_world_size(mesh.get_group("data")),
           "model": dist.get_world_size(mesh.get_group("model"))}
    try:
        make_device_mesh(SINGLE_POD, "cpu")
        res["refused"] = ""
    except ValueError as e:
        res["refused"] = str(e)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def test_make_test_mesh_over_gloo(tmp_path):
    ctx = torch.multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_mesh_rank, args=(r, init, str(tmp_path)))
             for r in range(4)]
    for pr in procs:
        pr.start()
    deadline = time.monotonic() + 120
    for pr in procs:
        pr.join(max(1.0, deadline - time.monotonic()))
    hung = [pr for pr in procs if pr.is_alive()]
    for pr in hung:
        pr.terminate()
        pr.join()
    assert not hung and [pr.exitcode for pr in procs] == [0] * 4
    for r in range(4):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert res["shape"] == (2, 2)
        assert res["names"] == ("data", "model")
        assert res["data"] == res["model"] == 2
        assert "256 ranks" in res["refused"]
