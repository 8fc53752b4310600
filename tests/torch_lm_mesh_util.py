"""Shared pieces of the sharded-LM tests (``test_torch_lm_mesh*.py``,
``test_torch_train_mesh.py``): the seeded inputs, the reference's own
run on a 2 x 2 ``("data", "model")`` mesh of 4 XLA host devices (in a
subprocess, so its ``XLA_FLAGS`` stay there), and gloo groups of 4 CPU
ranks spawned with one deadline.

Both packages take the same numbers: the port's seeded parameters (its
1-D leaves -- norms, biases, decays -- moved off their constant
initialisation by a seeded perturbation) and the inputs are written to
one ``.npz`` that the reference's subprocess and every rank read.  The
mesh is built as ``jax.make_mesh((2, 2), ("data", "model"),
axis_types=(AxisType.Auto,) * 2)``: the reference's own
``launch.mesh.make_test_mesh`` builds explicit axes on jax 0.9, under
which its embedding gather raises ``ShardingTypeError``.

The ranks import no JAX.
"""
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

MESH = (2, 2)
RANK_TIMEOUT_S = 300
REF_TIMEOUT_S = 300

# The reference on the mesh: for each case, prefill + 2 decode steps
# (logits and the final cache) and/or the loss and its gradients, jitted
# under the mesh with the parameters placed by make_param_shardings.
REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import get_config
from repro.models import api
from repro.parallel.sharding import Rules, make_param_shardings

data = dict(np.load(sys.argv[1]))
cases = json.load(open(sys.argv[2]))
shape, axes = json.loads(sys.argv[4]) if len(sys.argv) > 4 else \
    ((2, 2), ("data", "model"))
mesh = jax.make_mesh(tuple(shape), tuple(axes),
                     axis_types=(AxisType.Auto,) * len(axes))


def tree(prefix):
    out = {}
    for k, v in data.items():
        if k.startswith(prefix):
            node = out
            parts = k[len(prefix):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(v)
    return out


def flat(t, prefix, out):
    if isinstance(t, dict):
        for k, v in t.items():
            flat(v, f"{prefix}/{k}", out)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            flat(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(t)


res = {}
for case in cases:
    name = case["name"]
    cfg = get_config(case["arch"]).reduced(param_dtype="float32",
                                           act_dtype="float32")
    kw = dict(case["rules"])
    for k in ("seq_axes_decode", "data_axes"):
        if kw.get(k):
            kw[k] = tuple(kw[k])
    rules = Rules(**kw)
    params = tree(case["arch"] + "|p|")
    p = jax.tree.map(jax.device_put, params,
                     make_param_shardings(params, rules, mesh))
    inp = {k.split("|")[-1]: jnp.asarray(v) for k, v in data.items()
           if k.startswith(name + "|in|")}
    stubs = {k: v for k, v in inp.items() if k in ("img_embed", "frames")}
    with jax.set_mesh(mesh):
        if case["serve"]:
            lg, cache = jax.jit(lambda p, b: api.prefill(
                cfg, p, b, rules, 2, mesh, cache_len=case["cl"]))(
                    p, dict(stubs, tokens=inp["tokens"]))
            res[name + "|logits|0"] = np.asarray(lg)
            step = jax.jit(lambda p, b, c, pos: api.decode_step(
                cfg, p, b, c, pos, rules, 2, mesh))
            for i in range(2):
                lg, cache = step(p, dict(stubs, tokens=inp[f"dec{i}"]),
                                 cache, jnp.int32(case["s"] + i))
                res[name + f"|logits|{i + 1}"] = np.asarray(lg)
            flat(cache, name + "|cache", res)
        if case["train"]:
            loss, g = jax.jit(jax.value_and_grad(lambda p, b: api.train_loss(
                cfg, p, b, rules, 2, mesh)))(
                    p, dict(stubs, tokens=inp["train"]))
            res[name + "|loss"] = np.asarray(loss)
            flat(g, name + "|grad", res)
    print(name, "done", flush=True)
np.savez(sys.argv[3], **res)
"""


def reduced(arch):
    from repro_torch.configs.base import get_config
    return get_config(arch).reduced(param_dtype="float32",
                                    act_dtype="float32")


def flatten(tree, prefix=""):
    """``{"a/b/c": leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def seeded_params(arch, seed: int = 0):
    """The port's parameters of ``arch`` (reduced, float32) as numpy, the
    1-D leaves perturbed by a seeded 0.05 * N(0, 1)."""
    from repro_torch.models import api
    cfg = reduced(arch)
    p = flatten(api.init_params(cfg, seed, "cpu"))
    rng = np.random.default_rng(seed + 11)
    out = {}
    for k, v in sorted(p.items()):
        a = v.numpy().copy()
        if a.ndim - (1 if k.startswith("blocks/") else 0) <= 1:
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        out[k] = a
    return out


def case_inputs(case):
    """The case's seeded inputs: prompts, 2 decode tokens, training
    tokens and the family's stub embeddings."""
    cfg = reduced(case["arch"])
    rng = np.random.default_rng(zlib.crc32(case["name"].encode()))
    b, s = case["b"], case["s"]
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "dec0": rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32),
           "dec1": rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32),
           "train": rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img_embed"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def write_inputs(path, cases):
    """One ``.npz`` of every case's arch parameters and inputs."""
    data = {}
    for arch in sorted({c["arch"] for c in cases}):
        for k, v in seeded_params(arch).items():
            data[f"{arch}|p|{k}"] = v
    for c in cases:
        for k, v in case_inputs(c).items():
            data[f"{c['name']}|in|{k}"] = v
    np.savez(path, **data)


def case_rules(case):
    from repro_torch.parallel.sharding import Rules
    kw = dict(case["rules"])
    for k in ("seq_axes_decode", "data_axes"):
        if kw.get(k):
            kw[k] = tuple(kw[k])
    return Rules(**kw)


def data_rows(x, rules, mesh):
    """This data shard's rows of a global batch tensor (on the multi-pod
    mesh the shards of the flattened pod x data group)."""
    from repro_torch.launch.mesh import mesh_comms
    if not rules.batch_shardable:
        return x
    mc = mesh_comms(mesh)
    per = x.shape[0] // mc.data.p
    d = mc.data.rank
    return x[d * per:(d + 1) * per]


def serve_case(case, data, mesh):
    """The port's prefill + 2 decode steps of ``case`` on this rank:
    the global logits and final cache (assembled on every rank)."""
    from repro_torch.models import api
    from repro_torch.models.transformer import logits_spec
    from repro_torch.parallel.sharding import assemble
    cfg = reduced(case["arch"])
    rules = case_rules(case)
    p = api.params_from_numpy(cfg, unflatten(
        {k.split("|p|")[1]: v for k, v in data.items()
         if k.startswith(case["arch"] + "|p|")}), "cpu", mesh, rules)
    inp = {k.split("|")[-1]: torch.from_numpy(v) for k, v in data.items()
           if k.startswith(case["name"] + "|in|")}
    stubs = {k: data_rows(v, rules, mesh) for k, v in inp.items()
             if k in ("img_embed", "frames")}
    spec = logits_spec(cfg, rules, api.shard_ctx(cfg, rules, 1, mesh))
    out = {}
    lg, cache = api.prefill(cfg, p, dict(stubs, tokens=data_rows(
        inp["tokens"], rules, mesh)), rules, mesh=mesh,
        cache_len=case["cl"])
    out["logits|0"] = assemble(lg, spec, mesh)
    for i in range(2):
        lg, cache = api.decode_step(
            cfg, p, {"tokens": data_rows(inp[f"dec{i}"], rules, mesh)},
            cache, torch.tensor(case["s"] + i), rules, mesh=mesh)
        out[f"logits|{i + 1}"] = assemble(lg, spec, mesh)
    specs = api.cache_specs(cfg, cache, rules, mesh)
    if "state" in cache:
        for i, (x, sp) in enumerate(zip(cache["state"], specs["state"])):
            out[f"cache/state/{i}"] = assemble(x, sp, mesh)
    else:
        for k, x in cache.items():
            out[f"cache/{k}"] = assemble(x, specs[k], mesh)
    return out


def loss_case(case, data, mesh):
    """The port's loss and global gradients (by leaf path) of ``case``."""
    from repro_torch.models import api
    from repro_torch.optim import adamw
    cfg = reduced(case["arch"])
    rules = case_rules(case)
    p = api.params_from_numpy(cfg, unflatten(
        {k.split("|p|")[1]: v for k, v in data.items()
         if k.startswith(case["arch"] + "|p|")}), "cpu", mesh, rules)
    inp = {k.split("|")[-1]: torch.from_numpy(v) for k, v in data.items()
           if k.startswith(case["name"] + "|in|")}
    batch = {k: data_rows(v, rules, mesh) for k, v in inp.items()
             if k in ("img_embed", "frames")}
    batch["tokens"] = data_rows(inp["train"], rules, mesh)
    leaves = [x.detach().requires_grad_(True) for x in adamw.tree_leaves(p)]
    loss = api.train_loss(cfg, adamw.tree_unflatten(p, leaves), batch,
                          rules, mesh=mesh)
    g = torch.autograd.grad(loss, leaves, allow_unused=True,
                            materialize_grads=True)
    g = api.gather_params(cfg, adamw.tree_unflatten(p, list(g)), rules, mesh)
    return {"loss": loss.detach(), **{f"grad/{k}": v for k, v in
                                      flatten(g).items()}}


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [q for q in [e.get("PYTHONPATH")] if q])
    e["JAX_PLATFORMS"] = "cpu"
    return e


def start_reference(tmp, cases, mesh=((2, 2), ("data", "model"))):
    """The reference's subprocess on ``tmp/inputs.npz`` (running), on an
    Auto-axis mesh of ``mesh`` = (shape, axis names) over 4 host
    devices."""
    with open(tmp / "cases.json", "w") as f:
        json.dump(cases, f)
    return subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "cases.json"), str(tmp / "ref.npz"), json.dumps(mesh)],
        env=env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def run_ranks(target, tmp, args=(), world=4):
    """Spawn ``world`` ranks of ``target(rank, world, init, tmp, *args)``
    in one gloo group and join them with one deadline; each rank's
    ``torch.save``d ``tmp/rank<r>.pt`` in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [ctx.Process(target=target, args=(r, world, init, str(tmp),
                                              *args))
             for r in range(world)]
    for pr in procs:
        pr.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for pr in procs:
            pr.join(max(1.0, deadline - time.monotonic()))
    finally:
        hung = [pr for pr in procs if pr.is_alive()]
        for pr in hung:
            pr.terminate()
            pr.join()
    assert not hung, f"{len(hung)} rank(s) did not finish within " \
        f"{RANK_TIMEOUT_S} s (a rank decided differently?)"
    codes = [pr.exitcode for pr in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def finish_reference(ref):
    log, _ = ref.communicate(timeout=REF_TIMEOUT_S)
    assert ref.returncode == 0, f"reference:\n{log[-4000:]}"


def init_rank(rank, world, init):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    return make_test_mesh(*MESH)


def max_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) if a.size else 0.0


def rel(a, b) -> float:
    """||a - b|| / ||b||, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
