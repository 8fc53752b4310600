"""PyTorch port: the sharded LMs on the multi-pod layout's mesh, 4 gloo
ranks as (2, 1, 2) ``("pod", "data", "model")``, with ``Rules(data_axes=
("pod", "data"))``: the data axes act as one flattened data group (the
reference's ``P(("pod", "data"), ...)`` shards over their product).

For reduced qwen3-0.6b and qwen3-moe-30b-a3b in float32, on the same
parameters and inputs (``torch_lm_mesh_util``): a prefill, 2 decode
steps, the loss and its gradients, and one ``build_train_step`` step
(AdamW from step 25, PowerSGD off) --

* equal the port's own (2, 2) ``("data", "model")`` run bit for bit (the
  flattened pod x data group is the 2 x 2 mesh's data group, rank for
  rank): logits, every cache leaf, loss, gradients, the stepped
  parameters and moments;
* are within the 2 x 2 mesh tests' tolerances of the reference's own
  run on a (2, 1, 2) Auto-axis mesh of 4 XLA host devices (in a
  subprocess beside the ranks): logits 5e-5, every cache leaf 5e-5 of
  its largest magnitude, the loss 1e-5 relative, every gradient leaf
  1e-4 of its largest magnitude.

The ranks import no JAX.
"""
import numpy as np
import pytest
import torch

import torch_lm_mesh_util as U

torch.set_num_threads(2)

ARCHS = ("qwen3_0_6b", "qwen3_moe_30b_a3b")
POD = ((2, 1, 2), ("pod", "data", "model"))
POD_RULES = {"data_axes": ["pod", "data"]}
CASES = [dict(name=a, arch=a, rules=POD_RULES, b=4, s=32, cl=40,
              serve=True, train=True) for a in ARCHS]
LOGIT_TOL = 5e-5
CACHE_TOL = 5e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
START_STEP = 25


def _step(case, data, mesh, rules):
    """One ``build_train_step`` step on the case's training tokens from
    the case's parameters at AdamW step 25: the global parameters and
    moments after it, by leaf."""
    from repro_torch.launch import train as ttrain
    from repro_torch.models import api
    from repro_torch.optim import adamw
    cfg = U.reduced(case["arch"])
    params = api.params_from_numpy(cfg, U.unflatten(
        {k.split("|p|")[1]: v for k, v in data.items()
         if k.startswith(case["arch"] + "|p|")}), "cpu", mesh, rules)
    opt = adamw.init_state(ttrain.OPT_CFG, params)
    state = ttrain.TrainState(params, opt._replace(step=torch.tensor(
        START_STEP, dtype=torch.int32)))
    step_fn = ttrain.build_train_step(cfg, ttrain.OPT_CFG, rules, mesh, 100)
    toks = torch.from_numpy(data[case["name"] + "|in|train"])
    state, _ = step_fn(state, {"tokens": U.data_rows(toks, rules, mesh)})
    state = ttrain.state_global(cfg, state, rules, mesh)
    return {f"{part}/{i}": x for part, tree in (
        ("params", state.params), ("m", state.opt.m), ("v", state.opt.v))
        for i, x in enumerate(adamw.tree_leaves(tree))}


def _rank(rank, world, init, tmp, cases):
    import torch.distributed as dist
    from repro_torch.launch.mesh import MeshLayout, make_device_mesh, \
        make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    meshes = {"2x2": make_test_mesh(2, 2),
              "pod": make_device_mesh(MeshLayout(*POD), "cpu")}
    data = dict(np.load(f"{tmp}/inputs.npz"))
    out = {}
    for key, mesh in meshes.items():
        for c in cases:
            case = dict(c, rules={} if key == "2x2" else POD_RULES)
            rules = U.case_rules(case)
            res = U.serve_case(case, data, mesh)
            res.update(U.loss_case(case, data, mesh))
            res.update({f"step/{k}": v for k, v in
                        _step(case, data, mesh, rules).items()})
            out[(key, c["name"])] = res
    torch.save(out if rank == 0 else {}, f"{tmp}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's (2, 1, 2) mesh results, rank 0's results)."""
    tmp = tmp_path_factory.mktemp("lm_mesh_pod")
    U.write_inputs(tmp / "inputs.npz", CASES)
    ref = U.start_reference(tmp, CASES, POD)
    try:
        ranks = U.run_ranks(_rank, tmp, (CASES,))
    except BaseException:
        ref.kill()
        raise
    U.finish_reference(ref)
    return dict(np.load(tmp / "ref.npz")), ranks[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_mesh_equals_2x2_mesh_bitwise(runs, arch):
    _, port = runs
    pod, flat = port[("pod", arch)], port[("2x2", arch)]
    assert sorted(pod) == sorted(flat)
    assert any(k.startswith("step/") for k in pod)
    for k in pod:
        assert torch.equal(pod[k], flat[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_mesh_serving_equals_reference_pod_mesh(runs, arch):
    ref, port = runs
    got = port[("pod", arch)]
    for i in range(3):
        err = U.max_err(got[f"logits|{i}"], ref[f"{arch}|logits|{i}"])
        assert err < LOGIT_TOL, (arch, i, err)
    keys = [k for k in ref if k.startswith(f"{arch}|cache/")]
    assert keys and sorted(k.split("|")[1] for k in keys) == sorted(
        k for k in got if k.startswith("cache/"))
    for k in keys:
        want = ref[k]
        err = U.max_err(got[k.split("|")[1]], want)
        assert err <= CACHE_TOL * max(1.0, float(np.abs(want).max())), \
            (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_mesh_loss_and_grads_equal_reference_pod_mesh(runs, arch):
    ref, port = runs
    got = port[("pod", arch)]
    want = float(ref[f"{arch}|loss"])
    assert abs(float(got["loss"]) - want) <= LOSS_RTOL * abs(want)
    keys = [k for k in ref if k.startswith(f"{arch}|grad/")]
    assert keys and sorted(k.split("|")[1] for k in keys) == sorted(
        k for k in got if k.startswith("grad/"))
    for k in keys:
        w = ref[k]
        err = U.max_err(got[k.split("|")[1]], w)
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-30), (k, err)
