"""PyTorch port: the LM families served over a 2 x 2 ``("data",
"model")`` mesh under the rules other than the default, against the
reference's own run on a 2 x 2 mesh of XLA host devices (the machinery
and the tolerances of ``test_torch_lm_mesh.py``):

* ``attn_tp=False``: context-parallel attention on the query blocks, with
  the reference's re-cut blocking (and, at a prompt of 31 tokens that the
  model axis does not divide, the whole attention on every rank and a
  replicated residual stream);
* ``fsdp=False``: the parameters replicated over ``data``;
* a batch of 1 (``batch_shardable=False``) whose decode cache shards its
  sequence over both axes (``seq_axes_decode=("data", "model")``).

The ranks import no JAX.
"""
import numpy as np
import pytest
import torch

import torch_lm_mesh_util as U

torch.set_num_threads(2)

LOGIT_TOL = 5e-5
CACHE_TOL = 5e-5
_B1 = {"batch_shardable": False, "seq_axes_decode": ["data", "model"]}
CASES = (
    [dict(name=f"cp-{a}", arch=a, rules={"attn_tp": False}, b=4, s=32,
          cl=40, serve=True, train=False)
     for a in ("qwen3_0_6b", "qwen3_moe_30b_a3b", "zamba2_7b",
               "llama_3_2_vision_11b", "whisper_tiny")]
    + [dict(name="cp31-qwen3_0_6b", arch="qwen3_0_6b",
            rules={"attn_tp": False}, b=4, s=31, cl=40, serve=True,
            train=False)]
    + [dict(name=f"nofsdp-{a}", arch=a, rules={"fsdp": False}, b=4, s=32,
            cl=40, serve=True, train=False)
       for a in ("qwen1_5_4b", "rwkv6_7b", "grok_1_314b")]
    + [dict(name=f"b1-{a}", arch=a, rules=_B1, b=1, s=32, cl=40,
            serve=True, train=False)
       for a in ("qwen3_0_6b", "rwkv6_7b", "zamba2_7b", "qwen3_moe_30b_a3b")])
NAMES = [c["name"] for c in CASES]


def _rank(rank, world, init, tmp, cases):
    import torch.distributed as dist
    mesh = U.init_rank(rank, world, init)
    data = dict(np.load(f"{tmp}/inputs.npz"))
    out = {c["name"]: U.serve_case(c, data, mesh) for c in cases}
    torch.save(out if rank == 0 else {}, f"{tmp}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh_rules")
    U.write_inputs(tmp / "inputs.npz", CASES)
    ref = U.start_reference(tmp, CASES)
    try:
        ranks = U.run_ranks(_rank, tmp, (CASES,))
    except BaseException:
        ref.kill()
        raise
    U.finish_reference(ref)
    return dict(np.load(tmp / "ref.npz")), ranks[0]


@pytest.mark.parametrize("name", NAMES)
def test_logits_equal_reference_mesh(runs, name):
    ref, port = runs
    for i in range(3):
        err = U.max_err(port[name][f"logits|{i}"], ref[f"{name}|logits|{i}"])
        assert err < LOGIT_TOL, (name, i, err)


@pytest.mark.parametrize("name", NAMES)
def test_caches_equal_reference_mesh(runs, name):
    ref, port = runs
    keys = [k for k in ref if k.startswith(f"{name}|cache/")]
    assert sorted(k.split("|")[1] for k in keys) == sorted(
        k for k in port[name] if k.startswith("cache/"))
    for k in keys:
        want = ref[k]
        err = U.max_err(port[name][k.split("|")[1]], want)
        assert err <= CACHE_TOL * max(1.0, float(np.abs(want).max())), \
            (k, err)


def test_cache_len_must_split_over_the_sequence_shards():
    """A deliberate difference: the port's decode cache is equal blocks,
    so ``cache_len`` must divide over its sequence shards (the reference
    pads an uneven one)."""
    from repro_torch.launch.mesh import MeshComms, MeshLayout
    from repro_torch.parallel.sharding import Rules, ShardCtx

    class _One:                              # a one-rank communicator
        rank, p = 0, 1

    mc = MeshComms(MeshLayout((1, 2), ("data", "model")), _One(), _One(),
                   _One(), {"data": 0, "model": 0})
    ctx = ShardCtx(mc, Rules(), {})
    with pytest.raises(ValueError, match="cache_len 41"):
        ctx.decode_cache(torch.zeros(1, 1, 40, 2, 4), 41, False)
    with pytest.raises(ValueError, match="batch_shardable"):
        ShardCtx(mc, Rules(seq_axes_decode=("data", "model")), {})
