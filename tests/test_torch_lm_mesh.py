"""PyTorch port: every LM family served under ``parallel/sharding.py``'s
rules over the 4 ranks of a 2 x 2 ``("data", "model")`` mesh, against the
reference's own run on a 2 x 2 mesh of XLA host devices.

For all 10 reduced configurations in float32 (default ``Rules()``: FSDP,
KV heads over ``model``, the sequence-parallel residual stream), on the
same parameters and inputs (``torch_lm_mesh_util``): the prefill logits
and those of 2 decode steps within 5e-5, and every leaf of the final
cache, assembled from the rank blocks, within 5e-5 of its largest
magnitude.  The MoE families match the reference's mesh result, which
routes per data shard, and not its one-device result (for grok-1 the
one-device run on the whole batch differs from it by more than 1e-3).

The reference runs in a subprocess beside the 4 spawned gloo ranks; the
ranks import no JAX.  ``test_torch_lm_mesh_rules.py`` covers the other
rules (context-parallel attention, no FSDP, a batch of 1 whose decode
cache shards over both axes).
"""
import numpy as np
import pytest
import torch

import torch_lm_mesh_util as U

torch.set_num_threads(2)

ARCHS = ("qwen1_5_4b", "nemotron_4_15b", "codeqwen1_5_7b", "qwen3_0_6b",
         "rwkv6_7b", "llama_3_2_vision_11b", "qwen3_moe_30b_a3b",
         "grok_1_314b", "zamba2_7b", "whisper_tiny")
LOGIT_TOL = 5e-5
CACHE_TOL = 5e-5
CASES = [dict(name=a, arch=a, rules={}, b=4, s=32, cl=40, serve=True,
              train=False) for a in ARCHS]


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
    """(the reference's results, rank 0's assembled results)."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    U.write_inputs(tmp / "inputs.npz", CASES)
    ref = U.start_reference(tmp, CASES)
    try:
        ranks = U.run_ranks(_rank, tmp, (CASES,))
    except BaseException:
        ref.kill()
        raise
    U.finish_reference(ref)
    return dict(np.load(tmp / "ref.npz")), ranks[0], dict(
        np.load(tmp / "inputs.npz"))


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_equal_reference_mesh(runs, arch):
    ref, port, _ = runs
    for i in range(3):
        err = U.max_err(port[arch][f"logits|{i}"], ref[f"{arch}|logits|{i}"])
        assert err < LOGIT_TOL, (arch, i, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_equal_reference_mesh(runs, arch):
    ref, port, _ = runs
    keys = [k for k in ref if k.startswith(f"{arch}|cache/")]
    assert sorted(k.split("|")[1] for k in keys) == sorted(
        k for k in port[arch] if k.startswith("cache/"))
    for k in keys:
        want = ref[k]
        err = U.max_err(port[arch][k.split("|")[1]], want)
        assert err <= CACHE_TOL * max(1.0, float(np.abs(want).max())), \
            (k, err)


def _one_device(cfg, p, data, arch, rows):
    """The one-device port's prefill + 2 decode logits on ``rows``."""
    from repro_torch.models import api

    def inp(k):
        return torch.from_numpy(data[f"{arch}|in|{k}"][rows])

    lg, cache = api.prefill(cfg, p, {"tokens": inp("tokens")}, cache_len=40)
    out = [lg]
    for i in range(2):
        lg, cache = api.decode_step(cfg, p, {"tokens": inp(f"dec{i}")},
                                    cache, 32 + i)
        out.append(lg)
    return out


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "grok_1_314b"])
def test_moe_mesh_routes_per_data_shard(runs, arch):
    """The reference's mesh result is the one-device model run on each
    data shard's rows (its router and capacity per data shard): the
    port's one-device model reproduces it.  For grok-1 on these inputs it
    differs from the one-device model on the whole batch (for
    qwen3-moe's four experts the capacity drops the same choices here)."""
    from repro_torch.models import api
    ref, _, data = runs
    cfg = U.reduced(arch)
    p = api.params_from_numpy(cfg, U.unflatten(
        {k.split("|p|")[1]: v for k, v in data.items()
         if k.startswith(arch + "|p|")}), "cpu")
    whole = _one_device(cfg, p, data, arch, slice(0, 4))
    parts = [_one_device(cfg, p, data, arch, slice(i, i + 2))
             for i in (0, 2)]
    gap = 0.0
    for i in range(3):
        want = ref[f"{arch}|logits|{i}"]
        assert U.max_err(torch.cat([parts[0][i], parts[1][i]]),
                         want) < LOGIT_TOL
        gap = max(gap, U.max_err(whole[i], want))
    if arch == "grok_1_314b":
        assert gap > 1e-3
