"""PyTorch port: training under ``parallel/sharding.py``'s rules over the 4
ranks of a 2 x 2 ``("data", "model")`` mesh (FSDP, tensor, sequence and
expert parallelism over ``core.comm.Comm``; ``launch/train.py`` with
``mesh=`` and ``rules=``).

* The loss within 1e-5 of the reference's own 2 x 2 mesh run (XLA host
  devices, in a subprocess) and every gradient leaf within 1e-4 of its
  largest magnitude, for one configuration of each family (dense, MoE,
  RWKV6, Zamba2, vision, audio; reduced, float32), on the same parameters
  and tokens (``torch_lm_mesh_util``).
* Two ``build_train_step`` steps (AdamW from step 25, PowerSGD off and
  on) of the dense and the MoE configuration equal the one-device port's
  on the per-data-shard oracle (the mean of the data shards' losses):
  the losses within 1e-5 relative, every parameter leaf within 1e-5
  relative, and with PowerSGD within 1e-4 (the rank-4 power iteration's
  QR amplifies the gradients' rounding where a leaf's 4th and 5th
  singular values lie close; the Q factors are not compared: where a
  gradient has rank below 4, an expert that no token reached, their
  null directions are arbitrary) (in norm, as ``test_torch_train.py`` holds the
  one-device steps to the reference's: AdamW's first steps from zero
  moments move a parameter by about the learning rate whatever its
  gradient's size, so a gradient near zero whose sign the order of the
  sums flips moves its parameter the other way).
* ``train(mesh=, rules=, ckpt_dir=)`` with a failure at step 3 resumes
  from the newest checkpoint (rank 0 writes it) and replays the loss
  history of an uninterrupted mesh run bitwise; the mesh run's losses
  are the one-device run's within 1e-5.
* A checkpoint written on the mesh restores into a one-device run, and
  one written on one device into a mesh run (PowerSGD on): the next loss
  within 1e-5 of the writer's.

The ranks import no JAX.
"""
import math

import numpy as np
import pytest
import torch

import torch_lm_mesh_util as U

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
PSGD_TOL = 1e-4     # PowerSGD's rank-4 power iteration amplifies rounding
GRAD_ARCHS = ("qwen3_0_6b", "qwen3_moe_30b_a3b", "rwkv6_7b", "zamba2_7b",
              "llama_3_2_vision_11b", "whisper_tiny")
GRAD_CASES = [dict(name=f"g-{a}", arch=a, rules={}, b=4, s=32, cl=40,
                   serve=False, train=True) for a in GRAD_ARCHS]
STEP_ARCHS = ("qwen3_0_6b", "qwen3_moe_30b_a3b")
START_STEP, TOTAL = 25, 100
BATCH, SEQ = 4, 32
DRILL = dict(steps=5, global_batch=BATCH, seq_len=SEQ, log_every=100)


def _step_run(arch, use_psgd, mesh=None, rows=None):
    """Two train steps from the seeded state at AdamW step 25: (losses,
    the global state after them)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import Rules
    cfg = U.reduced(arch)
    psgd = ttrain.PSGD_CFG if use_psgd else None
    rules = Rules() if mesh is not None else None
    state = ttrain.init_train_state(cfg, ttrain.OPT_CFG, 0, "cpu", mesh,
                                    rules, psgd)
    state = ttrain.TrainState(state.params, state.opt._replace(
        step=torch.tensor(START_STEP, dtype=torch.int32)), state.psgd)
    step_fn = ttrain.build_train_step(cfg, ttrain.OPT_CFG, rules, mesh,
                                      TOTAL, psgd)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                       seed=0)
    losses = []
    for i in range(2):
        toks = data.batch(i) if rows is None else rows(data, i)
        state, met = step_fn(state, ttrain.make_train_batch(cfg, toks,
                                                            "cpu"))
        losses.append(float(met["loss"]))
    if mesh is not None:
        state = ttrain.state_global(cfg, state, rules, mesh)
    return losses, {"params": adamw.tree_leaves(state.params),
                    "q": [] if state.psgd is None else
                    [q for q in state.psgd.q if q is not None]}


def _rank(rank, world, init, tmp, grad_cases):
    import torch.distributed as dist
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import mesh_comms
    from repro_torch.parallel.sharding import Rules
    from repro_torch.runtime.fault import FailureInjector
    mesh = U.init_rank(rank, world, init)
    mc = mesh_comms(mesh)
    data = dict(np.load(f"{tmp}/inputs.npz"))
    out = {"grads": {c["name"]: U.loss_case(c, data, mesh)
                     for c in grad_cases}}

    def rows(d, i):
        return d.rows(i, mc.coord("data"), 2)

    out["steps"] = {(a, p): _step_run(a, p, mesh, rows)
                    for a in STEP_ARCHS for p in (False, True)}
    cfg = U.reduced("qwen3_0_6b")
    kw = dict(DRILL, mesh=mesh, rules=Rules(), device="cpu")
    out["plain"] = ttrain.train(cfg, **kw)
    out["hurt"] = ttrain.train(
        cfg, ckpt_dir=f"{tmp}/drill", ckpt_every=2,
        injector=FailureInjector({3: "device lost"}), **kw)
    ck = dict(steps=3, global_batch=BATCH, seq_len=SEQ, ckpt_every=2,
              use_psgd=True, log_every=100, mesh=mesh, rules=Rules(),
              device="cpu")
    out["mesh_writes"] = ttrain.train(cfg, ckpt_dir=f"{tmp}/from_mesh", **ck)
    out["mesh_reads"] = ttrain.train(cfg, ckpt_dir=f"{tmp}/from_one", **ck)
    torch.save(out if rank == 0 else {}, f"{tmp}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, rank 0's results, the one-device writer's
    history, tmp)."""
    from repro_torch.launch import train as ttrain
    tmp = tmp_path_factory.mktemp("train_mesh")
    U.write_inputs(tmp / "inputs.npz", GRAD_CASES)
    ref = U.start_reference(tmp, GRAD_CASES)
    try:
        one = ttrain.train(U.reduced("qwen3_0_6b"), steps=3,
                           global_batch=BATCH, seq_len=SEQ, ckpt_every=2,
                           use_psgd=True, log_every=100, device="cpu",
                           ckpt_dir=str(tmp / "from_one"))
        ranks = U.run_ranks(_rank, tmp, (GRAD_CASES,))
    except BaseException:
        ref.kill()
        raise
    U.finish_reference(ref)
    return dict(np.load(tmp / "ref.npz")), ranks[0], one, tmp


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_equal_reference_mesh(runs, arch):
    ref, port, _, _ = runs
    name = f"g-{arch}"
    got = port["grads"][name]
    want = float(ref[f"{name}|loss"])
    assert abs(float(got["loss"]) - want) <= LOSS_RTOL * abs(want)
    keys = [k for k in ref if k.startswith(f"{name}|grad/")]
    assert sorted(k.split("|")[1] for k in keys) == sorted(
        k for k in got if k.startswith("grad/"))
    for k in keys:
        w = ref[k]
        err = U.max_err(got[k.split("|")[1]], w)
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-30), (k, err)


@pytest.mark.parametrize("use_psgd", [False, True], ids=["adamw", "psgd"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_two_steps_equal_one_device_per_shard_oracle(runs, monkeypatch,
                                                     arch, use_psgd):
    """The one-device oracle's loss is the mean of the data shards' losses
    (for the dense model the global loss; for the MoE the router and the
    capacity per data shard, as on the mesh)."""
    from repro_torch.models import api
    _, port, _, _ = runs
    train_loss = api.train_loss

    def per_shard(cfg, params, batch, *args, **kw):
        half = batch["tokens"].shape[0] // 2
        return sum(train_loss(cfg, params, {"tokens": batch["tokens"][
            i * half:(i + 1) * half]}) for i in range(2)) / 2

    monkeypatch.setattr(api, "train_loss", per_shard)
    want_losses, want = _step_run(arch, use_psgd)
    got_losses, got = port["steps"][(arch, use_psgd)]
    for g, w in zip(got_losses, want_losses):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got_losses, want_losses)
    assert len(got["params"]) == len(want["params"])
    tol = PSGD_TOL if use_psgd else PARAM_TOL
    for g, w in zip(got["params"], want["params"]):
        assert U.rel(g, w) <= tol, U.rel(g, w)
    assert len(got["q"]) == len(want["q"]) == (
        len(got["q"]) if use_psgd else 0)


def test_mesh_restart_replays_the_checkpointed_step(runs):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as ttrain
    _, port, _, tmp = runs
    plain, hurt = port["plain"], port["hurt"]
    assert plain["restarts"] == 0 and hurt["restarts"] == 1
    assert all(map(math.isfinite, plain["loss"]))
    assert hurt["loss"] == plain["loss"][:3] + plain["loss"][2:]
    assert CheckpointManager(str(tmp / "drill")).latest_step() == 4
    one = ttrain.train(U.reduced("qwen3_0_6b"), device="cpu", **DRILL)
    for g, w in zip(plain["loss"], one["loss"]):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (plain["loss"],
                                                  one["loss"])


def test_mesh_checkpoint_restores_on_one_device_and_back(runs):
    from repro_torch.launch import train as ttrain
    _, port, one_writer, tmp = runs
    mesh_writer = port["mesh_writes"]
    resumed = ttrain.train(U.reduced("qwen3_0_6b"), steps=3,
                           global_batch=BATCH, seq_len=SEQ, ckpt_every=2,
                           use_psgd=True, log_every=100, device="cpu",
                           ckpt_dir=str(tmp / "from_mesh"))
    assert len(resumed["loss"]) == 1                       # step 2 only
    w = mesh_writer["loss"][2]
    assert abs(resumed["loss"][0] - w) <= LOSS_RTOL * abs(w)
    mesh_reader = port["mesh_reads"]
    assert len(mesh_reader["loss"]) == 1
    w = one_writer["loss"][2]
    assert abs(mesh_reader["loss"][0] - w) <= LOSS_RTOL * abs(w)

