"""PyTorch port: the training loop (``launch/train.py``) and its
checkpoints against the JAX reference, on ``qwen3-0.6b`` at
``reduced(float32)``.

* Three steps of ``build_train_step`` from a state carried across by
  ``train_state_from_numpy`` (AdamW at step 25, past the warmup, so the
  updates move the parameters), PowerSGD on and off, against the
  reference's jitted ``step_fn``: the loss within 1e-5 relative and every
  parameter leaf within 1e-5 relative at each step.
* ``train()`` with a ``FailureInjector``: one restart, resumed from the
  newest checkpoint, and the loss history bitwise that of an
  uninterrupted run (the restored step replayed).
* A checkpoint written by the reference's ``train()`` (PowerSGD on)
  restores into the port's ``train()``, whose next loss equals the
  reference's within 1e-5; the two packages name the training state's
  checkpoint leaves alike.
* bfloat16 checkpoints: the port writes the reference's bytes (leaf files
  and manifest) and restores the reference's files bit for bit.
* The CLI (``--reduced --device cpu --steps 3``) runs.
* On the card (``cuda`` marker): two steps on CUDA tensors against the
  CPU's.

JAX is imported inside helpers only.
"""
import json
import math
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as cbase
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.optim.grad_compress import PowerSGDConfig
from repro_torch.runtime.fault import FailureInjector

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
ARCH = "qwen3-0.6b"
START_STEP = 25
TOTAL = 100
BATCH, SEQ = 4, 32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfg(**kw):
    return cbase.get_config(ARCH).reduced(param_dtype="float32",
                                          act_dtype="float32", **kw)


def _rcfg(**kw):
    from repro.configs import base as rbase
    return rbase.get_config(ARCH).reduced(param_dtype="float32",
                                          act_dtype="float32", **kw)


def _data():
    return SyntheticLM(vocab=_cfg().vocab, seq_len=SEQ, global_batch=BATCH,
                       seed=0)


# ---------------------------------------------------------------------------
# three steps from a carried state
# ---------------------------------------------------------------------------

def _reference_run(use_psgd: bool):
    """(the reference's starting state as numpy, its losses and parameter
    leaves after each of 3 steps)."""
    import jax
    import jax.numpy as jnp
    from repro.launch import train as rtrain
    from repro.optim import adamw as radamw
    from repro.optim.grad_compress import PowerSGDConfig as RPSGD
    rcfg = _rcfg()
    opt_cfg = radamw.AdamWConfig(lr=1e-3)
    psgd_cfg = RPSGD(rank=4, min_compress_size=4096) if use_psgd else None
    state = rtrain.init_train_state(rcfg, opt_cfg, jax.random.PRNGKey(0),
                                    psgd_cfg=psgd_cfg)
    state = rtrain.TrainState(state.params, state.opt._replace(
        step=jnp.int32(START_STEP)), state.psgd)
    start = jax.tree.map(np.asarray, state)
    step_fn = jax.jit(rtrain.build_train_step(rcfg, opt_cfg, None, None,
                                              TOTAL, psgd_cfg))
    data = _data()
    out = []
    for i in range(3):
        state, met = step_fn(state, {"tokens": jnp.asarray(data.batch(i))})
        out.append((float(met["loss"]),
                    [np.asarray(x) for x in jax.tree.leaves(state.params)]))
    return start, out


@pytest.mark.parametrize("use_psgd", [False, True], ids=["adamw", "psgd"])
def test_three_steps_match_reference(use_psgd):
    start, want = _reference_run(use_psgd)
    cfg = _cfg()
    state = ttrain.train_state_from_numpy(cfg, start, "cpu")
    assert int(state.opt.step) == START_STEP
    assert (state.psgd is not None) == use_psgd
    psgd_cfg = PowerSGDConfig(rank=4, min_compress_size=4096) \
        if use_psgd else None
    step_fn = ttrain.build_train_step(cfg, adamw.AdamWConfig(lr=1e-3),
                                      total_steps=TOTAL, psgd_cfg=psgd_cfg)
    data = _data()
    before = [p.clone() for p in adamw.tree_leaves(state.params)]
    for i, (rloss, rparams) in enumerate(want):
        state, met = step_fn(state, ttrain.make_train_batch(
            cfg, data.batch(i), "cpu"))
        assert abs(float(met["loss"]) - rloss) <= LOSS_RTOL * abs(rloss), \
            (i, float(met["loss"]), rloss)
        leaves = adamw.tree_leaves(state.params)
        assert len(leaves) == len(rparams)
        for j, (g, w) in enumerate(zip(leaves, rparams)):
            assert _rel(g.numpy(), w) <= PARAM_RTOL, (i, j,
                                                      _rel(g.numpy(), w))
    assert int(state.opt.step) == START_STEP + 3
    moved = [not torch.equal(a, b) for a, b in
             zip(before, adamw.tree_leaves(state.params))]
    assert all(moved)


# ---------------------------------------------------------------------------
# restart and resume
# ---------------------------------------------------------------------------

def test_train_restart_resumes_from_newest_checkpoint(tmp_path):
    cfg = _cfg()
    kw = dict(steps=6, global_batch=BATCH, seq_len=SEQ, device="cpu",
              log_every=100)
    plain = ttrain.train(cfg, **kw)
    hurt = ttrain.train(cfg, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                        injector=FailureInjector({3: "device lost"}), **kw)
    assert plain["restarts"] == 0 and hurt["restarts"] == 1
    assert len(plain["loss"]) == 6 and all(map(math.isfinite,
                                               plain["loss"]))
    # the failure at step 3 resumes from the checkpoint of step 2: step 2
    # runs again, from the state it first ran from
    assert hurt["loss"] == plain["loss"][:3] + plain["loss"][2:]
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 6
    assert len(plain["grad_norm"]) == len(plain["step_s"]) == 6


def test_restart_waits_for_a_save_in_flight(tmp_path, monkeypatch):
    """A failure while the newest checkpoint is still being written (an
    async save slower than a step) resumes from that checkpoint."""
    from repro_torch.checkpoint import manager
    save_leaf = manager._save_leaf

    def slow(path, arr):
        time.sleep(0.05)
        save_leaf(path, arr)
    monkeypatch.setattr(manager, "_save_leaf", slow)
    cfg = _cfg()
    kw = dict(steps=5, global_batch=BATCH, seq_len=SEQ, device="cpu",
              log_every=100)
    plain = ttrain.train(cfg, **kw)
    hurt = ttrain.train(cfg, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                        injector=FailureInjector({3: "device lost"}), **kw)
    assert hurt["restarts"] == 1
    # step 2's checkpoint was still being written when step 3 failed
    assert hurt["loss"] == plain["loss"][:3] + plain["loss"][2:]
    assert CheckpointManager(str(tmp_path / "ck")).list_steps() == [2, 4]


def test_reference_checkpoint_restores_into_port_train(tmp_path):
    from repro.launch import train as rtrain
    d = str(tmp_path / "ck")
    kw = dict(steps=3, global_batch=BATCH, seq_len=SEQ, ckpt_every=2,
              use_psgd=True, log_every=100)
    ref = rtrain.train(_rcfg(), ckpt_dir=d, **kw)      # saves step 2
    assert CheckpointManager(d).latest_step() == 2
    port = ttrain.train(_cfg(), ckpt_dir=d, device="cpu", **kw)
    assert len(port["loss"]) == 1                      # step 2 only
    assert abs(port["loss"][0] - ref["loss"][2]) <= \
        LOSS_RTOL * abs(ref["loss"][2]), (port["loss"], ref["loss"])

    # the port names the state's leaves as the reference does
    state = ttrain.init_train_state(
        _cfg(), adamw.AdamWConfig(), 0, "cpu",
        psgd_cfg=PowerSGDConfig(rank=4, min_compress_size=4096))
    CheckpointManager(str(tmp_path / "port")).save(7, state)
    with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
        want = json.load(f)["leaf_paths"]
    got = CheckpointManager(str(tmp_path / "port")).manifest(7)["leaf_paths"]
    assert got == want
    assert got[-1].startswith(".psgd/.err/")


# ---------------------------------------------------------------------------
# bfloat16 checkpoints
# ---------------------------------------------------------------------------

def _bf16_reference_params():
    import jax
    from repro.configs import base as rbase
    from repro.models import api as rapi
    rcfg = rbase.get_config(ARCH).reduced()         # bfloat16
    return rcfg, rapi.init_params(rcfg, jax.random.PRNGKey(0))


def test_bf16_checkpoint_bytes_equal_reference(tmp_path):
    import jax
    from repro.checkpoint.manager import CheckpointManager as RefManager
    rcfg, rparams = _bf16_reference_params()
    cfg = cbase.get_config(ARCH).reduced()
    assert cfg.param_dtype == "bfloat16"
    params = api.params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                                   "cpu")
    assert all(p.dtype == torch.bfloat16 for p in adamw.tree_leaves(params))
    RefManager(str(tmp_path / "ref")).save(3, rparams, extra={"k": 1})
    CheckpointManager(str(tmp_path / "port")).save(3, params,
                                                   extra={"k": 1})
    names = sorted(os.listdir(tmp_path / "ref" / "step_00000003"))
    assert names == sorted(os.listdir(tmp_path / "port" / "step_00000003"))
    assert len(names) == len(adamw.tree_leaves(params)) + 1
    for name in names:
        a = (tmp_path / "ref" / "step_00000003" / name).read_bytes()
        b = (tmp_path / "port" / "step_00000003" / name).read_bytes()
        assert a == b, name


def test_bf16_reference_checkpoint_restores_bitwise(tmp_path):
    import jax
    from repro.checkpoint.manager import CheckpointManager as RefManager
    rcfg, rparams = _bf16_reference_params()
    RefManager(str(tmp_path / "ref")).save(1, rparams)
    cfg = cbase.get_config(ARCH).reduced()
    like = api.init_params(cfg, 5, "cpu")
    got, manifest = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert manifest["step"] == 1
    want = jax.tree.leaves(rparams)
    for g, w in zip(adamw.tree_leaves(got), want):
        assert g.dtype == torch.bfloat16
        bits = np.asarray(w).view(np.uint16).astype(np.int64)
        assert np.array_equal(g.view(torch.int16).numpy().astype(np.int64)
                              & 0xFFFF, bits)
    # and the port's own bfloat16 state round-trips
    state = ttrain.init_train_state(cfg, adamw.AdamWConfig(), 2, "cpu")
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(4, state)
    back, _ = mgr.restore(ttrain.init_train_state(cfg, adamw.AdamWConfig(),
                                                  3, "cpu"))
    for a, b in zip(adamw.tree_leaves(state.params),
                    adamw.tree_leaves(back.params)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    assert int(back.opt.step) == 0 and isinstance(back.opt,
                                                   adamw.AdamWState)


# ---------------------------------------------------------------------------
# the CLI and the guards
# ---------------------------------------------------------------------------

def test_cli_reduced_on_cpu_runs(capsys):
    ttrain.main(["--reduced", "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "final loss" in out and "restarts=0" in out


def test_mesh_and_rules_raise():
    """A mesh whose axes are not ``("data", "model")`` raises
    ``ValueError``; rules without a mesh train as one device does.  (The
    mesh runs are in ``test_torch_train_mesh.py``.)"""
    from repro_torch.parallel.sharding import Rules

    class _Mesh:                            # a 1-D DeviceMesh stand-in
        mesh_dim_names = ("blk",)

    cfg = _cfg()
    with pytest.raises(ValueError, match="mesh"):
        ttrain.build_train_step(cfg, adamw.AdamWConfig(), mesh=_Mesh())
    with pytest.raises(ValueError, match="mesh"):
        ttrain.train(cfg, steps=1, mesh=_Mesh(), rules=Rules(),
                     device="cpu")
    a = ttrain.train(cfg, steps=2, global_batch=2, seq_len=8, device="cpu",
                     log_every=100)
    b = ttrain.train(cfg, steps=2, global_batch=2, seq_len=8, device="cpu",
                     rules=Rules(), log_every=100)
    assert a["loss"] == b["loss"]


def test_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_psgd", [False, True], ids=["adamw", "psgd"])
def test_cuda_train_steps_match_cpu(cuda, use_psgd):
    cfg = _cfg()
    psgd_cfg = PowerSGDConfig(rank=4, min_compress_size=4096) \
        if use_psgd else None
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    cpu = ttrain.init_train_state(cfg, opt_cfg, 0, "cpu", psgd_cfg=psgd_cfg)
    cpu = ttrain.TrainState(cpu.params, cpu.opt._replace(
        step=torch.tensor(START_STEP, dtype=torch.int32)), cpu.psgd)
    card = ttrain.TrainState(
        adamw.tree_map(lambda t: t.to(cuda), cpu.params),
        adamw.AdamWState(cpu.opt.step.to(cuda),
                         adamw.tree_map(lambda t: t.to(cuda), cpu.opt.m),
                         adamw.tree_map(lambda t: t.to(cuda), cpu.opt.v)),
        None if cpu.psgd is None else type(cpu.psgd)(
            *[[None if t is None else t.to(cuda) for t in ts]
              for ts in cpu.psgd]))
    step_fn = ttrain.build_train_step(cfg, opt_cfg, total_steps=TOTAL,
                                      psgd_cfg=psgd_cfg)
    data = _data()
    for i in range(2):
        cpu, mc = step_fn(cpu, ttrain.make_train_batch(cfg, data.batch(i),
                                                       "cpu"))
        card, mg = step_fn(card, ttrain.make_train_batch(cfg, data.batch(i),
                                                         cuda))
        assert math.isclose(float(mg["loss"]), float(mc["loss"]),
                            rel_tol=LOSS_RTOL)
        for a, b in zip(adamw.tree_leaves(card.params),
                        adamw.tree_leaves(cpu.params)):
            assert _rel(a.cpu().numpy(), b.numpy()) <= PARAM_RTOL
