"""PyTorch port: the card's ``[lmmesh]`` phase of ``chip_smoke.py``
rehearsed on 4 spawned gloo CPU ranks at the reduced configurations (the
sharded serving and training held to the one-device port, the MoE's
drops per data shard, the bytes by collective kind).  No JAX.
"""
import torch

torch.set_num_threads(2)


def test_lmmesh_phase_runs_on_cpu(monkeypatch):
    """The card's ``[lmmesh]`` phase rehearsed on 4 gloo CPU ranks at the
    reduced configurations: every check holds and no kernel launches."""
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    failed = []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: None if ok else failed.append(what))
    out = cs.lmmesh_phase(torch, device="cpu", reduced=True)
    assert not failed, failed
    assert not any(out["launches"].values())
    assert len(out["ranks"]) == 4
    for r in out["ranks"]:
        assert r["serve/moe"]["tokens_equal"]
        assert r["train/attn_tp=False"]["loss_err"] <= cs.LMMESH_LOSS_TOL
