"""PyTorch port: ``repro_torch.checkpoint.CheckpointManager`` against the
reference's ``repro.checkpoint.manager``.

The crash-consistency cases of ``tests/test_checkpoint.py`` (a torn
manifest, a missing leaf file and a ``LATEST`` pointer at a corrupt step
fall back to the newest complete step; no complete step raises; an
explicit step pins the restore; extra round-trips; async saves) and the
checkpoint cases of ``tests/test_substrate.py`` (round trip, versioning
and GC, a stale ``.tmp``, async save, restore onto a device) run against
the port on tensor trees.  Then the two packages against each other: the
same tree written by both gives the same files byte for byte (manifest,
leaves, ``LATEST``), and a ``PCGState`` and a dict tree written by either
restore in the other bitwise.  JAX is imported inside helpers only.
"""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, config_digest
from repro_torch.solvers.krylov import PCGState


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(16, generator=g),
            "k": torch.tensor(3, dtype=torch.int32),
            "res": torch.tensor(0.5, dtype=torch.float32)}


def _nested(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 4, generator=g),
            "nested": {"b": torch.arange(5.0),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _step_dir(d, step):
    return os.path.join(d, f"step_{step:08d}")


class TestCrashConsistency:
    def test_truncated_manifest_falls_back(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        t = _tree()
        mgr.save(1, t)
        mgr.save(2, _tree(seed=1))
        man = os.path.join(_step_dir(d, 2), "manifest.json")
        full = open(man).read()
        with open(man, "w") as f:
            f.write(full[: len(full) // 2])
        assert not mgr.is_complete(2)
        assert mgr.latest_step() == 1
        restored, m = mgr.restore(t)
        assert m["step"] == 1
        _equal(t, restored)

    def test_missing_leaf_file_falls_back(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        mgr.save(1, _tree())
        mgr.save(2, _tree(seed=1))
        os.remove(os.path.join(_step_dir(d, 2), "leaf_0.npy"))
        assert not mgr.is_complete(2) and mgr.is_complete(1)
        assert mgr.restore(_tree())[1]["step"] == 1

    def test_latest_pointer_at_corrupt_step_falls_back(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        mgr.save(1, _tree())
        mgr.save(2, _tree(seed=1))
        with open(os.path.join(_step_dir(d, 2), "manifest.json"), "w") as f:
            f.write("{not json")
        with open(os.path.join(d, "LATEST")) as f:
            assert f.read().strip() == "step_00000002"
        assert mgr.latest_step() == 1
        assert mgr.restore(_tree())[1]["step"] == 1

    def test_no_complete_checkpoint_raises(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        mgr.save(1, _tree())
        with open(os.path.join(_step_dir(d, 1), "manifest.json"), "w") as f:
            f.write("")
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError,
                           match="no complete checkpoint"):
            mgr.restore(_tree())

    def test_explicit_step_bypasses_completeness_scan(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(4, _tree())
        mgr.save(7, _tree(seed=2))
        assert mgr.restore(_tree(), step=4)[1]["step"] == 4

    def test_list_steps_complete_only(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        for s in (1, 2, 3):
            mgr.save(s, _tree(seed=s))
        os.remove(os.path.join(_step_dir(d, 2), "leaf_1.npy"))
        assert mgr.list_steps() == [1, 2, 3]
        assert mgr.list_steps(complete_only=True) == [1, 3]

    def test_manifest_extra_roundtrips(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, _tree(), extra={"p": 8, "tol": 1e-8, "iters": 50})
        _, m = mgr.restore(_tree())
        assert m["extra"]["p"] == 8 and m["extra"]["iters"] == 50

    def test_async_save_then_torn_then_restore(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        mgr.save(1, _tree(), block=False)
        mgr.save(2, _tree(seed=1), block=False)
        mgr.wait()
        man = os.path.join(_step_dir(d, 2), "manifest.json")
        doc = json.load(open(man))
        doc["n_leaves"] = "oops"
        json.dump(doc, open(man, "w"))
        assert mgr.latest_step() == 1


class TestSubstrateCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t = _nested()
        mgr.save(10, t)
        restored, man = mgr.restore(t)
        assert man["step"] == 10
        _equal(t, restored)
        assert isinstance(restored["nested"]["b"], torch.Tensor)

    def test_versioning_and_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _nested())
        assert mgr.list_steps() == [3, 4] and mgr.latest_step() == 4

    def test_atomicity_partial_write_ignored(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        mgr.save(5, _nested())
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        assert mgr.latest_step() == 5
        assert mgr.restore(_nested())[1]["step"] == 5

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _nested(), block=False)
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_restore_onto_device(self, tmp_path):
        """The elastic path: the leaves land on the device asked for."""
        mgr = CheckpointManager(str(tmp_path))
        t = _nested()
        mgr.save(3, t)
        restored, _ = mgr.restore(t, device="cpu")
        _equal(t, restored)
        assert restored["a"].device.type == "cpu"

    def test_pcg_state_none_status_skipped(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        st = PCGState(k=torch.tensor(4, dtype=torch.int32),
                      x=torch.arange(6.0), r=torch.ones(6), p=torch.zeros(6),
                      rz=torch.tensor(2.0), res=torch.tensor(0.25))
        mgr.save(1, st)
        assert mgr.manifest(1)["leaf_paths"] == ["0", "1", "2", "3", "4",
                                                 "5"]
        out, _ = mgr.restore(st)
        assert out.status is None and torch.equal(out.x, st.x)

    def test_config_digest_matches_reference(self):
        pytest.importorskip("jax")
        from repro.checkpoint.manager import config_digest as ref
        for obj in ({"n": 512, "tol": 1e-4}, ("halo-plan", 4), 3.5):
            assert config_digest(obj) == ref(obj)


# ---------------------------------------------------------------------------
# the two packages against each other

def _jax_tree(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _states(seed=0):
    """The same PCG state as the port's and the reference's PCGState."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.solvers.krylov import PCGState as RefState
    g = torch.Generator().manual_seed(seed)
    vals = dict(k=torch.tensor(30, dtype=torch.int32),
                x=torch.randn(64, generator=g),
                r=torch.randn(64, generator=g),
                p=torch.randn(64, generator=g),
                rz=torch.tensor(0.125), res=torch.tensor(3.5e-4),
                status=torch.tensor(0, dtype=torch.int32))
    ours = PCGState(**vals)
    ref = RefState(**{k: jnp.asarray(v.numpy()) for k, v in vals.items()})
    return ours, ref


@pytest.mark.parametrize("what", ["pcg_state", "dict"])
def test_same_files_as_reference(tmp_path, what):
    from repro.checkpoint.manager import CheckpointManager as RefManager
    if what == "pcg_state":
        ours, ref = _states()
    else:
        pytest.importorskip("jax")
        ours = _nested()
        ref = _jax_tree(ours)
    extra = {"p": 4, "tol": 1e-4, "comm": "halo-plan", "n": 512}
    CheckpointManager(str(tmp_path / "port")).save(3, ours, extra=extra)
    RefManager(str(tmp_path / "ref")).save(3, ref, extra=extra)
    cmp = filecmp.dircmp(tmp_path / "port" / "step_00000003",
                         tmp_path / "ref" / "step_00000003")
    assert cmp.left_only == [] and cmp.right_only == []
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port" / "step_00000003",
        tmp_path / "ref" / "step_00000003", cmp.common_files, shallow=False)
    assert mismatch == [] and errors == []
    assert (tmp_path / "port" / "LATEST").read_bytes() == \
        (tmp_path / "ref" / "LATEST").read_bytes()


@pytest.mark.parametrize("what", ["pcg_state", "dict"])
def test_reference_checkpoint_restores_in_port(tmp_path, what):
    from repro.checkpoint.manager import CheckpointManager as RefManager
    if what == "pcg_state":
        ours, ref = _states(seed=1)
    else:
        pytest.importorskip("jax")
        ours = _nested(seed=1)
        ref = _jax_tree(ours)
    RefManager(str(tmp_path)).save(6, ref, extra={"iters": 60})
    like = _states(seed=2)[0] if what == "pcg_state" else _nested(seed=2)
    got, man = CheckpointManager(str(tmp_path)).restore(like)
    assert man["step"] == 6 and man["extra"] == {"iters": 60}
    if what == "pcg_state":
        for f in ("k", "x", "r", "p", "rz", "res", "status"):
            _equal(getattr(ours, f), getattr(got, f))
    else:
        _equal(ours, got)


@pytest.mark.parametrize("what", ["pcg_state", "dict"])
def test_port_checkpoint_restores_in_reference(tmp_path, what):
    from repro.checkpoint.manager import CheckpointManager as RefManager
    if what == "pcg_state":
        ours, ref = _states(seed=3)
        like = _states(seed=4)[1]
    else:
        pytest.importorskip("jax")
        ours = _nested(seed=3)
        ref = _jax_tree(ours)
        like = _jax_tree(_nested(seed=4))
    CheckpointManager(str(tmp_path)).save(2, ours)
    got, man = RefManager(str(tmp_path)).restore(like)
    assert man["step"] == 2
    if what == "pcg_state":
        for f in ("k", "x", "r", "p", "rz", "res", "status"):
            _equal(getattr(ref, f), getattr(got, f))
    else:
        _equal({k: np.asarray(v) if not isinstance(v, dict) else
                {kk: np.asarray(vv) for kk, vv in v.items()}
                for k, v in ref.items()},
               {k: np.asarray(v) if not isinstance(v, dict) else
                {kk: np.asarray(vv) for kk, vv in v.items()}
                for k, v in got.items()})
