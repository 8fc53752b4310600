"""Fault-tolerant checkpointing of tensor trees: atomic, versioned,
elastic-restorable -- the port of the reference's
``repro/checkpoint/manager.py``, with the same on-disk layout, so that a
checkpoint written by either package restores in the other.

Layout:  <dir>/step_<N>/
           manifest.json       (step, leaf count, leaf paths, extra)
           leaf_<i>.npy        (one file per tree leaf, gathered to the host)
         <dir>/LATEST          (atomic pointer file)

Guarantees:
  * atomicity — writes go to ``step_<N>.tmp`` and are renamed after fsync;
    a crash mid-save never corrupts the previous checkpoint;
  * versioning + GC — keep the newest ``keep`` checkpoints;
  * elasticity — restore places the leaves on whatever device the new job
    passes (the rank count may differ from the saving job's: the elastic
    solve saves one global state and every rank slices its own strip);
  * async — ``save`` can run in a background thread (``block=False``) so
    the solve overlaps checkpoint I/O with compute.

Trees are flattened in the order ``jax.tree_util`` uses: dict keys
sorted, lists and tuples in order, dataclasses in field order (the
reference's ``PCGState.tree_flatten`` is its field order ``k, x, r, p, rz,
res, status``), ``None`` skipped; every other value is a leaf.  A
``NamedTuple``'s fields, and the fields of a dataclass that sets
``CKPT_FIELD_PATHS`` (the training state, a ``register_dataclass`` in the
reference), are named ``.field`` in the leaf paths, as ``jax.tree_util``
names them.  Tensors are written through ``.detach().cpu().numpy()``;
bfloat16, which numpy lacks, as its raw 2-byte words under the ``<V2``
descriptor the reference's ``ml_dtypes`` arrays write, and read back into
a bfloat16 leaf bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order; ``path`` is the
    reference's ``"/"``-joined key string (dict key, sequence index,
    ``.field`` of a named tuple or a ``CKPT_FIELD_PATHS`` dataclass, or
    another dataclass field's position)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        named = getattr(tree, "CKPT_FIELD_PATHS", False)
        items = [(f".{f.name}" if named else str(i), getattr(tree, f.name))
                 for i, f in enumerate(dataclasses.fields(tree))]
    else:
        return [("/".join(path), tree)]
    out: List[Tuple[str, Any]] = []
    for key, v in items:
        out += _flatten(v, path + (key,))
    return out


def _unflatten(tree, leaves: Iterator[Any]):
    """``tree``'s structure with its leaves replaced, in ``_flatten``
    order, by the next values of ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_unflatten(v, leaves) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    return next(leaves)


_BF16_DESCR = "<V2"          # what ml_dtypes' bfloat16 arrays write


def _host(leaf) -> np.ndarray:
    """The leaf on the host; a bfloat16 tensor as its 2-byte words in a
    ``V2`` array (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _save_leaf(path: str, arr: np.ndarray) -> None:
    """``np.save``; a ``V2`` array (bfloat16 words) under the reference's
    ``<V2`` descriptor, so both packages write the same bytes."""
    if arr.dtype != np.dtype("V2"):
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _tensor(arr: np.ndarray, like) -> torch.Tensor:
    """A loaded leaf as a tensor; 2-byte words (``V2``) become bfloat16 bit
    for bit when ``like`` is bfloat16."""
    if arr.dtype == np.dtype("V2") and isinstance(like, torch.Tensor) and \
            like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.as_tensor(arr)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None,
             block: bool = True) -> str:
        """Gather the tree's leaves to the host and write atomically."""
        flat = _flatten(tree)
        host = [_host(v) for _, v in flat]
        paths = [p for p, _ in flat]

        def _write():
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {
                "step": step,
                "n_leaves": len(host),
                "leaf_paths": paths,
                "extra": extra or {},
            }
            for i, arr in enumerate(host):
                _save_leaf(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            latest_tmp = os.path.join(self.directory, "LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(os.path.basename(final))
                f.flush()
                os.fsync(f.fileno())
            os.replace(latest_tmp, os.path.join(self.directory, "LATEST"))
            self._gc()

        if block:
            _write()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        return os.path.join(self.directory, f"step_{step:08d}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self, complete_only: bool = False):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        if complete_only:
            out = [s for s in out if self.is_complete(s)]
        return sorted(out)

    def is_complete(self, step: int) -> bool:
        """True iff the checkpoint can actually be restored: the manifest
        parses and every leaf file it indexes exists.  A crash between
        the atomic rename and a torn write elsewhere (or a truncated copy
        of the directory) leaves a partial step — restore must skip it,
        not raise."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            n = int(manifest["n_leaves"])
        except (OSError, ValueError, KeyError, TypeError):
            return False
        return all(os.path.exists(os.path.join(d, f"leaf_{i}.npy"))
                   for i in range(n))

    def latest_step(self, complete_only: bool = True) -> Optional[int]:
        """Newest restorable step: the LATEST pointer if it names a
        complete checkpoint, else the newest complete step on disk
        (``complete_only=False`` restores the old purely-structural
        scan)."""
        candidates = []
        ptr = os.path.join(self.directory, "LATEST")
        if os.path.exists(ptr):
            with open(ptr) as f:
                name = f.read().strip()
            if os.path.exists(os.path.join(self.directory, name)):
                candidates.append(int(name.split("_")[1]))
        candidates += sorted(self.list_steps(), reverse=True)
        for s in candidates:
            if not complete_only or self.is_complete(s):
                return s
        return None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device=None) -> Any:
        """Restore into the structure of ``tree_like``: every leaf becomes
        a tensor on ``device`` (default: the device of ``tree_like``'s leaf
        where that is a tensor, else the CPU) -- the elastic path places
        a state saved by another rank count on the new job's device.

        With ``step=None`` the newest COMPLETE checkpoint is used —
        a truncated/partial step (torn manifest, missing leaf file) falls
        back to the previous complete one instead of raising."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no complete checkpoint found")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like = [v for _, v in _flatten(tree_like)]
        assert manifest["n_leaves"] == len(like), \
            f"checkpoint has {manifest['n_leaves']} leaves, " \
            f"model expects {len(like)}"
        out = []
        for i, ref in enumerate(like):
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
            dev = device if device is not None else (
                ref.device if isinstance(ref, torch.Tensor) else "cpu")
            out.append(_tensor(arr, ref).to(dev))
        return _unflatten(tree_like, iter(out)), manifest

    def manifest(self, step: int) -> dict:
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)


def config_digest(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]
