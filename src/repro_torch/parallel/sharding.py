"""Sharding rules: DP / FSDP(ZeRO) / TP / SP / EP over the production
layouts, the port of the reference's ``parallel/sharding.py``.

Axis roles (see ``launch/mesh.py``):
  - ``data`` axes (("pod","data") multi-pod, ("data",) single-pod): batch /
    block-row parallelism; FSDP shards params+optimizer state over them.
  - ``model`` axis: Megatron tensor parallelism (attention heads, FFN
    hidden, vocab), sequence parallelism for the residual stream, expert
    parallelism for MoE, and KV-cache sequence sharding for decode.

A spec is a plain tuple with one entry per dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the entries of the
reference's ``PartitionSpec``).  The rules read a ``launch.mesh.MeshLayout``
(``layout.axis_size(axis)``) where the reference reads ``mesh.shape``; they
are plain data and touch no device.  ``shard_shape`` gives one device's
block of a sharded tensor.

The models still run unsharded: ``constrain`` returns its input when no
device mesh is given and raises otherwise, until the models run under the
rules over several ranks (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

from repro_torch.launch.mesh import MeshLayout

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    data_axes: Tuple[str, ...] = ("data",)   # ("pod","data") when multi-pod
    model_axis: str = "model"
    fsdp: bool = True             # ZeRO: shard params/opt over data
    seq_parallel: bool = True     # residual stream sharded over model
    # attention TP mode: True -> shard KV heads over model (requires
    # n_kv_heads % model_size == 0); False -> context parallelism on query
    # blocks with attention weights replicated over model (FSDP only).
    attn_tp: bool = True
    # False when the global batch does not divide the data axes (long_500k
    # batch=1): activation batch dims stay replicated; params still FSDP.
    batch_shardable: bool = True
    # decode KV-cache sequence sharding override (e.g. ("data","model") for
    # 2D-sharded long-context caches); None -> model axis only.
    seq_axes_decode: Optional[Tuple[str, ...]] = None

    @property
    def dp(self):
        if not self.batch_shardable:
            return None
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def tp(self):
        return self.model_axis

    # ---- activation specs ----
    def act(self) -> Spec:
        """Residual stream [B, S, D]."""
        if self.seq_parallel:
            return (self.dp, self.tp, None)
        return (self.dp, None, None)

    def act_full(self) -> Spec:
        """[B, S, D] inside a TP region (sequence gathered)."""
        return (self.dp, None, None)

    def heads(self, n_heads: int, model_size: int) -> Spec:
        """[B, S, H, dh]: heads sharded when divisible, else replicated."""
        if n_heads % model_size == 0:
            return (self.dp, None, self.tp, None)
        return (self.dp, None, None, None)

    def kv_cache_decode(self) -> Spec:
        """[B, S, H_kv, dh]: the decode cache is sequence-sharded over
        model (any GQA head count; the softmax and contraction reductions
        over the sharded axis become psums)."""
        return (self.dp, self.decode_seq, None, None)

    @property
    def decode_seq(self):
        return self.seq_axes_decode or self.tp

    def logits(self) -> Spec:
        return (self.dp, None, self.tp)


def mesh_axis_size(layout: MeshLayout, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(layout.axis_size(a) for a in axes)


def _maybe_fsdp(spec: Sequence, shape: Tuple[int, ...], rules: Rules,
                layout: MeshLayout) -> Spec:
    """Add the data axes to the largest still-unsharded divisible dim
    (ZeRO)."""
    if not rules.fsdp:
        return tuple(spec)
    dsize = mesh_axis_size(layout, rules.data_axes)
    dp = rules.data_axes if len(rules.data_axes) > 1 else rules.data_axes[0]
    spec = list(spec)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize:
            spec[i] = dp
            break
    return tuple(spec)


_COL = ("wkv", "w_in", "w1", "w3", "w_gate", "w_up", "r_proj", "k_proj",
        "v_proj", "g_proj", "in_proj", "cm_k")
_ROW = ("w2", "w_down", "w_out", "o_proj", "out_proj", "cm_v")


def param_spec(path: str, shape: Tuple[int, ...], rules: Rules,
               layout: MeshLayout) -> Spec:
    """A parameter's spec from its path name (``"blocks/attn/wq"``).

    Stacked-by-layer params (a leading L dim) are detected by the
    ``blocks/`` prefix: the layer dim is never sharded.
    """
    tp = rules.tp
    msize = layout.axis_size(tp)
    stacked = path.startswith("blocks/") or "/blocks/" in path
    core = shape[1:] if stacked else shape
    name = path.split("/")[-1]

    def out(core_spec):
        full = ((None,) + tuple(core_spec)) if stacked else tuple(core_spec)
        return _maybe_fsdp(full, shape, rules, layout)

    def tp_ok(dim):
        return dim % msize == 0 and dim >= msize

    if len(core) == 1:
        return out([None])
    if name in ("embed", "unembed", "head"):
        # [V, D] / [D, V]
        big = 0 if core[0] > core[1] else 1
        spec = [None, None]
        if tp_ok(core[big]):
            spec[big] = tp
        return out(spec)
    if name in ("wq", "wk", "wv"):
        spec = [None] * len(core)
        if rules.attn_tp and tp_ok(core[-1]):
            spec[-1] = tp
        return out(spec)
    if name == "wo":
        spec = [None] * len(core)
        if rules.attn_tp and tp_ok(core[0]):
            spec[0] = tp
        return out(spec)
    if name in _COL:
        spec = [None] * len(core)
        if tp_ok(core[-1]):
            spec[-1] = tp
        return out(spec)
    if name in _ROW:
        spec = [None] * len(core)
        if tp_ok(core[0]):
            spec[0] = tp
        return out(spec)
    if name.startswith("moe_"):
        # [E, D, F] expert-parallel when E divisible, else shard F
        e = core[0]
        if e % msize == 0:
            return out([tp, None, None])
        if name == "moe_w2":    # [E, F, D]
            return out([None, tp, None])
        return out([None, None, tp])
    # default: shard the largest TP-divisible dim
    spec = [None] * len(core)
    order = sorted(range(len(core)), key=lambda i: -core[i])
    for i in order:
        if tp_ok(core[i]):
            spec[i] = tp
            break
    return out(spec)


def make_param_shardings(params, rules: Rules, layout: MeshLayout,
                         path: str = ""):
    """The spec of every leaf of a parameter tree (nested dicts of
    tensors, ``meta`` ones included), in the tree's structure: the
    counterpart of the reference's ``make_param_shardings``, which wraps
    each spec in a ``NamedSharding``."""
    if isinstance(params, dict):
        return {k: make_param_shardings(v, rules, layout,
                                        f"{path}/{k}" if path else str(k))
                for k, v in params.items()}
    return param_spec(path, tuple(params.shape), rules, layout)


def shard_shape(shape: Sequence[int], spec: Spec, layout: MeshLayout
                ) -> Tuple[int, ...]:
    """One device's block of a ``shape`` tensor laid out by ``spec``
    (``NamedSharding.shard_shape``): each dim divided by the size of its
    axes.  Raises ``ValueError`` when an axis does not divide its dim."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for i, d in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        n = 1 if axes is None else mesh_axis_size(layout, axes)
        if d % n:
            raise ValueError(f"dim {i} of {tuple(shape)} ({d}) does not "
                             f"divide over {axes!r} ({n} devices)")
        out.append(d // n)
    return tuple(out)


def constrain(x, spec: Spec, mesh=None):
    """``x`` laid out by ``spec`` on ``mesh``.  Without a device mesh the
    port runs unsharded and ``x`` is returned as it is."""
    if mesh is None:
        return x
    raise NotImplementedError(
        "sharding constraints on a device mesh: the models do not yet run "
        "under the rules over several ranks (ROADMAP Queue 1 item 4)")
