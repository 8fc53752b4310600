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

On a device mesh every rank holds its block of each tensor.
``constrain`` lays a tensor out by a spec (the reference's
``with_sharding_constraint``, a pure layout change whose backward is the
reverse one); ``local_block`` slices a global tensor to this rank's block
and ``assemble`` gathers the global tensor from the rank blocks.
``ShardCtx`` is what a model run carries on a mesh: the rules, the
per-axis communicators (``launch.mesh.MeshComms``) and the spec of every
parameter; ``take`` brings a parameter block into the layout its
consumer computes in (gathered over ``data`` for FSDP, over ``model``
where the consumer wants it whole, sliced where it wants a block), with
the transposed collectives in the backward (``parallel.collectives``).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

from repro_torch.launch.mesh import MeshComms, MeshLayout, mesh_comms
from . import collectives as C

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


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def constrain(x, spec: Spec, mesh=None, src: Optional[Spec] = None):
    """``x`` laid out by ``spec`` on ``mesh``, from its current layout
    ``src`` (default: replicated).  Each dim whose axes change is gathered
    over the axes it no longer shards over and sliced over the ones it now
    shards over; the backward is the reverse layout change (a gather's
    backward keeps this rank's block, a slice's gathers).  Without a mesh,
    or on a mesh of one rank, ``x`` is returned as it is."""
    mc = mesh_comms(mesh)
    if mc is None:
        return x
    src = tuple(src) if src is not None else (None,) * x.dim()
    pairs = [(_axes(src[i] if i < len(src) else None),
              _axes(spec[i] if i < len(spec) else None))
             for i in range(x.dim())]
    for i, (a, b) in enumerate(pairs):          # every gather first
        if a != b and a:
            x = C.all_gather(x, i, mc.comm(a), grad="slice")
    for i, (a, b) in enumerate(pairs):
        if a != b and b:
            comm = mc.comm(b)
            if comm is not None and comm.rank != mc.index(b):
                raise ValueError(f"axes {b} are not in the mesh's order")
            x = C.scatter(x, i, comm)
    return x


def local_block(x, spec: Spec, mesh):
    """This rank's block of the global tensor ``x`` laid out by ``spec``
    (no communication)."""
    mc = mesh_comms(mesh)
    if mc is None:
        return x
    for i in range(min(len(spec), x.dim())):
        axes = _axes(spec[i])
        if axes:
            n = mesh_axis_size(mc.layout, axes)
            x = C.block(x, i, n, mc.index(axes))
    return x


def assemble(x, spec: Spec, mesh):
    """The global tensor whose blocks laid out by ``spec`` the ranks hold
    (every rank calls it and every rank gets the whole tensor)."""
    return constrain(x, (None,) * x.dim(), mesh, src=spec)


def tree_local(tree, specs, mesh):
    """``local_block`` of every leaf of a nested dict, by the spec tree."""
    if isinstance(tree, dict):
        return {k: tree_local(v, specs[k], mesh) for k, v in tree.items()}
    return local_block(tree, specs, mesh)


def tree_assemble(tree, specs, mesh):
    """``assemble`` of every leaf of a nested dict, by the spec tree."""
    if isinstance(tree, dict):
        return {k: tree_assemble(tree[k], specs[k], mesh)
                for k in sorted(tree)}
    return assemble(tree, specs, mesh)


class Sharded(dict):
    """A (sub)tree of a rank's parameter blocks that carries the spec of
    every leaf (``specs``, a tree of the same keys); a subtree read from
    it is ``Sharded`` too."""

    def __init__(self, tree, specs):
        super().__init__(tree)
        self.specs = specs

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        return Sharded(v, self.specs[key]) if isinstance(v, dict) else v


class ShardCtx:
    """One rank's sharded model run: the ``rules``, the communicators
    ``mc`` (``data``, ``model``, ``world``), the parameter specs, and the
    residual stream's layout of the current sequence (``sp``: sharded over
    ``model`` along the sequence -- the rules' ``act()`` --, set by
    ``at``).

    ``m``/``t`` are the model axis's size and this rank's coordinate on it,
    ``dsize``/``d`` the data axes' (their product and this rank's flat
    coordinate: the multi-pod ``("pod", "data")`` act as one data
    group).  A replicated residual stream is computed alike on every
    model rank, and its gradient is full there;
    the split work of the tensor-parallel regions takes partial
    gradients (``parallel.collectives``)."""

    def __init__(self, mc: MeshComms, rules: Rules, specs):
        if tuple(rules.data_axes) != tuple(
                a for a in mc.layout.axes if a != rules.tp):
            raise ValueError(f"the rules' data axes {rules.data_axes} are "
                             f"not the mesh's {mc.layout.axes} less "
                             f"{rules.tp!r}")
        self.mc, self.rules, self.specs = mc, rules, specs
        self.m = mc.layout.axis_size(rules.tp)
        self.t = mc.coord(rules.tp)
        self.dsize, self.d = mc.data.p, mc.data.rank
        self.model, self.data = mc.model, mc.data
        self.sp = False
        if rules.seq_axes_decode and rules.batch_shardable and \
                set(rules.seq_axes_decode) & set(rules.data_axes):
            raise ValueError("seq_axes_decode over a data axis needs "
                             "batch_shardable=False")

    # -- layouts -------------------------------------------------------

    def at(self, s: int, seq: bool = True) -> "ShardCtx":
        """This run with the residual stream of an ``s``-long sequence:
        sequence-sharded over ``model`` when ``seq``, the rules' sequence
        parallelism, and ``s`` divisible allow, else replicated."""
        c = copy.copy(self)
        c.sp = bool(seq and self.rules.seq_parallel and self.m > 1
                    and s % self.m == 0)
        return c

    def tp_ok(self, n: int) -> bool:
        """Whether a dim of ``n`` shards over ``model`` (``tp_ok`` of
        ``param_spec``), with more than one model rank."""
        return self.m > 1 and n % self.m == 0 and n >= self.m

    def heads_tp(self, cfg) -> bool:
        """The attention shards its KV heads over ``model`` (the reference's
        ``attn_tp and hkv % model_size == 0``), else it runs context
        parallel on query blocks."""
        return self.m > 1 and self.rules.attn_tp and \
            cfg.n_kv_heads % self.m == 0

    def enter(self, x):
        """The residual stream ``x`` [B, S(/m), D] whole for split work:
        gathered along the sequence (backward: reduce-scatter) when
        sequence-sharded, else ``copy_to``."""
        if self.sp:
            return C.all_gather(x, 1, self.model)
        return C.copy_to(x, self.model)

    def leave(self, y):
        """Split work's partial sums ``y`` [B, S, D] back into the residual
        stream's layout: reduce-scatter along the sequence when
        sequence-sharded, else ``reduce_from``."""
        if self.sp:
            return C.reduce_scatter(y, 1, self.model)
        return C.reduce_from(y, self.model)

    def rows(self, x, dim: int = 1):
        """This model rank's block of ``x`` along ``dim`` (no
        communication)."""
        return C.block(x, dim, self.m, self.t)

    def data_sum(self, total, rows_local: int):
        """A loss's per-row sum ``total`` of this data shard's
        ``rows_local`` rows, summed over the data axis (backward: the
        identity), and the global row count.  When the batch is not
        sharded every data rank holds every row: its share is
        ``1/dsize``, so the backward still sums partial gradients."""
        if self.rules.batch_shardable:
            return C.reduce_from(total, self.data), rows_local * self.dsize
        return C.reduce_from(total / self.dsize, self.data), rows_local

    # -- the decode cache ------------------------------------------------

    def seq_comm(self):
        """The communicator the decode cache's sequence shards over
        (``Rules.decode_seq``)."""
        return self.mc.comm(self.rules.decode_seq)

    def seq_block(self) -> Tuple[int, int]:
        """(this rank's block index, the block count) of the decode cache's
        sequence."""
        axes = _axes(self.rules.decode_seq)
        return (self.mc.index(axes),
                mesh_axis_size(self.mc.layout, axes))

    def decode_cache(self, kv, cache_len: int, heads_sharded: bool):
        """A prefill's K or V ``[..., B, S, Hkv(/m), dh]`` (KV heads sharded
        over ``model`` when ``heads_sharded``, else whole) as this rank's
        block of the decode cache ``[..., B, cache_len/n, Hkv, dh]``:
        padded to ``cache_len`` and sharded over the sequence
        (``kv_cache_decode``).  Heads sharded over ``model`` trade places
        with the sequence in one all-to-all when the cache shards over
        ``model`` alone."""
        import torch.nn.functional as F
        s = kv.shape[-3]
        if cache_len % self.seq_block()[1]:
            raise ValueError(f"cache_len {cache_len} does not split over "
                             f"the {self.seq_block()[1]} sequence shards "
                             f"of the decode cache")
        if cache_len > s:
            kv = F.pad(kv, (0, 0, 0, 0, 0, cache_len - s))
        idx, n = self.seq_block()
        if heads_sharded and self.m > 1:
            if self.seq_comm() is self.model:
                lead = kv.shape[:-3]
                x = kv.reshape(*lead, n, cache_len // n, *kv.shape[-2:])
                x = x.movedim(-4, 0).contiguous()
                x = self.model.all_to_all(x)        # [m(src), ..., S/m, h, d]
                x = x.movedim(0, -3)                # [..., S/m, m, h, d]
                return x.reshape(*x.shape[:-3], -1, x.shape[-1])
            kv = C.all_gather(kv, -2, self.model)
        return C.block(kv, kv.dim() - 3, n, idx)

    # -- parameters ------------------------------------------------------

    def tree(self, params) -> Sharded:
        return Sharded(params, self.specs)


    def layer(self, sub: Sharded, idx) -> Sharded:
        """Layer ``idx`` (an int, or a tuple for several stacked dims) of a
        stacked subtree: views of the blocks, the specs without the
        stacked dims.  A stacked dim sharded over an axis is gathered
        first (backward: this rank's block; ``take`` then sums the
        gradient over the axis as for a replicated leaf)."""
        idx = (idx,) if isinstance(idx, int) else tuple(idx)
        k = len(idx)

        def one(x, spec):
            if isinstance(x, dict):
                out = {key: one(x[key], spec[key]) for key in x}
                return ({key: v[0] for key, v in out.items()},
                        {key: v[1] for key, v in out.items()})
            spec = tuple(spec)
            for i in range(k):
                if spec[i] is not None:
                    x = C.all_gather(x, i, self.mc.comm(spec[i]), "slice")
            return x[idx], spec[k:]

        tree, specs = one(dict(sub), sub.specs)
        return Sharded(tree, specs)

    def take(self, p: Sharded, name: str, want="stored",
             split: Optional[bool] = None):
        """Parameter ``name`` of ``p`` in the layout its consumer computes
        in: gathered over ``data`` where FSDP shards it (backward:
        reduce-scatter over ``data``; a leaf replicated over ``data`` gets
        ``copy_to``, the data-parallel gradient sum), then on ``model``
        sharded along dim ``want`` (``None``: whole; ``"stored"``: as its
        spec keeps it).  ``split``: whether the consumer's work is split
        over the model ranks (its gradient partial; default: when it wants
        a block, or the residual stream is sequence-sharded)."""
        x = dict.__getitem__(p, name)
        spec = tuple(p.specs[name]) + (None,) * (x.dim() - len(p.specs[name]))
        tp = self.rules.tp
        ddims = [i for i, e in enumerate(spec) if e is not None and e != tp]
        if ddims:
            x = C.all_gather(x, ddims[0], self.data)
        else:
            x = C.copy_to(x, self.data)
        cur = spec.index(tp) if tp in spec else None
        if want == "stored":
            want = cur
        elif want is not None:
            want %= x.dim()
        if split is None:
            split = want is not None or self.sp
        if cur == want:
            if cur is None and split:
                x = C.copy_to(x, self.model)
            return x
        if cur is not None:
            x = C.all_gather(x, cur, self.model, "sum" if split else "slice")
        elif split:
            x = C.copy_to(x, self.model)
        if want is not None:
            x = C.block(x, want, self.m, self.t)
        return x

    def param_dim(self, p: Sharded, name: str):
        """The dim that ``name``'s spec shards over ``model``, or None."""
        spec = tuple(p.specs[name])
        return spec.index(self.rules.tp) if self.rules.tp in spec else None
