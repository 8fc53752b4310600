"""Production layouts, the port of the reference's ``launch/mesh.py``.

Single pod: (16, 16) ``("data", "model")`` = 256 devices.  Multi-pod:
(2, 16, 16) ``("pod", "data", "model")`` = 512 devices; the ``pod`` axis
carries data parallelism across pods.  The distributed H^2 operator
partitions its block rows over the data axes, so a layout implies the H^2
rank count p = 16 or 32 (the product of its data axes); the ``model`` axis
replicates the operator.

A layout is plain data: nothing here touches a device or a process group
until ``make_device_mesh`` is called on an initialised group.  The sharding
rules (``parallel/sharding.py``) read a layout's axis sizes.

``mesh_comms`` gives a rank of a ``DeviceMesh`` its ``core.comm.Comm``
over each axis group (``data``, ``model``) and over the whole mesh, and
its coordinates: what a sharded model run issues its collectives on.  On
the multi-pod layout the data axes ``("pod", "data")`` form one flattened
data group.  ``dry_mesh_comms`` is the same view of any rank of any
layout made of ``DryComm``s: a run on it walks that rank's program alone
(``launch/dryrun.py``'s per-rank walk).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A device mesh's shape and axis names."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]


SINGLE_POD = MeshLayout((16, 16), ("data", "model"))
MULTI_POD = MeshLayout((2, 16, 16), ("pod", "data", "model"))


def production_layout(*, multi_pod: bool = False) -> MeshLayout:
    return MULTI_POD if multi_pod else SINGLE_POD


def data_axes(layout: MeshLayout) -> Tuple[str, ...]:
    return tuple(a for a in layout.axes if a in ("pod", "data"))


def h2_ranks(layout: MeshLayout) -> int:
    """The H^2 rank count p a layout implies: the product of its data
    axes (the reference's ``dryrun_h2`` p)."""
    return math.prod(layout.axis_size(a) for a in data_axes(layout))


def make_device_mesh(layout: MeshLayout, device_type: str = "cuda"):
    """A ``torch.distributed`` ``DeviceMesh`` of ``layout`` over the
    initialised default group (its world size must be ``layout.size``);
    every rank calls it, in the same order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group")
    if dist.get_world_size() != layout.size:
        raise ValueError(f"a {layout.shape} mesh needs {layout.size} ranks, "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(device_type, layout.shape,
                            mesh_dim_names=layout.axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2,
                   device_type: str = "cpu"):
    """A small ``("data", "model")`` mesh for multi-process CPU tests
    (gloo)."""
    return make_device_mesh(MeshLayout((n_data, n_model), ("data", "model")),
                            device_type)


def unravel(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` in a mesh of ``shape``."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


@dataclasses.dataclass
class MeshComms:
    """One rank's view of a ``("data", "model")`` or ``("pod", "data",
    "model")`` device mesh: a ``Comm`` over its data group (the ranks of
    its ``model`` coordinate: on the multi-pod layout the pod x data
    product, flattened, as the reference's ``P(("pod", "data"), ...)``
    shards over their product), its ``model`` group and the whole mesh
    (``world``, ranks in the mesh's row-major order), and its coordinate
    on each axis (``coords["data"]`` is the flat data coordinate, ``pod *
    n_data + data``: the rank of ``data``)."""
    layout: MeshLayout
    data: "object"
    model: "object"
    world: "object"
    coords: Dict[str, int]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def comm(self, axes):
        """The ``Comm`` over ``axes`` (an axis name or a tuple of them):
        ``None`` for no axis, ``data`` for the layout's data axes, the
        whole mesh for every axis."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        if not axes:
            return None
        if axes == data_axes(self.layout):
            return self.data
        if axes == ("model",):
            return self.model
        if axes == tuple(self.layout.axes):
            return self.world
        raise ValueError(f"no communicator over axes {axes} of a "
                         f"{self.layout.axes} mesh")

    def index(self, axes) -> int:
        """This rank's block index over ``axes`` in their order (row-major
        over their sizes): ``comm(axes).rank`` where that exists."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = dict(zip(self.layout.axes,
                       unravel(self.world.rank, self.layout.shape)))
        idx = 0
        for a in axes:
            idx = idx * self.layout.axis_size(a) + pos[a]
        return idx

    def reset_counts(self) -> None:
        for c in (self.data, self.model, self.world):
            c.reset_counts()

    def bytes_by_kind(self, out: bool = False) -> Dict[str, Dict[str, int]]:
        """Received bytes by collective kind, per communicator (``out``:
        the collectives' output bytes, ``Comm.out_by_kind``)."""
        field = "out_by_kind" if out else "recv_by_kind"
        return {name: dict(getattr(getattr(self, name), field))
                for name in ("data", "model", "world")}


def sum_by_kind(per_comm: Dict[str, Dict[str, int]]) -> Dict[str, int]:
    """``MeshComms.bytes_by_kind``'s counts summed over the
    communicators."""
    out: Dict[str, int] = {}
    for counts in per_comm.values():
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out


MESH_AXES = (("data", "model"), ("pod", "data", "model"))
_COMMS: Dict[int, Tuple[object, MeshComms]] = {}


def _check_axes(axes: Tuple[str, ...]) -> None:
    if tuple(axes) not in MESH_AXES:
        raise ValueError(f"a sharded model run needs a ('data', 'model') or "
                         f"('pod', 'data', 'model') mesh, got axes {axes}")


def _coords(layout: MeshLayout, rank: int) -> Dict[str, int]:
    pos = dict(zip(layout.axes, unravel(rank, layout.shape)))
    pos["data"] = rank // layout.axis_size("model")
    return pos


def mesh_comms(mesh) -> Optional[MeshComms]:
    """The ``MeshComms`` of this rank on ``mesh`` (a ``DeviceMesh`` with
    axes ``("data", "model")`` or ``("pod", "data", "model")`` over the
    whole world, as ``make_device_mesh`` builds it; a ``MeshComms`` is
    returned as it is, ``None`` stays ``None``).  Made once per mesh; its
    byte counts persist across calls.  On the multi-pod layout every rank
    creates the flattened data groups, in the same order
    (``torch.distributed.new_group``), at its first call."""
    if mesh is None or isinstance(mesh, MeshComms):
        return mesh
    hit = _COMMS.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    axes = tuple(mesh.mesh_dim_names or ())
    _check_axes(axes)
    layout = MeshLayout(tuple(int(n) for n in mesh.shape), axes)
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the world")
    rank = dist.get_rank()
    if tuple(int(mesh.get_local_rank(a)) for a in layout.axes) != \
            unravel(rank, layout.shape):
        raise ValueError("the mesh's ranks are not in row-major order")
    m = layout.axis_size("model")
    if len(layout.axes) == 2:
        data = mesh.get_group("data")
    else:
        groups = [dist.new_group(list(range(t, layout.size, m)))
                  for t in range(m)]
        data = groups[rank % m]
    mc = MeshComms(layout=layout, data=Comm(data),
                   model=Comm(mesh.get_group("model")),
                   world=Comm(dist.group.WORLD),
                   coords=_coords(layout, rank))
    _COMMS[id(mesh)] = (mesh, mc)
    return mc


def dry_mesh_comms(layout: MeshLayout, rank: int) -> MeshComms:
    """Rank ``rank``'s ``MeshComms`` on ``layout`` made of
    ``core.comm.DryComm``s, with no process group: a model run on it
    walks that rank's program alone (its collectives land uninitialised
    tensors of their shapes and count their bytes as ``Comm`` does)."""
    from repro_torch.core.comm import DryComm
    _check_axes(layout.axes)
    if not 0 <= rank < layout.size:
        raise ValueError(f"rank {rank} outside a mesh of {layout.size}")
    m = layout.axis_size("model")
    return MeshComms(layout=layout,
                     data=DryComm(rank // m, layout.size // m),
                     model=DryComm(rank % m, m),
                     world=DryComm(rank, layout.size),
                     coords=_coords(layout, rank))
