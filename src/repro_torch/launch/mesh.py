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
its coordinates: what a sharded model run issues its collectives on.
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


@dataclasses.dataclass
class MeshComms:
    """One rank's view of a ``("data", "model")`` device mesh: a ``Comm``
    over its ``data`` group, its ``model`` group and the whole mesh
    (``world``, ranks in the mesh's row-major order), and its coordinate
    on each axis."""
    layout: MeshLayout
    data: "object"
    model: "object"
    world: "object"
    coords: Dict[str, int]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def comm(self, axes):
        """The ``Comm`` over ``axes`` (an axis name or a tuple of them):
        ``None`` for no axis, the whole mesh for ``("data", "model")``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        if not axes:
            return None
        if axes == ("data",):
            return self.data
        if axes == ("model",):
            return self.model
        if axes == tuple(self.layout.axes):
            return self.world
        raise ValueError(f"no communicator over axes {axes} of a "
                         f"{self.layout.axes} mesh")

    def reset_counts(self) -> None:
        for c in (self.data, self.model, self.world):
            c.reset_counts()

    def bytes_by_kind(self) -> Dict[str, Dict[str, int]]:
        """Received bytes by collective kind, per communicator."""
        return {name: dict(getattr(self, name).recv_by_kind)
                for name in ("data", "model", "world")}


_COMMS: Dict[int, Tuple[object, MeshComms]] = {}


def mesh_comms(mesh) -> Optional[MeshComms]:
    """The ``MeshComms`` of this rank on ``mesh`` (a ``DeviceMesh`` with
    axes ``("data", "model")`` over the whole world, as
    ``make_device_mesh`` builds it; a ``MeshComms`` is returned as it is,
    ``None`` stays ``None``).  Made once per mesh; its byte counts
    persist across calls."""
    if mesh is None or isinstance(mesh, MeshComms):
        return mesh
    hit = _COMMS.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    import torch.distributed as dist
    from repro_torch.core.comm import Comm
    axes = tuple(mesh.mesh_dim_names or ())
    if axes != ("data", "model"):
        raise ValueError(f"a sharded model run needs a ('data', 'model') "
                         f"mesh, got axes {axes}")
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the world")
    layout = MeshLayout(tuple(int(n) for n in mesh.shape), axes)
    mc = MeshComms(layout=layout, data=Comm(mesh.get_group("data")),
                   model=Comm(mesh.get_group("model")),
                   world=Comm(dist.group.WORLD),
                   coords={a: int(mesh.get_local_rank(a)) for a in axes})
    if mc.world.rank != mc.coords["data"] * layout.shape[1] + \
            mc.coords["model"]:
        raise ValueError("the mesh's ranks are not in row-major order")
    _COMMS[id(mesh)] = (mesh, mc)
    return mc
