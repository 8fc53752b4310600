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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


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
