"""The device mesh of the distributed GET (what the port needs of
``jax.sharding.Mesh`` and ``repro.core.jaxcompat.make_mesh``).

A :class:`Mesh` is a tuple of devices laid out over named axes.  The
distributed GET reads it flattened, in row-major order, as the reference
reads ``P(axes)`` with a tuple of axes: device ``s`` of the flattened
mesh holds shard row ``s`` and the ``s``-th slice of every probe batch.
One process drives every device of the mesh; the collectives are
stream-ordered device-to-device copies (``core.distributed``).

A device may appear more than once.  A mesh of ``cpu`` repeated, or of
one card repeated, stands in for the reference's forced host devices
(``--xla_force_host_platform_device_count``): the same program runs, one
shard row a mesh position, on fewer physical devices.  A mesh of ``meta``
holds the layout of a plan that allocates nothing (``launch/dryrun``).

``repro.core.jaxcompat`` has no counterpart: it papers over JAX releases
that moved ``make_mesh``, ``shard_map`` and ``set_mesh``.  PyTorch has no
ambient mesh to set (every call takes its mesh explicitly) and no
``shard_map`` to find, so nothing here depends on the installed version.

A :class:`ProcessMesh` is the other kind: one process a position, each
with its own device, the positions being the ranks of the default process
group (``launch/mesh.make_process_mesh``, ``launch/spmd``).  A model laid
out over it is split: each rank holds its shard of every tensor as a
``DTensor`` (``launch/sharding``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Mesh", "ProcessMesh", "make_mesh"]


def _indexed(d: torch.device) -> torch.device:
    """A CUDA device named without an index is the current one."""
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` flattened in row-major order over ``shape``, one axis
    name per dimension."""
    devices: tuple
    axis_names: tuple
    shape: tuple

    def __post_init__(self) -> None:
        devs = tuple(_indexed(torch.device(d)) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} has "
                             f"{len(self.shape)} axes, names "
                             f"{self.axis_names} {len(self.axis_names)}")
        if math.prod(self.shape) != len(devs) or not devs:
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(devs)}")
        for d in devs:
            if d.type not in ("cpu", "cuda", "meta"):
                raise ValueError(f"unsupported mesh device {d}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_sizes(self) -> dict:
        """{axis name: size}, what the reference reads as ``mesh.shape``."""
        return dict(zip(self.axis_names, self.shape))

    def device(self) -> torch.device:
        """The one device every position is.  A mesh of distinct devices
        raises ``NotImplementedError``: one process never splits a model
        across devices; a :class:`ProcessMesh` does, one process a
        device."""
        distinct = set(self.devices)
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh of {len(distinct)} distinct devices in one process: "
                "multi-card model execution runs one process a device "
                "(ProcessMesh, launch/spmd); repeat one device instead")
        return self.devices[0]


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A mesh whose positions are the ranks of the default process group,
    flattened in row-major order over ``shape`` as ``device_mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh``) lays them out, one axis
    name per dimension.  ``local`` is this process's one device."""
    device_mesh: object
    local: torch.device

    def __post_init__(self) -> None:
        object.__setattr__(self, "local", _indexed(torch.device(self.local)))
        if self.local.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"unsupported mesh device {self.local}")
        if self.device_mesh.mesh_dim_names is None:
            raise ValueError("a process mesh needs named axes")

    @property
    def axis_names(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> tuple:
        return tuple(self.device_mesh.mesh.shape)

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def coordinate(self) -> tuple:
        """This rank's position on each axis."""
        return tuple(self.device_mesh.get_coordinate())

    def device(self) -> torch.device:
        """This process's device."""
        return self.local


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (names or ``torch.device``s,
    row-major; repeats allowed).  Without ``devices`` it takes the first
    ``prod(shape)`` distinct CUDA devices, and raises if there are fewer."""
    shape = tuple(shape)
    if devices is None:
        need = math.prod(shape)
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise RuntimeError(f"a mesh of shape {shape} needs {need} CUDA "
                               f"devices, {have} available (pass devices= "
                               "to repeat a device)")
        devices = [torch.device("cuda", i) for i in range(need)]
    return Mesh(tuple(devices), tuple(axis_names), shape)
