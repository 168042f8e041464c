"""Production mesh construction (the port of ``repro.launch.mesh``).

A function, not a module-level constant: importing this module touches no
device.  Single pod: (data=16, model=16) = 256 positions; multi-pod:
(pod=2, data=16, model=16) = 512 positions.  The shapes and axis names are
the reference's, so that specs resolved on either mesh can be held equal.

A position is a device of the port's :class:`~repro_torch.core.mesh.Mesh`,
and a device may repeat.  Without ``devices`` every position is the card
(the counterpart of the reference's forced host devices); ``devices``
names one device to repeat (``"cpu"``, or ``"meta"`` for a plan that
allocates nothing) or lists one device a position.

:func:`make_process_mesh` is the mesh of a program that runs one process
a position (``launch/spmd``): a :class:`~repro_torch.core.mesh.ProcessMesh`
over the ranks of the default process group, whose tensors are split
across the positions.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.mesh import Mesh, ProcessMesh

__all__ = ["make_production_mesh", "make_process_mesh", "batch_axes", "HW",
           "hbm_bytes", "AXIS_ORDER"]

AXIS_ORDER = ("pod", "data", "model")   # the reference's, major to minor


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if devices is None:
        devices = "cuda"
    if isinstance(devices, (str, torch.device)):
        devices = [resolve_device(devices)] * n
    return Mesh(tuple(devices), axes, shape)


def make_process_mesh(shape, axes, device) -> ProcessMesh:
    """The mesh of ``shape`` over the ranks of the default process group,
    rank ``r`` at row-major position ``r``, each rank on ``device`` (its
    own: the caller names it, as it named the backend).  ``axes`` keep the
    reference's order (pod, data, model); the group's size must be the
    mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes, names "
                         f"{axes} {len(axes)}")
    order = [AXIS_ORDER.index(a) for a in axes if a in AXIS_ORDER]
    if len(order) != len(axes) or order != sorted(set(order)):
        raise ValueError(f"mesh axes {axes} are not in the order "
                         f"{AXIS_ORDER}")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} processes, the "
                         f"group has {dist.get_world_size()}")
    device = torch.device(device)
    # a mesh of "meta" pieces (a plan) is a CPU mesh to DTensor, which
    # then issues its shard all-to-all as an all-gather and a chunk
    kind = "cpu" if device.type == "meta" else device.type
    grid = torch.arange(n).reshape(shape)
    return ProcessMesh(DeviceMesh(kind, grid, mesh_dim_names=axes), device)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


class HW:
    """NVIDIA H100 SXM5 figures for the roofline, per GPU (NVIDIA's data
    sheet; dense rates at the 700 W power limit; the card the port is
    measured on is an NVIDIA H100 80GB HBM3, whose limit ``nvidia-smi``
    reports beside every measurement).

    The "data" and "model" axes ride NVLink (450 GB/s a direction a GPU);
    the "pod" axis crosses hosts over InfiniBand NDR (400 Gb/s = 50 GB/s a
    GPU).  An NVLink domain holds 8 GPUs, so a 16-wide axis spans two of
    them and part of its traffic crosses InfiniBand: the collective term
    these figures give is a lower bound."""
    PEAK_BF16_FLOPS = 989e12     # FLOP/s, dense bf16 tensor cores
    HBM_BW = 3.35e12             # B/s
    NVLINK_BW = 450e9            # B/s a direction a GPU ("data", "model")
    IB_BW = 50e9                 # B/s a GPU, InfiniBand NDR ("pod")
    HBM_BYTES = 80 * 2**30       # the data sheet's 80 GB; see hbm_bytes()


def hbm_bytes() -> int:
    """The card's memory, read from the device when there is one, else the
    data sheet's :attr:`HW.HBM_BYTES`."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return HW.HBM_BYTES
