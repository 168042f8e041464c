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
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.mesh import Mesh

__all__ = ["make_production_mesh", "batch_axes", "HW", "hbm_bytes"]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if devices is None:
        devices = "cuda"
    if isinstance(devices, (str, torch.device)):
        devices = [resolve_device(devices)] * n
    return Mesh(tuple(devices), axes, shape)


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
