"""Int8 gradient compression for a data-parallel reduction (the port of
``repro.optim.grad_compress``).

Per-block (BLOCK elements) absmax int8 quantization with optional
stochastic rounding; :func:`compressed_psum` sums int8 payloads in int32
across the devices of one mesh axis and dequantizes with the mean scale.
The reference runs it inside ``shard_map``, one shard a device, with a
``psum``; the port has one process driving every device of a
:class:`~repro_torch.core.mesh.Mesh`, so the caller passes one piece a
device and gets each device's result back, the sums made of
device-to-device copies as in ``core.distributed.build_dist_get``.
The reference's stochastic rounding draws from ``jax.random``, which torch
has no counterpart of: the draws here come from a ``torch.Generator``, so
only the properties hold (the error bound, unbiasedness), while
``generator=None`` (round half to even) equals the reference bit for bit.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.distributed import _sum_on
from repro_torch.core.mesh import Mesh

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum", "BLOCK"]

BLOCK = 256


def quantize_int8(x: torch.Tensor, generator: torch.Generator | None = None):
    """(q (n_blocks, BLOCK) int8, scale (n_blocks, 1) float32).  With a
    ``generator``, stochastic rounding (floor of y plus a uniform draw on
    the generator's device) keeps E[dequant] = x."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    y = blocks / scale
    if generator is not None:
        u = torch.rand(y.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        y = torch.floor(y + u.to(y.device))
    else:
        y = torch.round(y)
    q = torch.clamp(y, -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def compressed_psum(pieces, mesh: Mesh, axis_name: str,
                    generator: torch.Generator | None = None) -> tuple:
    """Quantize -> sum over ``axis_name`` -> dequantize.

    ``pieces`` holds one tensor a mesh device, in the mesh's row-major
    order, each on its device (the reference's shard of each device).  The
    int8 payloads are summed in int32 among the devices that differ only
    on ``axis_name``, clipped to ±127·n, and dequantized with the mean of
    their scales (n devices on the axis).  Returns each device's result,
    in mesh order, on its device, in its piece's shape and dtype."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"no axis {axis_name!r} in mesh axes "
                         f"{mesh.axis_names}")
    pieces = list(pieces)
    if len(pieces) != mesh.size:
        raise ValueError(f"{len(pieces)} pieces for a mesh of "
                         f"{mesh.size} devices")
    ax = mesh.axis_names.index(axis_name)
    n = mesh.shape[ax]
    quant = [quantize_int8(x, generator) for x in pieces]
    out = [None] * mesh.size
    others = [range(k) for i, k in enumerate(mesh.shape) if i != ax]
    for rest in itertools.product(*others):
        idx = []
        for j in range(n):
            coord = list(rest)
            coord.insert(ax, j)
            idx.append(int(np.ravel_multi_index(coord, mesh.shape)))
        for i in idx:
            dev = mesh.devices[i]
            qsum = _sum_on([quant[j][0].to(torch.int32) for j in idx], dev)
            ssum = _sum_on([quant[j][1] for j in idx], dev)
            out[i] = dequantize_int8(
                torch.clamp(qsum, -127 * n, 127 * n), ssum / n,
                pieces[i].shape, pieces[i].dtype)
    return tuple(out)
