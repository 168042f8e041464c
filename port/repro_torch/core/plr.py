"""Greedy piecewise linear regression (PLR) — the paper's learned-index model.

Implements the Greedy-PLR algorithm (Xie et al., "Maximum Error-bounded
Piecewise Linear Representation for Online Stream Approximation", VLDB J. 2014)
used by Bourbon §4.1: one pass over (key, position) pairs maintaining a slope
cone; when a point cannot be covered within the error bound delta, the current
segment is closed and a new one begins.  Guarantee: for every trained point,
|predict(key) - pos| <= delta.

``greedy_plr_np`` is a copy of ``repro.core.plr.greedy_plr_np``: the same
float64 operations in the same order, so its segments are bit-equal to the
JAX package's.  ``greedy_plr_torch`` is the port of ``greedy_plr_jax``:
the same cone, one step per key, as a loop of tensor operations that never
synchronizes inside the loop (tests/test_torch_kernels_cuda.py holds it to
that on the card).  The fitted :class:`PLRModel` holds numpy
arrays; the engine stacks them per level into device tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PLRModel", "greedy_plr_np", "greedy_plr_torch",
           "greedy_plr_tensors", "plr_predict_np"]


@dataclasses.dataclass
class PLRModel:
    """Piecewise-linear model: segment s covers keys in [starts[s], starts[s+1]).

    Arrays are padded to a fixed capacity with ``n_segments`` giving the live
    count; padding starts are +inf so searchsorted routes probes correctly.
    """

    starts: np.ndarray       # (S,) float64 segment start keys (padded +inf)
    slopes: np.ndarray       # (S,) float64
    intercepts: np.ndarray   # (S,) float64  (pos = slope * key + intercept)
    n_segments: int
    delta: int = 8           # error bound
    # monotonic epoch stamped by whoever fit (or loaded) the model; cache
    # keys use it instead of id(), which the allocator can reuse after GC
    epoch: int = -1

    @property
    def nbytes(self) -> int:
        return int(self.n_segments) * 3 * 8 + 4  # three float64 arrays + count


def _finalize_segment(x0, y0, slo, shi):
    slope = (slo + shi) / 2.0
    if not np.isfinite(slope):  # single-point segment: flat line through it
        slope = 0.0
    intercept = y0 - slope * x0
    return slope, intercept


def greedy_plr_np(keys: np.ndarray, delta: int = 8, pad_to: int | None = None) -> PLRModel:
    """Fit Greedy-PLR over sorted ``keys`` mapping key -> index.

    Linear time, single pass.  ``pad_to`` pads segment arrays to a fixed size
    (required when models are stacked across sstables).
    """
    keys = np.asarray(keys, dtype=np.float64)
    n = keys.shape[0]
    starts, slopes, intercepts = [], [], []
    if n > 0:
        x0, y0 = keys[0], 0.0
        slo, shi = -np.inf, np.inf
        for i in range(1, n):
            x, y = keys[i], float(i)
            dx = x - x0
            if dx <= 0:  # duplicate key: keep cone unchanged (same x)
                continue
            lo_i = (y - delta - y0) / dx
            hi_i = (y + delta - y0) / dx
            nlo, nhi = max(slo, lo_i), min(shi, hi_i)
            if nlo > nhi:  # cone empty -> close segment, start new at (x, y)
                s, b = _finalize_segment(x0, y0, slo, shi)
                starts.append(x0); slopes.append(s); intercepts.append(b)
                x0, y0 = x, y
                slo, shi = -np.inf, np.inf
            else:
                slo, shi = nlo, nhi
        s, b = _finalize_segment(x0, y0, slo, shi)
        starts.append(x0); slopes.append(s); intercepts.append(b)
    ns = len(starts)
    cap = pad_to if pad_to is not None else max(ns, 1)
    if ns > cap:
        raise ValueError(f"PLR needs {ns} segments > pad_to={cap}")
    st = np.full(cap, np.inf, dtype=np.float64)
    sl = np.zeros(cap, dtype=np.float64)
    ic = np.zeros(cap, dtype=np.float64)
    st[:ns] = starts; sl[:ns] = slopes; ic[:ns] = intercepts
    return PLRModel(st, sl, ic, ns, delta=delta)


def plr_predict_np(model: PLRModel, probes: np.ndarray) -> np.ndarray:
    """Reference host-side prediction (for tests)."""
    ns = int(model.n_segments)
    seg = np.clip(np.searchsorted(model.starts[:ns], probes, side="right") - 1,
                  0, max(ns - 1, 0))
    return model.slopes[seg] * probes.astype(np.float64) + model.intercepts[seg]


# ----------------------------------------------------------------------------
# tensor version — identical cone algorithm, one step per key.
# ----------------------------------------------------------------------------

def greedy_plr_torch(keys, delta: int = 8, cap: int = 1024,
                     device: str = "cuda") -> PLRModel:
    """Greedy-PLR over sorted ``keys`` (a tensor or array, at least one key)
    as a loop of tensor operations on ``device`` (the card unless the
    caller asks for the CPU).  ``cap`` bounds the number of segments.

    Semantics match ``greedy_plr_np``; segments beyond ``cap`` raise in the
    numpy version and clamp here (the last slot is overwritten), as in
    ``repro.core.plr.greedy_plr_jax``.  The keys are copied to the device
    once and the model back once at the end; the loop between
    (:func:`greedy_plr_tensors`) never waits for the device."""
    from .engine import resolve_device
    dev = resolve_device(device)
    x = torch.as_tensor(keys).to(device=dev, dtype=torch.float64)
    st, sl, ic, si = greedy_plr_tensors(x, delta, cap)
    return PLRModel(st.cpu().numpy(), sl.cpu().numpy(), ic.cpu().numpy(),
                    int(si) + 1, delta=delta)


def greedy_plr_tensors(x: torch.Tensor, delta: int, cap: int) -> tuple:
    """The cone loop of :func:`greedy_plr_torch` on float64 keys ``x``, on
    their device.  Returns (starts, slopes, intercepts) of ``cap`` slots and
    the 0-d index of the last segment's slot (unclamped), all on the
    device.  Every branch is a ``torch.where`` and every slot access an
    ``index_select`` / ``index_copy_`` with a device index, so no step
    copies a value to the host."""
    dev = x.device
    f64 = dict(dtype=torch.float64, device=dev)
    inf = torch.full((), float("inf"), **f64)
    st = torch.full((cap,), float("inf"), **f64)
    sl = torch.zeros(cap, **f64)
    ic = torch.zeros(cap, **f64)
    y = torch.arange(x.shape[0], **f64)
    x0, y0 = x[0], y[0]
    slo, shi = -inf, inf
    si = torch.zeros(1, dtype=torch.int64, device=dev)
    zero = torch.zeros((), **f64)

    def finalize(x0, y0, slo, shi):
        # single-point segment (an infinite cone): slope 0 through the point
        s = (slo + shi) / 2.0
        s = torch.where(torch.isfinite(s), s, zero)
        return s, y0 - s * x0

    def store(slot, close, vals):
        for arr, v in zip((st, sl, ic), vals):
            arr.index_copy_(0, slot, torch.where(
                close, v, arr.index_select(0, slot)))

    for i in range(1, x.shape[0]):
        xi, yi = x[i], y[i]
        dx = xi - x0
        pos = dx > 0
        safe = torch.where(pos, dx, torch.ones_like(dx))
        lo_i = torch.where(pos, (yi - delta - y0) / safe, -inf)
        hi_i = torch.where(pos, (yi + delta - y0) / safe, inf)
        nlo, nhi = torch.maximum(slo, lo_i), torch.minimum(shi, hi_i)
        close = nlo > nhi
        store(si.clamp(max=cap - 1), close, (x0, *finalize(x0, y0, slo, shi)))
        si = si + close.long()
        # a duplicate key (dx <= 0) leaves the cone unchanged; then the
        # cone cannot close, since slo <= shi always holds
        x0 = torch.where(close, xi, x0)
        y0 = torch.where(close, yi, y0)
        slo = torch.where(close, -inf, torch.where(pos, nlo, slo))
        shi = torch.where(close, inf, torch.where(pos, nhi, shi))
    store(si.clamp(max=cap - 1), torch.ones((), dtype=torch.bool, device=dev),
          (x0, *finalize(x0, y0, slo, shi)))
    return st, sl, ic, si[0]
