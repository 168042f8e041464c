"""Greedy piecewise linear regression (PLR) — the paper's learned-index model.

Implements the Greedy-PLR algorithm (Xie et al., "Maximum Error-bounded
Piecewise Linear Representation for Online Stream Approximation", VLDB J. 2014)
used by Bourbon §4.1: one pass over (key, position) pairs maintaining a slope
cone; when a point cannot be covered within the error bound delta, the current
segment is closed and a new one begins.  Guarantee: for every trained point,
|predict(key) - pos| <= delta.

``greedy_plr_np`` is a copy of ``repro.core.plr.greedy_plr_np``: the same
float64 operations in the same order, so its segments are bit-equal to the
JAX package's.  The fitted :class:`PLRModel` holds numpy arrays; the engine
stacks them per level into device tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PLRModel", "greedy_plr_np", "plr_predict_np"]


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
