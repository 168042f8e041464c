"""Wrappers of the five hand-written kernels: the four of the descent
(rows form) and the filter plane's stack probe.

A wrapper checks device, dtype, shape and contiguity, then either runs the
plain PyTorch version (``kernels.ref``) because its tensors lie on the CPU,
or launches the CUDA kernel on ``torch.cuda.current_stream()`` for CUDA
tensors, allocating outputs with ``torch.empty``.  There is no fallback: a
CUDA call that cannot launch raises.  ``launches[name]`` counts kernel
launches only (plain-version calls do not count), so a run can show that
its main path went through the kernels.

Layouts (F files of a level, B probes, ``rows`` (B,) int32 = file row):

* ``plr_lookup``:   starts/slopes/icepts (F, S) f64, nseg/n (F,) i32
* ``bounded_search``: keys (F, C) i64, n (F,) i32, pos (B,) i32
* ``bloom_probe``:  bits (F, W) i64 (the uint64 words), nw (F,) i32
* ``sstable_search``: fences (F, NB) i64, keys (F, C) i64, n_blocks/n (F,) i32

and, without rows (every probe against every row):

* ``bloom_probe_stack``: bits (L, W) i64 (the uint64 words), nw (L,) i32
  -> (L, B) bool
"""

from __future__ import annotations

import torch

from . import build
from . import ref as _ref

__all__ = ["plr_lookup", "bounded_search", "bloom_probe", "sstable_search",
           "bloom_probe_stack", "launches", "reset_launches"]

launches = {"plr_lookup": 0, "bounded_search": 0, "bloom_probe": 0,
            "sstable_search": 0, "bloom_probe_stack": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, probes on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_rows(rows: torch.Tensor, probes: torch.Tensor,
                F: int, **per_file: torch.Tensor) -> torch.device:
    dev = probes.device
    _check("probes", probes, torch.int64, 1, dev)
    _check("rows", rows, torch.int32, 1, dev)
    if rows.shape != probes.shape:
        raise ValueError(f"rows {tuple(rows.shape)} != probes "
                         f"{tuple(probes.shape)}")
    for name, t in per_file.items():
        _check(name, t, torch.int32, 1, dev)
        if t.shape[0] != F:
            raise ValueError(f"{name}: expected ({F},), got {tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch(name: str, fn: str, *args) -> None:
    err = getattr(build.load(), fn)(*args,
                                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def plr_lookup(starts, slopes, icepts, nseg, n, rows, probes) -> torch.Tensor:
    """ModelLookup per probe -> pos (B,) int32 (see ref.plr_lookup_rows_ref)."""
    F, S = starts.shape
    dev = _check_rows(rows, probes, F, nseg=nseg, n=n)
    for name, t in (("starts", starts), ("slopes", slopes), ("icepts", icepts)):
        _check(name, t, torch.float64, 2, dev)
        if t.shape != (F, S):
            raise ValueError(f"{name}: expected {(F, S)}, got {tuple(t.shape)}")
    if dev.type == "cpu":
        return _ref.plr_lookup_rows_ref(starts, slopes, icepts, nseg, n, rows,
                                        probes)
    B = probes.shape[0]
    pos = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _launch("plr_lookup", "plr_lookup_rows", starts.data_ptr(),
                slopes.data_ptr(), icepts.data_ptr(), nseg.data_ptr(),
                n.data_ptr(), rows.data_ptr(), probes.data_ptr(),
                pos.data_ptr(), B, S)
    return pos


def bounded_search(keys, n, rows, pos, probes, delta: int):
    """Window search around pos -> (idx (B,) int32, found (B,) bool)."""
    F, C = keys.shape
    dev = _check_rows(rows, probes, F, n=n)
    _check("keys", keys, torch.int64, 2, dev)
    _check("pos", pos, torch.int32, 1, dev)
    if pos.shape != probes.shape:
        raise ValueError("pos and probes differ in shape")
    if dev.type == "cpu":
        return _ref.bounded_search_rows_ref(keys, n, rows, pos, probes, delta)
    B = probes.shape[0]
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _launch("bounded_search", "bounded_search_rows", keys.data_ptr(),
                n.data_ptr(), rows.data_ptr(), pos.data_ptr(),
                probes.data_ptr(), idx.data_ptr(), found.data_ptr(), B, C,
                int(delta))
    return idx, found


def bloom_probe(bits, nw, rows, probes, k_hashes: int) -> torch.Tensor:
    """Bloom probe into each probe's filter row -> maybe (B,) bool."""
    F, W = bits.shape
    dev = _check_rows(rows, probes, F, nw=nw)
    _check("bits", bits, torch.int64, 2, dev)
    if dev.type == "cpu":
        return _ref.bloom_probe_rows_ref(bits, nw, rows, probes, k_hashes)
    B = probes.shape[0]
    maybe = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _launch("bloom_probe", "bloom_probe_rows", bits.data_ptr(),
                nw.data_ptr(), rows.data_ptr(), probes.data_ptr(),
                maybe.data_ptr(), B, W, int(k_hashes))
    return maybe


def sstable_search(fences, keys, n_blocks, n, rows, probes,
                   block_records: int):
    """Fence + in-block bisect -> (idx (B,) int32, found (B,) bool)."""
    F, C = keys.shape
    dev = _check_rows(rows, probes, F, n_blocks=n_blocks, n=n)
    _check("keys", keys, torch.int64, 2, dev)
    _check("fences", fences, torch.int64, 2, dev)
    if fences.shape[0] != F:
        raise ValueError(f"fences: expected {F} rows, got {fences.shape[0]}")
    if dev.type == "cpu":
        return _ref.sstable_search_rows_ref(fences, keys, n_blocks, n, rows,
                                            probes, block_records)
    B = probes.shape[0]
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _launch("sstable_search", "sstable_search_rows", fences.data_ptr(),
                keys.data_ptr(), n_blocks.data_ptr(), n.data_ptr(),
                rows.data_ptr(), probes.data_ptr(), idx.data_ptr(),
                found.data_ptr(), B, fences.shape[1], C, int(block_records))
    return idx, found


def bloom_probe_stack(bits, nw, probes, k_hashes: int) -> torch.Tensor:
    """The filter plane: every probe against every filter row of the
    stacked (L, W) filters -> maybe (L, B) bool; a row with nw == 0 is
    all True.  Any B is taken: the kernel masks the ragged tail."""
    L, W = bits.shape
    dev = probes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check("probes", probes, torch.int64, 1, dev)
    _check("bits", bits, torch.int64, 2, dev)
    _check("nw", nw, torch.int32, 1, dev)
    if nw.shape[0] != L:
        raise ValueError(f"nw: expected ({L},), got {tuple(nw.shape)}")
    if dev.type == "cpu":
        return _ref.bloom_probe_stack_ref(bits, nw, probes, k_hashes)
    B = probes.shape[0]
    maybe = torch.empty((L, B), dtype=torch.bool, device=dev)
    if L and B:
        _launch("bloom_probe_stack", "bloom_probe_stack", bits.data_ptr(),
                nw.data_ptr(), probes.data_ptr(), maybe.data_ptr(), L, B, W,
                int(k_hashes))
    return maybe
