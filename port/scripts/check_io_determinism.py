#!/usr/bin/env python
"""CI gate: the host I/O pool must not change a single result bit.

The threaded serving path (``io_workers > 0``) moves each batch's
resolve — device sync, overlay merge, value-log fetch — onto pool
workers, and the group-commit WAL moves fsyncs onto a committer thread.
Both are *performance* planes: worker count, scheduling, and completion
order must be invisible in every answer the server gives.  This script
runs one fixed mixed workload through ``repro_torch``'s pipelined server
with ``io_workers`` 0 (inline — the serial semantics), 1, and 4 on
identical fresh stores (group-commit WAL on, so the committer thread is
exercised too) and fails unless all three produce byte-identical
found/value arrays per request, identical epoch vectors, and
``epoch_violations == 0``.  On the card a pool worker resolves batches
whose kernels the serving thread launched.

    python port/scripts/check_io_determinism.py [--device cuda|cpu]
                                                [--keys N]

At the default 4096 keys the stores, streams, server and printed lines
are those of ``scripts/check_io_determinism.py``; above it the shards
take the default ``LSMConfig`` and the streams keep their shape.

Exit status 0 = identical; 1 = any divergence (printed per request).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

from repro_torch.core import LSMConfig, StoreConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.filters import FilterConfig  # noqa: E402
from repro_torch.distributed import ShardedConfig, ShardedStore  # noqa: E402
from repro_torch.server import (PipelineConfig, PipelinedServer,  # noqa: E402
                                ServerRequest)

N_KEYS = 1 << 12
N_SHARDS = 4
CLIENTS = 8
ROUNDS = 6
KEYS_PER_REQ = 64
POOL_SIZES = (0, 1, 4)


def _open_store(path: str, keys: np.ndarray, device: str) -> ShardedStore:
    bounds = tuple(int(b) for b in
                   np.quantile(keys, np.arange(1, N_SHARDS) / N_SHARDS))
    lsm = (LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                     l1_cap_records=1 << 13)
           if keys.shape[0] <= N_KEYS else LSMConfig())
    # filters explicitly on: the screen/host-answer paths must stay
    # deterministic under the threaded resolve too (the +1 miss keys in
    # the streams exercise them)
    cfg = StoreConfig(granularity="level", policy="always", value_size=16,
                      vlog_seg_slots=1 << 9, wal_group_commit=True,
                      filters=FilterConfig(enabled=True), lsm=lsm,
                      engine=EngineConfig(seg_cap=4096), device=device)
    st = ShardedStore.open(path, ShardedConfig(n_shards=N_SHARDS,
                                               boundaries=bounds), cfg,
                           mesh=None)
    for off in range(0, keys.shape[0], 1 << 11):
        st.put_batch(keys[off: off + (1 << 11)])
    st.flush_all()
    st.learn_all()
    return st


def _streams(keys: np.ndarray) -> list[list[tuple[str, np.ndarray]]]:
    """Fixed per-client (op, keys) streams: mostly GETs (some keys
    absent), a few PUT barriers so write drains interleave with the
    threaded resolves."""
    rng = np.random.default_rng(7)
    universe = np.concatenate([keys, keys + 1])   # +1 keys mostly miss
    streams = []
    for c in range(CLIENTS):
        reqs = []
        for r in range(ROUNDS):
            if c == 0 and r % 3 == 2:
                reqs.append(("put",
                             rng.choice(keys, KEYS_PER_REQ)
                             .astype(np.int64)))
            else:
                reqs.append(("get",
                             rng.choice(universe, KEYS_PER_REQ)
                             .astype(np.int64)))
        streams.append(reqs)
    return streams


def _run(io_workers: int, keys: np.ndarray, streams, device: str,
         watch=None) -> tuple[list, int, dict]:
    """One arm on a fresh durable store: every request's (rid, found,
    result, epochs_served), the server's epoch violations, and the
    seconds of its load and serving.  ``watch(tag, store)``, when given,
    is a context manager held around the serving."""
    d = tempfile.mkdtemp(prefix=f"bourbon_iodet_w{io_workers}_")
    try:
        t0 = time.perf_counter()
        st = _open_store(os.path.join(d, "db"), keys, device)
        t1 = time.perf_counter()
        srv = PipelinedServer(st, PipelineConfig(
            max_batch_keys=256, max_wait_ticks=0, queue_capacity=64,
            max_batches_per_tick=4, max_inflight=4, carry=1,
            io_workers=io_workers))
        reqs = []
        rid = 0
        nxt = [0] * CLIENTS
        pend: list[ServerRequest | None] = [None] * CLIENTS
        served = 0
        total = CLIENTS * ROUNDS
        try:
            with (watch(f"io_workers={io_workers}", st) if watch
                  else contextlib.nullcontext()):
                while served < total:
                    for c in range(CLIENTS):
                        if pend[c] is not None or nxt[c] >= ROUNDS:
                            continue
                        op, ks = streams[c][nxt[c]]
                        r = ServerRequest(rid, op, ks)
                        if srv.submit(r):
                            rid += 1
                            pend[c] = r
                            nxt[c] += 1
                            reqs.append(r)
                    srv.tick()
                    for c in range(CLIENTS):
                        if pend[c] is not None and pend[c].done:
                            pend[c] = None
                            served += 1
            violations = srv.stats()["pipeline"]["epoch_violations"]
        finally:
            srv.shutdown()
            st.close()
        secs = {"load": t1 - t0, "serve": time.perf_counter() - t1}
        out = []
        for r in reqs:
            if r.op == "get":
                out.append((r.rid,
                            np.asarray(r.found).tobytes(),
                            np.asarray(r.result).tobytes(),
                            tuple(r.epochs_served or ())))
            else:
                out.append((r.rid, b"put", b"", ()))
        return out, violations, secs
    finally:
        shutil.rmtree(d, ignore_errors=True)


def gate(device: str = "cuda", n_keys: int = N_KEYS,
         watch=None) -> tuple[int, dict]:
    """Run the gate; returns its exit status and its readings (requests,
    GETs and keys a pool size, the epoch violations and seconds of each,
    and each pool size's request records)."""
    rng = np.random.default_rng(3)
    keys = rng.permutation(np.arange(1, n_keys + 1, dtype=np.int64) * 5)
    streams = _streams(keys)
    rec: dict = {"keys": n_keys, "device": device,
                 "requests": CLIENTS * ROUNDS,
                 "gets": sum(op == "get" for s in streams for op, _ in s),
                 "probes": sum(ks.shape[0] for s in streams
                               for op, ks in s if op == "get"),
                 "epoch_violations": {}, "seconds": {}, "answers": {}}
    results = {}
    for w in POOL_SIZES:
        results[w], violations, secs = _run(w, keys, streams, device, watch)
        rec["epoch_violations"][w] = violations
        rec["seconds"][w] = secs
        rec["answers"][w] = results[w]
        if violations != 0:
            print(f"FAIL: io_workers={w} epoch_violations={violations}")
            return 1, rec
        print(f"io_workers={w}: {len(results[w])} requests served, "
              f"epoch_violations=0")
    ref = results[POOL_SIZES[0]]
    ok = True
    for w in POOL_SIZES[1:]:
        for (rid, f0, v0, e0), (rid2, f1, v1, e1) in zip(ref, results[w]):
            if (rid, f0, v0, e0) != (rid2, f1, v1, e1):
                print(f"FAIL: io_workers={w} diverges from inline at "
                      f"request {rid}")
                ok = False
                break
    if not ok:
        return 1, rec
    print(f"OK: io_workers {POOL_SIZES} byte-identical across "
          f"{len(ref)} requests")
    return 0, rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the stores' device (default: the card)")
    ap.add_argument("--keys", type=int, default=N_KEYS,
                    help="keys loaded into each store (default 4096)")
    args = ap.parse_args(argv)
    return gate(args.device, args.keys)[0]


if __name__ == "__main__":
    sys.exit(main())
