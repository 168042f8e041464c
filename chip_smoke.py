#!/usr/bin/env python3
"""Drive the port's batched GET on one NVIDIA card and check every kernel.

  python3 chip_smoke.py [--keys N] [--seed S]

1. Builds the CUDA kernels of ``port/repro_torch/kernels/csrc`` with nvcc
   (sm_90a) and prints ptxas's register and spill report.
2. Drives ``repro_torch``'s in-memory ``BourbonStore`` (default LSMConfig,
   filters on, values fetched) through three phases of batched GETs, each
   answer checked against ground truth:
     A  unlearned files (engine mode ``model``: both descent arms);
     B  after ``learn_all`` (mode ``model_pure``: the learned arm only);
     C  after 1% fresh puts, 1% overwrites and 1% deletes (mode ``model``),
        with a 65536-key batch and small batches the host answers.
   Kernel launch counts are zeroed just before phase A and read just after
   phase C; each kernel of the path must have launched.
3. Holds each kernel against its plain PyTorch version on the same CUDA
   tensors at the live state's shapes (4096 probes), times both with CUDA
   events, and computes the kernel's lower bound from the bytes its probes
   must gather.

Output: one line per phase, a ``{"kernels": [...]}`` JSON line, the card's
name and power limit from nvidia-smi, and last the ``{"ok": true, ...}``
JSON line.  Exits non-zero, printing no result, when there is no CUDA
device, when the port's package is missing, or on the first wrong answer.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
NONTENSOR_OPS_PER_S = 67e12    # H100 SXM non-tensor FP32 rate (data sheet)
CHECK_B = 4096                 # probes per kernel launch in the checks
TIMED_BATCHES = 32             # distinct probe sets rotated while timing
TIMED_ROUNDS = 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------
# the main path
# ----------------------------------------------------------------------------

class Truth:
    """Ground truth of the key space: what each key must read back as."""

    def __init__(self, keys: np.ndarray, value_size: int):
        self.keys = keys                     # sorted present keys
        self.value_size = value_size
        self.ow_keys = np.zeros(0, np.int64)  # sorted overwritten keys
        self.ow_vals = np.zeros((0, value_size), np.uint8)
        self.dead = np.zeros(0, np.int64)     # sorted deleted keys

    @staticmethod
    def _isin(sorted_keys: np.ndarray, q: np.ndarray) -> np.ndarray:
        if sorted_keys.shape[0] == 0:
            return np.zeros(q.shape, bool)
        i = np.minimum(np.searchsorted(sorted_keys, q), sorted_keys.shape[0] - 1)
        return sorted_keys[i] == q

    def absent(self, rng, n: int) -> np.ndarray:
        lo, hi = int(self.keys[0]), int(self.keys[-1])
        out = np.zeros(0, np.int64)
        while out.shape[0] < n:
            c = rng.integers(lo, hi, size=2 * n, dtype=np.int64)
            out = np.concatenate([out, c[~self._isin(self.keys, c)]])
        return out[:n]

    def check(self, tag: str, probes, found, values) -> None:
        live = self._isin(self.keys, probes) & ~self._isin(self.dead, probes)
        if not np.array_equal(found, live):
            bad = np.flatnonzero(found != live)
            fail(f"{tag}: {bad.shape[0]} found flags wrong, first key "
                 f"{int(probes[bad[0]])} found={bool(found[bad[0]])}")
        want = np.zeros((probes.shape[0], self.value_size), np.uint8)
        want[:, 0] = (probes & 0xFF).astype(np.uint8)
        ow = self._isin(self.ow_keys, probes) & live
        if ow.any():
            want[ow] = self.ow_vals[np.searchsorted(self.ow_keys, probes[ow])]
        want[~live] = 0
        if not np.array_equal(values, want):
            bad = np.flatnonzero((values != want).any(axis=1))
            fail(f"{tag}: {bad.shape[0]} values wrong, first key "
                 f"{int(probes[bad[0]])}")


def run_gets(store, truth: Truth, batches: list, tag: str) -> dict:
    """GET every batch and check each against the truth.  The first batch
    after a structure change pays one-time work (level filters built on
    the host, levels and the value log copied to the card), so it is timed
    apart; ``gets_per_s`` is the host wall clock over the other batches'
    ``get_batch`` calls alone (checks excluded).  ``launches`` counts the
    kernel launches of these batches."""
    from repro_torch.kernels import ops
    launched = dict(ops.launches)
    model0, base0 = store.lookups_model_path, store.lookups_baseline_path
    hits = live = 0
    secs = []
    for bi, probes in enumerate(batches):
        t0 = time.perf_counter()
        found, values = store.get_batch(probes)
        secs.append(time.perf_counter() - t0)
        truth.check(f"{tag} batch {bi}", probes, found, values)
        hits += int(found.sum())
        live += int((Truth._isin(truth.keys, probes)
                     & ~Truth._isin(truth.dead, probes)).sum())
    n_rest = sum(p.shape[0] for p in batches[1:])
    dm = store.lookups_model_path - model0
    db = store.lookups_baseline_path - base0
    per = sorted(secs[1:])
    return {"gets": sum(p.shape[0] for p in batches), "batches": len(batches),
            "first_batch_s": secs[0], "gets_per_s": n_rest / sum(secs[1:]),
            "batch_ms_median": 1e3 * per[len(per) // 2],
            "batch_ms_max": 1e3 * per[-1],
            "hit_rate": hits / max(live, 1),
            "model_path_frac": dm / max(dm + db, 1),
            "launches": {k: v - launched[k] for k, v in ops.launches.items()}}


def host_profile(store, batches: list) -> dict:
    """Where a GET batch's host time goes: cProfile over a few batches,
    the functions with the most self time (cProfile adds its own cost per
    Python call, so read the shares, not the absolute times)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for probes in batches:
        store.get_batch(probes)
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(((tt, nc, f"{os.path.basename(fn)}:{ln}({name})")
                   for (fn, ln, name), (_, nc, tt, _, _) in st.stats.items()),
                  reverse=True)
    return {"batches": len(batches), "total_s": st.total_tt,
            "top_self": [{"fn": f, "calls": c, "s": t} for t, c, f in rows[:10]]}


def profile_gets(store, batches: list) -> dict:
    """Device time of a few GET batches under torch.profiler: total kernel
    time against the wall clock, and the kernels that took the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for probes in batches:
            store.get_batch(probes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            dev.append((us, e.count, e.key))
    dev.sort(reverse=True)
    busy = sum(us for us, _, _ in dev) / 1e6
    return {"batches": len(batches), "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": (1 - busy / wall) if busy else None,
            "top_device": [{"name": k[:60], "calls": c, "us": us}
                           for us, c, k in dev[:8]]}


def phase_line(tag: str, store, res: dict, card: str, extra: dict) -> None:
    import torch
    files = [len(lvl) for lvl in store.tree.levels]
    dev_bytes = (torch.cuda.max_memory_allocated()
                 if store.engine.device.type == "cuda" else 0)
    learned = [sum(t.model is not None for t in lvl)
               for lvl in store.tree.levels]
    rec = {"phase": tag, "mode": store._engine_mode(),
           "keys": store.tree.total_records(), "files_per_level": files,
           "learned_per_level": learned,
           "device_max_bytes": dev_bytes, **res, **extra, "card": card}
    print(json.dumps(rec))


def drive(device: str, n_keys: int, seed: int, card: str,
          batch: int = 4096, n_batches: int = 64) -> object:
    """Phases A-C of the main path on ``device``.  Returns the store, the
    kernel launch counts of phases A-C, and (level, device level, tables)
    of the widest level as phase B served it, for the kernel checks."""
    import torch
    from repro_torch.core import BourbonStore, StoreConfig, make_dataset

    store = BourbonStore(StoreConfig(mode="bourbon", policy="offline",
                                     fetch_values=True, device=device))
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    keys = make_dataset("osm", n_keys, seed=seed)
    perm = rng.permutation(keys)
    for off in range(0, n_keys, 1 << 20):
        store.put_batch(perm[off: off + (1 << 20)])
    store.flush_all()
    load_s = time.perf_counter() - t0
    del perm
    truth = Truth(keys, store.cfg.value_size)

    def batches(r, count, size):
        out = []
        for _ in range(count):
            out.append(np.concatenate([r.choice(truth.keys, size // 2),
                                       truth.absent(r, size - size // 2)]))
        return out

    from repro_torch.kernels import ops
    ab = batches(np.random.default_rng(seed + 1), n_batches, batch)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                      # the main path starts here
    res = run_gets(store, truth, ab, "A")
    phase_line("A", store, res, card, {"load_s": load_s})

    t0 = time.perf_counter()
    learned = store.learn_all()
    learn_s = time.perf_counter() - t0
    if store._engine_mode() != "model_pure":
        fail("phase B: not every file is learned")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    res = run_gets(store, truth, ab, "B")
    if device != "cpu":
        res["profile"] = profile_gets(store, ab[:8])
    res["host_profile"] = host_profile(store, ab[:8])
    phase_line("B", store, res, card, {"learned": learned, "learn_s": learn_s})
    # the kernel checks run on the widest level as phase B served it, with
    # every file learned (phase C's compactions leave files unlearned)
    state = store.engine.build_state(store.tree)
    li = max(range(1, len(state.levels)),
             key=lambda i: (state.levels[i].n_files, i))
    snapshot = (li, state.levels[li], list(store.tree.levels[li]))

    # phase C: 1% fresh keys, 1% overwrites, 1% deletes; new files unlearned
    r = np.random.default_rng(seed + 2)
    k1 = max(1, n_keys // 100)
    fresh = np.unique(truth.absent(r, k1))
    pick = r.choice(n_keys, 2 * k1, replace=False)
    ow = np.sort(keys[pick[:k1]])
    dead = np.sort(keys[pick[k1:]])
    ow_vals = r.integers(0, 256, (ow.shape[0], store.cfg.value_size),
                         dtype=np.uint8)
    t0 = time.perf_counter()
    store.put_batch(r.permutation(fresh))
    store.put_batch(ow, ow_vals)
    store.delete_batch(dead)
    store.flush_all()
    write_s = time.perf_counter() - t0
    truth.keys = np.union1d(truth.keys, fresh)
    truth.ow_keys, truth.ow_vals = ow, ow_vals
    truth.dead = dead
    if store._engine_mode() != "model":
        fail("phase C: expected unlearned files after the writes")
    cb = []
    for _ in range(n_batches // 2):
        q = batch // 4
        cb.append(np.concatenate([r.choice(truth.keys, q), r.choice(ow, q),
                                  r.choice(dead, q),
                                  truth.absent(r, batch - 3 * q)]))
    big = np.concatenate([r.choice(truth.keys, 1 << 15),
                          truth.absent(r, 1 << 15)])
    # post-screen remainders <= host_answer_max: answered on the host
    small = [np.concatenate([r.choice(truth.keys, 48), truth.absent(r, 48)])
             for _ in range(4)]
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    res = run_gets(store, truth, cb, "C")
    if device != "cpu":
        res["profile"] = profile_gets(store, cb[:8])
    res["host_profile"] = host_profile(store, cb[:8])
    # (run_gets leaves each group's first batch untimed: cb[0] re-warms)
    res["batch_65536"] = run_gets(store, truth, [cb[0], big], "C-65536")
    host0 = store.filter_host_answered
    res["host_answered"] = run_gets(store, truth, small, "C-host")
    if store.filter_host_answered == host0:
        fail("phase C: the small batches were not answered on the host")
    if any(res["host_answered"]["launches"].values()):
        fail("phase C: the host-answered batches launched kernels")
    phase_line("C", store, res, card, {"write_s": write_s})
    launches = dict(ops.launches)               # read just after phase C
    return store, launches, snapshot


# ----------------------------------------------------------------------------
# kernels against their plain versions
# ----------------------------------------------------------------------------

def _steps(n):
    """Bisect steps over a range of n entries, elementwise."""
    import torch
    return torch.ceil(torch.log2(n.to(torch.float64) + 1)).to(torch.int64)


def kernel_checks(store, launches: dict, snapshot) -> list:
    import torch
    from repro_torch.core.bloom import hash2_torch, umod_torch
    from repro_torch.core.store import _PAD_PROBE
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    cfg = store.engine.cfg
    li, lv, tables = snapshot
    dev = lv.keys.device
    level_keys = np.concatenate([t.keys for t in tables])
    lo, hi = int(level_keys[0]), int(level_keys[-1])
    sets = []
    for s in range(TIMED_BATCHES):
        r = np.random.default_rng(1000 + s)
        p = np.concatenate([r.choice(level_keys, CHECK_B // 2),
                            r.integers(lo, hi, CHECK_B // 2, dtype=np.int64)])
        p[-8:] = _PAD_PROBE                       # pad lanes, as dispatched
        pt = torch.from_numpy(p).to(dev)
        f, _ = store.engine._find_file(lv, pt)
        rows = f.to(torch.int32)
        pos = ref.plr_lookup_rows_ref(lv.starts, lv.slopes, lv.icepts,
                                      lv.nseg, lv.n, rows, pt)
        sets.append((rows, pt, pos))
    rl = [s[0].long() for s in sets]

    # per kernel and probe set: (bytes, operations) this set's data needs —
    # each probe's reads counted once (8 B per gathered element), outputs
    # written once; operations are the 64-bit compares, adds and shifts
    def w_plr(i):
        ns = lv.nseg[rl[i]].clamp(1, lv.starts.shape[1])
        st = _steps(ns)
        return (int((8 + 4 + 4 + 4 + 4 + 8 * (st + 2)).sum()),
                int((4 * st + 4).sum()))

    def w_bounded(i):
        rows, p, pos = sets[i]
        d = cfg.plr_delta
        C = lv.keys.shape[1]
        offs = torch.arange(-(d + 1), d + 2, device=dev)
        win = (pos.long()[:, None] + offs).clamp(0, C - 1)
        eq = lv.keys[rl[i][:, None], win] == p[:, None]
        read = torch.where(eq.any(1), eq.to(torch.uint8).argmax(1) + 1,
                           2 * d + 3)
        return (int((8 + 4 + 4 + 4 + 4 + 1 + 8 * read).sum()),
                int((3 * read + 2).sum()))

    def w_bloom(i):
        rows, p, _ = sets[i]
        m = lv.bloom_nw[rl[i]].long().clamp(min=1) * 64
        h1, h2 = hash2_torch(p)
        alive = torch.ones_like(p, dtype=torch.bool)
        words = torch.zeros_like(p)
        for t in range(cfg.bloom_k):
            words += alive.long()
            bit = umod_torch(h1 + t * h2, m)
            w = lv.bloom[rl[i], (bit >> 6).clamp(max=lv.bloom.shape[1] - 1)]
            alive = alive & (((w >> (bit & 63)) & 1) == 1)
        return (int((8 + 4 + 4 + 1 + 8 * words).sum()),
                int((10 + 6 * words).sum()))

    def w_sstable(i):
        rows, p, _ = sets[i]
        R = cfg.block_records
        nb = lv.n_blocks[rl[i]].clamp(1, lv.fences.shape[1])
        lo = ref._bisect_rows(lv.fences, rows, p, torch.zeros_like(rl[i]),
                              nb, "right")
        base = (lo - 1).clamp(min=0) * R
        span = (torch.minimum(base + R, lv.n[rl[i]].long()) - base).clamp(min=0)
        st = _steps(nb) + _steps(span)
        return (int((8 + 4 + 4 + 4 + 4 + 1 + 8 * (st + 1)).sum()),
                int((4 * st + 4).sum()))

    kernels = [
        ("plr_lookup", "port/repro_torch/kernels/csrc/plr_lookup.cu",
         "src/repro/kernels/plr_lookup.py:66",
         lambda i: ops.plr_lookup(lv.starts, lv.slopes, lv.icepts, lv.nseg,
                                  lv.n, sets[i][0], sets[i][1]),
         lambda i: ref.plr_lookup_rows_ref(lv.starts, lv.slopes, lv.icepts,
                                           lv.nseg, lv.n, sets[i][0],
                                           sets[i][1]),
         w_plr),
        ("bounded_search", "port/repro_torch/kernels/csrc/bounded_search.cu",
         "src/repro/kernels/bounded_search.py:61",
         lambda i: ops.bounded_search(lv.keys, lv.n, sets[i][0], sets[i][2],
                                      sets[i][1], cfg.plr_delta),
         lambda i: ref.bounded_search_rows_ref(lv.keys, lv.n, sets[i][0],
                                               sets[i][2], sets[i][1],
                                               cfg.plr_delta),
         w_bounded),
        ("bloom_probe", "port/repro_torch/kernels/csrc/bloom_probe.cu",
         "src/repro/kernels/bloom_probe.py:69",
         lambda i: ops.bloom_probe(lv.bloom, lv.bloom_nw, sets[i][0],
                                   sets[i][1], cfg.bloom_k),
         lambda i: ref.bloom_probe_rows_ref(lv.bloom, lv.bloom_nw, sets[i][0],
                                            sets[i][1], cfg.bloom_k),
         w_bloom),
        ("sstable_search", "port/repro_torch/kernels/csrc/sstable_search.cu",
         "src/repro/kernels/sstable_search.py:95",
         lambda i: ops.sstable_search(lv.fences, lv.keys, lv.n_blocks, lv.n,
                                      sets[i][0], sets[i][1],
                                      cfg.block_records),
         lambda i: ref.sstable_search_rows_ref(lv.fences, lv.keys,
                                               lv.n_blocks, lv.n, sets[i][0],
                                               sets[i][1], cfg.block_records),
         w_sstable),
    ]
    out = []
    for name, src, replaces, kern, plain, work in kernels:
        mism = 0
        err = 0.0
        for i in range(TIMED_BATCHES):
            got, want = kern(i), plain(i)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                d = (g.long() - w.long()).abs()
                mism += int((d != 0).sum())
                err = max(err, float(d.max()))
        torch.cuda.synchronize()
        ms = _time(kern)
        plain_ms = _time(plain)
        device_ms = _device_ms(kern, f"{name}_rows_kernel")
        w = [work(i) for i in range(TIMED_BATCHES)]
        bytes_per = sum(b for b, _ in w) / TIMED_BATCHES
        ops_per = sum(o for _, o in w) / TIMED_BATCHES
        bound_b = bytes_per / HBM_BYTES_PER_S * 1e3
        bound_o = ops_per / NONTENSOR_OPS_PER_S * 1e3
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": launches[name],
                    "max_abs_err": err, "mismatches": mism, "ms": ms,
                    "device_ms": device_ms,
                    "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
                    "bound_by": "bytes" if bound_b >= bound_o else "operations",
                    "library_ms": None, "bytes_per_launch": bytes_per,
                    "ops_per_launch": ops_per,
                    "level": li, "shape": {"F": lv.keys.shape[0],
                                           "C": lv.keys.shape[1],
                                           "S": lv.starts.shape[1],
                                           "W": lv.bloom.shape[1],
                                           "NB": lv.fences.shape[1],
                                           "B": CHECK_B}})
    return out


def _device_ms(fn, symbol: str) -> float | None:
    """Mean device time per launch of the kernel named ``symbol``, from
    torch.profiler over one pass of the probe sets: the kernel's own run
    time, without the host's launch path that back-to-back calls wait on."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(TIMED_BATCHES):
            fn(i)
        torch.cuda.synchronize()
    us = calls = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and symbol in e.key:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            calls += e.count
    return us / calls / 1e3 if calls else None


def _time(fn) -> float:
    """Milliseconds per call, CUDA events over rotated probe sets.  Each
    call is a Python wrapper plus a ctypes launch, so for a kernel that
    runs for a few microseconds this is the host's launch rate."""
    import torch
    for i in range(TIMED_BATCHES):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_ROUNDS):
        for i in range(TIMED_BATCHES):
            fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (TIMED_ROUNDS * TIMED_BATCHES)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1 << 23,
                    help="OSM-like keys loaded into the store (the host "
                         "LSM load of 1 << 24 does not fit the run's time)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "port"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s")
    for line in build.ptxas_log().splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "Compiling entry" in line):
            print("ptxas:", line.strip())

    store, launches, snapshot = drive("cuda", args.keys, args.seed, card)
    checks = kernel_checks(store, launches, snapshot)
    for k in checks:
        if k["launches"] <= 0:
            fail(f"{k['name']} never launched on the main path")
        if k["mismatches"] != 0:
            fail(f"{k['name']} disagrees with its plain version on "
                 f"{k['mismatches']} outputs")
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": checks}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
