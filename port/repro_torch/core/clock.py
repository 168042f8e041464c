"""Virtual clock for the discrete-event side of the store.

A copy of ``repro.core.clock``: wall-clock lifetimes from the paper (T_wait =
50 ms, sstable lifetimes in minutes) are reproduced on a *virtual* microsecond
clock: every operation advances time by a cost drawn from a calibrated
:class:`CostModel`.  The port charges exactly what the JAX package charges,
so the two stores' clocks and CBA decisions can be compared bit for bit.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CostModel", "VirtualClock"]


@dataclasses.dataclass
class CostModel:
    """Per-operation virtual costs in microseconds.

    Defaults are calibrated per-key numbers from the CPU engine microbench
    (benchmarks/bench_paths.py) scaled to the paper's regime; they are
    config-injectable so tests are deterministic.

    t_*: internal-lookup service times (paper §4.4.2 notation).
      n = negative, p = positive; b = baseline path, m = model path.
    """

    t_nb: float = 1.6      # negative internal lookup, baseline
    t_pb: float = 3.2      # positive internal lookup, baseline
    t_nm: float = 0.8      # negative internal lookup, model
    t_pm: float = 1.6      # positive internal lookup, model
    t_put: float = 1.0     # per-record insert cost
    learn_per_key: float = 0.23   # Greedy-PLR per key (us): 40ms per ~175k-record file (paper §4.4.1)
    compact_per_key: float = 0.15  # merge cost per key (us)
    # value-log GC terms (§4.4 framing applied to maintenance):
    # collecting a segment costs a liveness probe per entry plus a
    # relocation (append + LSM re-insert) per *live* entry; the benefit of
    # reclaiming a dead byte is the avoided read/space amplification,
    # calibrated against the same virtual regime as the lookup terms.
    gc_scan_per_entry: float = 0.4    # liveness check per sealed entry (us)
    gc_move_per_entry: float = 2.0    # relocate one live entry (us)
    gc_benefit_per_dead_byte: float = 0.1   # avoided amplification (us/B)
    checkpoint_per_byte: float = 0.001  # MANIFEST rewrite cost (us/B)
    # filter-plane terms: building hashes each key k times (cheaper than a
    # PLR fit), and every held filter bit charges an amortized memory rent
    # — the terms the CBA sizing trades against false-positive probe cost
    filter_build_per_key: float = 0.05   # bloom build per key (us)
    filter_mem_per_bit: float = 0.0002   # amortized rent per filter bit (us)

    def t_build(self, n_keys: int) -> float:
        return self.learn_per_key * n_keys

    def t_filter_build(self, n_keys: int) -> float:
        """Virtual cost of building one level filter."""
        return self.filter_build_per_key * n_keys

    def t_gc(self, n_entries: int, n_live: int) -> float:
        """Virtual cost of collecting one segment (scan + relocation)."""
        return (self.gc_scan_per_entry * n_entries
                + self.gc_move_per_entry * n_live)

    def b_gc(self, dead_bytes: int) -> float:
        """Virtual benefit of reclaiming ``dead_bytes`` from the log."""
        return self.gc_benefit_per_dead_byte * dead_bytes


class VirtualClock:
    def __init__(self) -> None:
        self.now = 0.0

    def advance(self, us: float) -> float:
        self.now += us
        return self.now
