"""Elastic re-meshing + straggler mitigation (design + runnable simulation;
the port of ``repro.launch.elastic``, pure Python, a copy).

At 1000+ nodes the failure domain is the host.  The design:

  1. Checkpoints are mesh-shape-agnostic (logical shards, checkpoint/ckpt.py)
     — restoring onto a different mesh is just a different placement.
  2. On host failure the controller rebuilds the mesh with the `data` axis
     shrunk to the largest feasible size (model axis is kept — TP groups are
     intra-host domains), then resumes from the last committed step.
  3. Data assignment is a pure function of (step, host, n_hosts)
     (data/pipeline.py), so re-meshing needs no loader state: survivors
     recompute the failed hosts' shards.
  4. Stragglers: because any host can compute any shard, the controller can
     reassign the slowest host's shard to an idle "hot spare" at a step
     boundary (work-stealing); gradient math is unchanged since assignments
     are deterministic per step.

``shrink_plan`` and ``ElasticController`` implement 2-3 as a runnable
simulation driven by the tests; on real hardware the same logic runs in the
job controller with device health from the fleet scheduler.
"""

from __future__ import annotations

import dataclasses

__all__ = ["shrink_plan", "HostState", "ElasticController"]


def shrink_plan(n_data: int, n_failed: int) -> int:
    """Largest data-parallel width <= n_data - n_failed that divides the
    global batch cleanly (powers of two here)."""
    target = n_data - n_failed
    width = 1
    while width * 2 <= target:
        width *= 2
    return width


@dataclasses.dataclass
class HostState:
    alive: bool = True
    slow: bool = False


class ElasticController:
    """Step-boundary membership + work assignment (simulation)."""

    def __init__(self, n_hosts: int) -> None:
        self.hosts = [HostState() for _ in range(n_hosts)]
        self.events: list = []

    @property
    def alive(self) -> list[int]:
        return [i for i, h in enumerate(self.hosts) if h.alive]

    def fail(self, host: int, step: int) -> None:
        self.hosts[host].alive = False
        self.events.append(("fail", host, step))

    def mark_slow(self, host: int, step: int) -> None:
        self.hosts[host].slow = True
        self.events.append(("slow", host, step))

    def assignment(self, step: int) -> dict[int, list[int]]:
        """shard index -> host, rerouting shards of dead/slow hosts to the
        healthy ones round-robin (work stealing)."""
        healthy = [i for i, h in enumerate(self.hosts)
                   if h.alive and not h.slow]
        if not healthy:
            healthy = self.alive
        n_shards = shrink_plan(len(self.hosts),
                               len(self.hosts) - len(self.alive))
        out: dict[int, list[int]] = {h: [] for h in healthy}
        for s in range(n_shards):
            out[healthy[s % len(healthy)]].append(s)
        return out
